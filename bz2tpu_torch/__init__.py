"""bz2tpu_torch: the bz2tpu bzip2 codec on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package ``bz2tpu`` beside it, which stays the reference:
each function produces the same bytes as its ``bz2tpu`` namesake. The host
layers that use no JAX (format, oracle, native C splitter and decoder,
host decompressor) are imported from ``bz2tpu``, not copied. Kernels are
CUDA C++ for sm_90a under ``csrc/``, built at first use (see _build.py).

    bz2tpu_torch.compress(data, level=9)                -> bytes  (device pipeline)
    bz2tpu_torch.compress_device_intake(data, level=9)  -> bytes  (intake on the device too)
    bz2tpu_torch.decompress(stream)                     -> bytes  (shared host decoder)
    bz2tpu_torch.decompress_device(stream)              -> bytes  (decode on the device)

Layers:
  ops/      -- per-stage torch ops; *_cuda.py wrap the kernels
  runtime/  -- the compress and decompress drivers around them
  utils/    -- device selection and banner
"""

from bz2tpu.runtime.decompressor import decompress  # noqa: F401
from bz2tpu_torch.runtime.compressor import compress, compress_device_intake  # noqa: F401
from bz2tpu_torch.runtime.device_decode import decompress_device  # noqa: F401

__version__ = "0.1.0"
