"""bz2tpu_torch: the bz2tpu bzip2 codec on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package ``bz2tpu`` beside it, which stays the reference:
each function produces the same bytes as its ``bz2tpu`` namesake. The
port is self-contained: it imports nothing of ``bz2tpu`` and keeps its own
copies of the host layers it needs (format, oracle, the native C splitter
and decoder, the host decompressor, the stream and file layer). Kernels
are CUDA C++ for sm_90a under ``csrc/``, built with nvcc at first use (see
_build.py); the host C library builds with cc into ``build/bz2tpu_torch/``
at first import (native/).

    bz2tpu_torch.compress(data, level=9)                -> bytes  (device pipeline)
    bz2tpu_torch.compress_device_intake(data, level=9)  -> bytes  (intake on the device too)
    bz2tpu_torch.decompress(stream)                     -> bytes  (host C decoder)
    bz2tpu_torch.decompress_device(stream)              -> bytes  (decode on the device)
    bz2tpu_torch.StreamCompressor                       push-style, checkpoint/resume
    bz2tpu_torch.StreamDecompressor                     push-style incremental decode
    bz2tpu_torch.open / bz2tpu_torch.BZ2File            stdlib-bz2-parity file objects

Every entry point that runs on the device takes ``device=None``, which
means CUDA and raises where there is none; ``device="cpu"`` runs the plain
torch path. The decoders other than ``decompress_device`` are host code.

Layers:
  format/   -- bit I/O, CRC32, constants (NumPy)
  native/   -- the host C core, oracle/ -- the NumPy codec and fallbacks
  ops/      -- per-stage torch ops; *_cuda.py wrap the kernels
  runtime/  -- compress and decompress drivers (compressor, device_decode,
               decompressor), streams with checkpoint/resume (stream),
               file objects (fileobj)
  utils/    -- device selection and banner, metrics, tracing, atomic
               output, the benchmark corpus
  cli.py    -- the command line (python -m bz2tpu_torch, bz2tpu-torch)
"""

from bz2tpu_torch.runtime.compressor import compress, compress_device_intake  # noqa: F401
from bz2tpu_torch.runtime.decompressor import StreamDecompressor, decompress  # noqa: F401
from bz2tpu_torch.runtime.device_decode import decompress_device  # noqa: F401
from bz2tpu_torch.runtime.fileobj import BZ2File  # noqa: F401
from bz2tpu_torch.runtime.fileobj import bz2_open as open  # noqa: F401, A001
from bz2tpu_torch.runtime.stream import StreamCompressor  # noqa: F401

__version__ = "0.1.0"
