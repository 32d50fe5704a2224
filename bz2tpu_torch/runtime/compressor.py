"""compress(): host RLE1/split -> batched device encode -> stitch.

Port of bz2tpu/runtime/compressor.py:compress. The host splitting, the
bit-level stitch and the stream CRC are the JAX package's own, imported
(they use no JAX); each batch of at most ``parallel`` blocks goes through
ops/pipeline.encode_batch on the device, and its packed words come back in
one device-to-host copy. Batches are not padded to a fixed size and there
is no dispatch-ahead: eager torch has no per-shape compile to amortise.
"""

from __future__ import annotations

import numpy as np
import torch

from bz2tpu.format import constants as C
from bz2tpu.format.bitio import BitWriter, concat_bitstreams
from bz2tpu.format.crc32 import stream_crc
from bz2tpu.native import HAVE_NATIVE  # noqa: F401 - whether split_blocks runs in C
from bz2tpu.runtime.compressor import split_blocks
from bz2tpu_torch.ops.pipeline import encode_batch
from bz2tpu_torch.utils.device import resolve_device

DEFAULT_BATCH = 8


def _batch_tensors(chunk, device):
    """(B, max n) uint8 blocks, (B,) int32 ns and (B,) int64 CRCs on device."""
    width = max(blk.data.size for blk in chunk)
    buf = np.zeros((len(chunk), width), dtype=np.uint8)
    for i, blk in enumerate(chunk):
        buf[i, : blk.data.size] = blk.data
    ns = np.array([blk.data.size for blk in chunk], dtype=np.int32)
    crcs = np.array([blk.crc for blk in chunk], dtype=np.int64)
    return tuple(torch.from_numpy(a).to(device) for a in (buf, ns, crcs))


def compress(
    data: bytes | np.ndarray,
    level: int = C.DEFAULT_LEVEL,
    parallel: int | None = None,
    device: str | torch.device | None = None,
    timings: dict | None = None,
) -> bytes:
    """Compress ``data`` into a standard .bz2 stream.

    ``device`` defaults to CUDA and raises where there is none; pass
    ``device="cpu"`` for the plain torch path. ``timings``, when given,
    collects per-stage seconds (see ops/pipeline.encode_batch).
    """
    dev = resolve_device(device)
    arr = (
        np.frombuffer(bytes(data), dtype=np.uint8)
        if not isinstance(data, np.ndarray)
        else np.ascontiguousarray(data, dtype=np.uint8)
    )
    if not C.MIN_LEVEL <= level <= C.MAX_LEVEL:
        raise ValueError(f"block size level must be 1..9, got {level}")
    blocks = split_blocks(arr, level)
    batch = parallel or DEFAULT_BATCH

    parts: list[tuple[np.ndarray, int]] = []
    head = BitWriter()
    head.write_bits(24, int.from_bytes(C.STREAM_MAGIC, "big"))
    head.write_bits(8, ord("0") + level)
    parts.append((np.frombuffer(head.getvalue(), dtype=np.uint8), head.bit_length))

    for base in range(0, len(blocks), batch):
        words, total_bits = encode_batch(
            *_batch_tensors(blocks[base : base + batch], dev), timings=timings
        )
        total = int(total_bits)
        nw = (total + 31) // 32
        row = words[:nw].cpu().numpy().astype(">u4").view(np.uint8)
        parts.append((row, total))

    tail = BitWriter()
    tail.write_bits(48, C.STREAM_END_MARKER)
    tail.write_bits(32, stream_crc([b.crc for b in blocks]))
    parts.append((np.frombuffer(tail.getvalue(), dtype=np.uint8), tail.bit_length))
    packed, _ = concat_bitstreams(parts)
    return packed.tobytes()
