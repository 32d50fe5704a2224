"""compress(): host RLE1/split -> batched device encode -> stitch, and
compress_device_intake(): the same with the intake on the device too.

Port of bz2tpu/runtime/compressor.py. The host splitting (the port's
native C splitter, or its NumPy copy), the bit-level stitch and the stream
CRC run on the host; each batch of at most ``parallel`` blocks goes through
ops/pipeline.encode_batch on the device, and its packed words come back in
one device-to-host copy. Batches are not padded to a fixed size and there
is no dispatch-ahead: eager torch has no per-shape compile to amortise.
"""

from __future__ import annotations

import numpy as np
import torch

from bz2tpu_torch import native
from bz2tpu_torch.format import constants as C
from bz2tpu_torch.format.bitio import BitWriter, concat_bitstreams
from bz2tpu_torch.format.crc32 import stream_crc
from bz2tpu_torch.native import HAVE_NATIVE  # noqa: F401 - whether split_blocks runs in C
from bz2tpu_torch.oracle.encoder import Rle1Block, rle1_split
from bz2tpu_torch.ops.intake import chunk_capacity, device_intake
from bz2tpu_torch.ops.pipeline import encode_batch
from bz2tpu_torch.utils.device import resolve_device

DEFAULT_BATCH = 8

Part = tuple[np.ndarray, int]  # (bytes, valid bits) of one piece of the stream


def split_blocks(data: bytes | np.ndarray, level: int) -> list[Rle1Block]:
    """RLE1 + CRC block intake: native C single pass when built, NumPy
    otherwise (bz2tpu.runtime.compressor.split_blocks)."""
    if native.HAVE_NATIVE:
        arr = data if isinstance(data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(data, np.uint8)
        return [
            Rle1Block(np.frombuffer(b, np.uint8), raw, crc)
            for b, raw, crc in native.rle1_split(arr, level)
        ]
    arr = np.frombuffer(bytes(data), np.uint8) if not isinstance(data, np.ndarray) else data
    return rle1_split(arr, level)


def _as_array(data: bytes | np.ndarray) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _check_level(level: int) -> None:
    if not C.MIN_LEVEL <= level <= C.MAX_LEVEL:
        raise ValueError(f"block size level must be 1..9, got {level}")


def _bits(w: BitWriter) -> Part:
    return np.frombuffer(w.getvalue(), dtype=np.uint8), w.bit_length


def _stream_header(level: int) -> Part:
    head = BitWriter()
    head.write_bits(24, int.from_bytes(C.STREAM_MAGIC, "big"))
    head.write_bits(8, ord("0") + level)
    return _bits(head)


def _encode(blocks, ns, crcs, timings: dict | None = None) -> Part:
    """One batch through the device pipeline, back in one copy."""
    words, total_bits = encode_batch(blocks, ns, crcs, timings=timings)
    total = int(total_bits)
    nw = (total + 31) // 32
    return words[:nw].cpu().numpy().astype(">u4").view(np.uint8), total


def _finish(parts: list[Part], block_crcs: list[int]) -> bytes:
    """Append the end marker and stream CRC, and stitch."""
    tail = BitWriter()
    tail.write_bits(48, C.STREAM_END_MARKER)
    tail.write_bits(32, stream_crc(block_crcs))
    packed, _ = concat_bitstreams([*parts, _bits(tail)])
    return packed.tobytes()


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
    arr = _as_array(data)
    _check_level(level)
    blocks = split_blocks(arr, level)
    batch = parallel or DEFAULT_BATCH
    parts = [_stream_header(level)]
    for base in range(0, len(blocks), batch):
        parts.append(_encode(*_batch_tensors(blocks[base : base + batch], dev), timings=timings))
    return _finish(parts, [b.crc for b in blocks])


def compress_device_intake(
    data: bytes | np.ndarray,
    level: int = C.DEFAULT_LEVEL,
    parallel: int | None = None,
    device: str | torch.device | None = None,
) -> bytes:
    """Compress with the fully-device pipeline: RLE1, block splitting and
    the block CRCs run on the device too (ops/intake.py), so the host only
    uploads raw chunks and stitches finished batches.

    Port of bz2tpu.runtime.compressor.compress_device_intake, byte for
    byte: the same chunk windows, window escalation and partial-block
    holdback. Each chunk's first ``nb`` blocks encode as one batch.
    """
    dev = resolve_device(device)
    arr = _as_array(data)
    _check_level(level)
    batch = parallel or DEFAULT_BATCH
    chunk_n = chunk_capacity(level, batch)
    full = C.block_capacity(level)

    parts = [_stream_header(level)]
    crc_list: list[int] = []
    offset = 0
    # Highly compressible input can RLE1 a whole chunk into one under-full
    # block; rather than emit undersized blocks, the window widens (up to
    # 8x) until the block fills.
    cur_chunk_n = chunk_n
    max_chunk_n = chunk_n * 8
    while offset < arr.size:
        take = min(cur_chunk_n, arr.size - offset)
        padded = np.zeros(cur_chunk_n, np.uint8)
        padded[:take] = arr[offset : offset + take]
        res = device_intake(torch.from_numpy(padded).to(dev), take, level=level, max_blocks=batch)
        # One copy of the small results: n_blocks, ns, raw lengths, CRCs.
        meta = torch.cat([res["n_blocks"][None], res["ns"], res["raw_lens"], res["crcs"]]).cpu().numpy()
        nb = int(meta[0])
        ns_host, raw_lens, crcs_host = meta[1:].reshape(3, batch)
        more = offset + take < arr.size
        under_full = ns_host[nb - 1] < full
        if more and nb == 1 and under_full and cur_chunk_n < max_chunk_n:
            cur_chunk_n *= 2
            continue
        if more and nb > 1 and under_full:
            nb -= 1  # hold back the partial trailing block for the next chunk
        width = int(ns_host[:nb].max())
        parts.append(_encode(res["blocks"][:nb, :width].contiguous(), res["ns"][:nb], res["crcs"][:nb]))
        crc_list.extend(int(c) for c in crcs_host[:nb])
        offset += int(raw_lens[:nb].sum())
        if cur_chunk_n > chunk_n and nb == batch:
            # A full batch from a widened window: the data stopped being
            # ultra-compressible, so drop back to the base window.
            cur_chunk_n = chunk_n
    return _finish(parts, crc_list)
