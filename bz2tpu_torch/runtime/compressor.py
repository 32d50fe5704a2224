"""compress(): host RLE1/split -> batched device encode -> stitch, and
compress_device_intake(): the same with the intake on the device too.

Port of bz2tpu/runtime/compressor.py. The host splitting (the port's
native C splitter, or its NumPy copy), the bit-level stitch and the stream
CRC run on the host; each batch of at most ``parallel`` blocks goes through
ops/pipeline.encode_batch on the device, and its packed words come back in
one device-to-host copy. Batches are not padded to a fixed size and there
is no dispatch-ahead: eager torch has no per-shape compile to amortise.
compress splits a batch at a time (_split_ahead): where the input spans
more than one batch, a worker thread splits batch i + 1 while the calling
thread encodes batch i. encode_parts is the one loop over a stream's
batches, which compress and runtime/stream.py share. With
``BZ2TPU_DEVICE_STITCH=0`` each block comes back on its own
(_encode_batches, the path that drives the block mesh in a multi-process
job) and the host stitches them, as in bz2tpu.
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from bz2tpu_torch import native
from bz2tpu_torch.format import constants as C
from bz2tpu_torch.format.bitio import BitWriter, concat_bitstreams
from bz2tpu_torch.format.crc32 import stream_crc
from bz2tpu_torch.native import HAVE_NATIVE  # noqa: F401 - whether split_blocks runs in C
from bz2tpu_torch.oracle.encoder import Rle1Block, rle1_split
from bz2tpu_torch.ops.intake import chunk_capacity, device_intake
from bz2tpu_torch.ops.pipeline import encode_batch
from bz2tpu_torch.utils.device import resolve_device
from bz2tpu_torch.utils.profiling import StageClock, count, lap, span, wait

DEFAULT_BATCH = 8

# Default on: each batch's blocks concatenate on the device and come back as
# one bitstream. BZ2TPU_DEVICE_STITCH=0 takes the per-block path
# (_encode_batches), the only one that drives the block mesh. Only
# encode_parts reads it. The name and its meaning are bz2tpu's, so one
# switch sets both packages.
_DEVICE_STITCH = os.environ.get("BZ2TPU_DEVICE_STITCH", "1") == "1"

META = ("orig_ptr", "n_sym", "n_in_use", "n_groups", "n_selectors", "total_bits")

Part = tuple[np.ndarray, int]  # (bytes, valid bits) of one piece of the stream


@dataclass(frozen=True)
class BlockRange:
    """The blocks of ``arr`` from raw offset ``start``, which must be a
    block boundary of a split from 0, and at most ``max_blocks`` of them
    (0: to the end): split_blocks gives the blocks a split of the whole
    ``arr`` gives there."""

    arr: np.ndarray
    start: int = 0
    max_blocks: int = 0


# A block holds at most 51 raw bytes an RLE1 byte (a run of 255 becomes
# 5 bytes), and at most capacity + 4 RLE1 bytes.
_RAW_PER_RLE1 = 51


def split_blocks(data: bytes | np.ndarray | BlockRange, level: int) -> list[Rle1Block]:
    """RLE1 + CRC block intake: native C single pass when built, NumPy
    otherwise (bz2tpu.runtime.compressor.split_blocks). ``data`` is the
    whole input, or a BlockRange of it."""
    r = data if isinstance(data, BlockRange) else BlockRange(data)
    if native.HAVE_NATIVE:
        arr = r.arr if isinstance(r.arr, (bytes, bytearray, memoryview)) else np.ascontiguousarray(r.arr, np.uint8)
        return [
            Rle1Block(np.frombuffer(b, np.uint8), raw, crc)
            for b, raw, crc in native.rle1_split(arr, level, r.start, r.max_blocks)
        ]
    arr = np.frombuffer(bytes(r.arr), np.uint8) if not isinstance(r.arr, np.ndarray) else r.arr
    # The oracle splits all it is given: give it no more than max_blocks
    # blocks can hold, so that a batch costs a batch's bytes.
    stop = r.start + r.max_blocks * _RAW_PER_RLE1 * (C.block_capacity(level) + 4) if r.max_blocks else None
    return rle1_split(arr[r.start : stop], level)[: r.max_blocks or None]


def _split_batch(arr: np.ndarray, level: int, start: int, size: int) -> list[Rle1Block]:
    """The next batch of at most ``size`` blocks from raw offset ``start``,
    through split_blocks as the module holds it when called."""
    with span("bz2.split"):
        return split_blocks(BlockRange(arr, start, size), level)


def _split_ahead(arr: np.ndarray, level: int, size: int, crcs: list[int]):
    """Yield ``arr``'s blocks in batches of ``size``, in stream order, and
    append each batch's CRCs to ``crcs`` as it passes.

    The first batch is split on the calling thread. Where more input
    follows, one worker thread splits the next batch as each is handed
    out, so batch i + 1 is split while the caller encodes batch i; the
    calling thread counts ``split_ahead`` where that split had finished
    when it was asked for, else ``split_waits``. A split's error is raised
    here. Closing the generator cancels or waits for the split in flight
    and joins the worker."""
    pool = None
    try:
        blocks, start = _split_batch(arr, level, 0, size), 0
        while blocks:
            crcs.extend(b.crc for b in blocks)
            start += sum(b.raw_length for b in blocks)
            ahead = None
            if start < arr.size:
                pool = pool or ThreadPoolExecutor(max_workers=1, thread_name_prefix="bz2-split")
                ahead = pool.submit(_split_batch, arr, level, start, size)
            yield blocks
            if ahead is None:
                return
            count("split_ahead" if ahead.done() else "split_waits")
            blocks = ahead.result()
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)


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
    count("batches")
    words, total_bits = encode_batch(blocks, ns, crcs, timings=timings)
    with wait():
        total = int(total_bits)
    nw = (total + 31) // 32
    with span("bz2.fetch"):
        return words[:nw].cpu().numpy().astype(">u4").view(np.uint8), total


def _trailer(s_crc: int) -> Part:
    """The end marker and the stream CRC ``s_crc``."""
    tail = BitWriter()
    tail.write_bits(48, C.STREAM_END_MARKER)
    tail.write_bits(32, s_crc)
    return _bits(tail)


def _finish(parts: list[Part], block_crcs: list[int]) -> bytes:
    """Append the end marker and stream CRC, and stitch."""
    with span("bz2.stitch"):
        packed, _ = concat_bitstreams([*parts, _trailer(stream_crc(block_crcs))])
        return packed.tobytes()


def _batch_tensors(chunk, device, n_rows: int | None = None):
    """(B, max n) uint8 blocks, (B,) int32 ns and (B,) int64 CRCs on device.
    B is ``n_rows`` where given: rows past the chunk are padding, one zero
    byte each (ns = 1, CRC 0)."""
    with span("bz2.upload"):
        n_rows = n_rows or len(chunk)
        width = max(blk.data.size for blk in chunk)
        buf = np.zeros((n_rows, width), dtype=np.uint8)
        ns = np.ones(n_rows, dtype=np.int32)
        crcs = np.zeros(n_rows, dtype=np.int64)
        for i, blk in enumerate(chunk):
            buf[i, : blk.data.size] = blk.data
            ns[i], crcs[i] = blk.data.size, blk.crc
        return tuple(torch.from_numpy(a).to(device) for a in (buf, ns, crcs))


def _mesh_batch(n_blocks: int, parallel: int | None) -> int:
    """bz2tpu's batch for a stream of ``n_blocks``: ``parallel`` or
    DEFAULT_BATCH, and for a shorter stream the next power of two at or
    above ``n_blocks``, capped at ``parallel``. The port neither pads nor
    quantises its batches (there is no compile to amortise), so this only
    decides, as in bz2tpu, whether the mesh divides the batch."""
    batch = parallel or DEFAULT_BATCH
    if n_blocks < batch:
        b = 1
        while b < max(n_blocks, 1):
            b <<= 1
        batch = min(b, parallel) if parallel else b
    return batch


def _encode_batches(batches, batch: int, device, timings: dict | None = None):
    """Encode ``batches`` (each a list of at most ``batch`` blocks, bz2tpu's
    batch for the stream); yield one row a block, in stream order, with
    bz2tpu's keys: orig_ptr, n_sym, n_in_use, n_groups, n_selectors and
    total_bits (ints), and words (uint32: the block's complete bitstream,
    header included, in ceil(total_bits / 32) words).

    Port of bz2tpu.runtime.compressor._encode_batches. Each batch goes
    through a block mesh: the default process group's where it has S > 1
    ranks and S divides ``batch``, else one rank with no group. Padded to a
    multiple of S with one-byte rows, each rank encodes its rows on its own
    device (a "cuda" device with no index means the rank's card,
    parallel/mesh.block_mesh) and gather_blocks brings every rank's rows to
    every rank. Every rank must pass the same
    blocks and batch, and gets the same rows. Each batch's words come back
    in one copy, each row cut to its own bits and the rows packed end to
    end as int32 bit patterns, so that the all-gather and the copy carry the
    compressed bytes and not the rows' zero padding; the scalars in one
    copy more. ``timings`` as in ops/pipeline.encode_blocks, plus "gather"
    (the all-gather, on a group's mesh) and "fetch" (the cut and the copies).
    """
    from bz2tpu_torch.parallel.mesh import BlockMesh, block_mesh, encode_blocks_sharded, gather_blocks, pad_batch
    from bz2tpu_torch.parallel.stitch import as_int32

    dev = resolve_device(device)
    n_dev = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_dev > 1 and batch % n_dev == 0:
        mesh = block_mesh(device=None if dev.type == "cuda" and dev.index is None else dev)
    else:
        mesh = BlockMesh(None, 0, 1, dev)
    dev = mesh.device
    # A group's ranks each hold the whole batch on the host and move only
    # their rows to the card; one rank uploads it under bz2.upload.
    host = dev if mesh.group is None else "cpu"
    for chunk in batches:
        count("batches")
        n_rows = pad_batch(len(chunk), mesh.size)
        out = encode_blocks_sharded(*_batch_tensors(chunk, host, n_rows), mesh=mesh, timings=timings)
        rows = mesh.rows(n_rows)
        live = max(0, min(rows.stop - rows.start, len(chunk) - rows.start))
        clock = None if timings is None else StageClock(timings, dev)
        words = out["words"]
        n_words = (out["meta"][:, 5].to(torch.int64) + 31) >> 5
        keep = torch.arange(words.shape[1], device=dev) < n_words[:, None]
        keep[live:] = False  # padding rows carry no words
        shard = gather_blocks({"meta": out["meta"], "words": as_int32(words[keep])}, mesh)
        if mesh.group is not None:
            lap(clock, "gather")
        meta = shard["meta"].cpu().numpy()
        flat = shard["words"].cpu().numpy().view(np.uint32)
        lap(clock, "fetch")
        ends = np.cumsum((meta[: len(chunk), 5].astype(np.int64) + 31) >> 5)
        for i, row_words in enumerate(np.split(flat, ends[:-1])):
            row = {k: int(meta[i, j]) for j, k in enumerate(META)}
            row["words"] = row_words
            yield row


def batched(blocks: list[Rle1Block], batch: int) -> list[list[Rle1Block]]:
    """``blocks`` cut into batches of ``batch``, the last one short."""
    return [blocks[base : base + batch] for base in range(0, len(blocks), batch)]


def encode_parts(batches, batch: int, device, timings: dict | None = None):
    """The stream's Parts for ``batches`` (an iterable of lists of at most
    ``batch`` blocks, in stream order; each is encoded as it is taken) on
    ``device``: one Part a batch (_encode, the batch concatenated on the
    device), or with ``_DEVICE_STITCH`` off one a block (_encode_batches,
    whose mesh ``batch`` decides). ``timings`` as there."""
    if not _DEVICE_STITCH:
        for row in _encode_batches(batches, batch, device, timings):
            yield row["words"].astype(">u4").view(np.uint8), row["total_bits"]
        return
    for chunk in batches:
        yield _encode(*_batch_tensors(chunk, device), timings=timings)


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
    collects per-stage seconds (see ops/pipeline.encode_batch). With
    ``_DEVICE_STITCH`` off (``BZ2TPU_DEVICE_STITCH=0``) the blocks come
    back one by one (_encode_batches), through the block mesh where a
    process group's ranks divide bz2tpu's batch: every rank then calls
    this with the same arguments and returns the same stream.
    """
    dev = resolve_device(device)
    arr = _as_array(data)
    _check_level(level)
    crcs: list[int] = []
    batches = _split_ahead(arr, level, parallel or DEFAULT_BATCH, crcs)
    try:
        first = next(batches, None)
        # bz2tpu's batch for the stream: a first batch that is not full is
        # the whole stream, and a full one says the stream has at least as
        # many blocks, which is all _mesh_batch reads.
        batch = _mesh_batch(len(first or ()), parallel)
        parts = encode_parts(itertools.chain([first], batches) if first else (), batch, dev, timings)
        return _finish([_stream_header(level), *parts], crcs)
    finally:
        batches.close()


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
