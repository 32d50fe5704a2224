"""crc_ranges: the CRC-32/BZIP2 of many byte ranges of one chunk (CUDA,
csrc/crc_ranges.cu).

The device intake's range CRCs (ops/crc.crc32_ranges) run in JAX as one
device program: a lax.fori_loop over the lanes' bytes, a Kogge-Stone fold
and the operator ladders' lax.fori_loop (bz2tpu/ops/crc.py:166, :176-183,
:111). In eager torch each step of them is a few ops issued from the
host, so the port runs the whole function in one launch: every thread's
64 bytes through the byte table, the states folded by scans into each
tile's state, a look-back over those only in the tiles that hold a range
endpoint, each endpoint's state there, and each range's CRC in its end's
tile, which takes the start's part from the start's tile. Every shift
past n zero bytes goes through ``shift_maps``, 32 linear maps held as
nibble tables. It is a port-only kernel: it replaces device loops, not a
pl.pallas_call.

ops/crc.crc32_ranges checks the arguments and dispatches: the plain
version for a chunk on the CPU, this for one on a card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bz2tpu_torch import _build
from bz2tpu_torch.format.crc32 import _op_compose, _op_shift_one_byte

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"crc_ranges": 0}
MAX_BYTES = 2**31 - 1  # the kernel's tiles and shifts take chunks below 2^31 bytes
TILE_BYTES = 1 << 15  # bytes a CTA of the kernel steps: 512 threads x 64 (csrc/crc_ranges.cu)


@functools.cache
def shift_maps() -> np.ndarray:
    """(32, 8, 16) uint32: map k moves a CRC state past 2^k zero bytes
    (x^(8 2^k) mod P), as eight nibble tables: entry [k, j, v] is the image
    of the state whose nibble j holds v and whose other bits are 0, so
    a state's image is the xor of its eight nibbles' entries."""
    maps = np.empty((32, 8, 16), dtype=np.uint32)
    op = _op_shift_one_byte()  # its 32 columns: the images of the state's bits
    bits = ((np.arange(16)[:, None] >> np.arange(4)) & 1).astype(bool)  # (16 values, 4 bits)
    for k in range(32):
        for j in range(8):
            terms = np.where(bits, op[4 * j: 4 * j + 4], np.uint32(0)).astype(np.uint32)
            maps[k, j] = np.bitwise_xor.reduce(terms, axis=1)
        op = _op_compose(op, op)
    return maps


_maps_on: dict[torch.device, torch.Tensor] = {}


class _Workspace:
    """The kernel's workspace on one device and stream: zero when made, and
    each call leaves what the next one reads zero (the tiles taken, the
    status array it does not use, its handoff words), so no call needs a
    clearing launch. The two status arrays alternate between calls by the
    parity of a call count that the kernel keeps on the card, so no host
    state orders the calls."""

    def __init__(self, dev: torch.device, tiles: int, ranges: int):
        words = _build.lib().bz2t_crc_ranges_work(tiles, ranges)
        if words < 0:
            raise ValueError(f"{ranges} ranges are too many for crc_ranges")
        self.tiles, self.ranges = tiles, ranges
        self.words = torch.zeros(words, dtype=torch.int32, device=dev)


_work_on: dict[tuple[torch.device, int], _Workspace] = {}


def _maps(dev: torch.device) -> torch.Tensor:
    if dev not in _maps_on:
        _maps_on[dev] = torch.from_numpy(shift_maps().view(np.int32).copy()).to(dev)
    return _maps_on[dev]


def _workspace(dev: torch.device, stream: int, tiles: int, ranges: int) -> _Workspace:
    work = _work_on.get((dev, stream))
    if work is None or work.tiles < tiles or work.ranges < ranges:
        work = _Workspace(dev, max(tiles, 0 if work is None else work.tiles),
                          max(ranges, 0 if work is None else work.ranges))
        _work_on[(dev, stream)] = work
    return work


def crc_ranges(chunk: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The kernel on chunk's card: (B,) int64 finalised CRCs of
    chunk[starts[b]:ends[b]] (arguments as ops/crc.crc32_ranges checks
    them; endpoints outside [0, N] are clamped into it)."""
    dev = chunk.device
    if dev.type != "cuda":
        raise ValueError(f"crc_ranges runs on a CUDA card, not {dev}")
    n, b = chunk.shape[0], starts.shape[0]
    crcs = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return crcs
    lib = _build.lib()
    tiles = lib.bz2t_crc_ranges_tiles(n)
    if tiles < 0:
        raise ValueError(f"a chunk of {n} bytes is too large for crc_ranges (at most {MAX_BYTES})")
    if starts.dtype != ends.dtype:
        ends = ends.to(starts.dtype)
    starts, ends = starts.contiguous(), ends.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = _workspace(dev, stream, tiles, b)
    err = lib.bz2t_crc_ranges(chunk.data_ptr(), n, starts.data_ptr(), ends.data_ptr(), starts.dtype == torch.int64,
                              b, _maps(dev).data_ptr(), work.words.data_ptr(), work.tiles, work.ranges,
                              crcs.data_ptr(), stream)
    _build.check(err, "crc_ranges")
    LAUNCHES["crc_ranges"] += 1
    return crcs
