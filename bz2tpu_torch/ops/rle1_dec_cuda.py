"""rle1_dec (D7): the decode's inverse RLE1 of a batch of rows on the card
(CUDA, csrc/rle1_dec.cu), in two launches: ``parse`` (each row's output
size, each tile's entry state and output offset) and ``expand`` (the
batch's bytes).

It replaces no Pallas kernel: bz2tpu inverts RLE1 on the host, after the
inverse BWT's copy back (bz2tpu/runtime/device_decode.py:285), as the port
did one block after another. The parse is a scan over a five-state
machine (a count byte follows four equal data bytes, whatever its value),
so each tile's bytes compose into a map of the states with the output
from each; the expand writes each count's run from many threads at once.
A batch of B rows of at most n bytes writes at most B x ceil(n / 5) x 259
bytes (``rle1_dec.out_bound``): under 400 MB for 8 level-9 blocks. At the
main path's shape it moves some 22 MB, a few microseconds at 3.35 TB/s.

ops/rle1_dec.py checks the arguments and dispatches: the plain version for
rows on the CPU, these for rows on a card.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build

# Kernel launches by wrapper (reset to 0 to count one run): two a batch.
LAUNCHES = {"rle1_dec": 0}
AGG_WORDS = 6  # a tile's map and its output from each of the five states (csrc/rle1_dec.cu)

_counters_on: dict[tuple[torch.device, int], torch.Tensor] = {}


def _counters(dev: torch.device, stream: int, n_rows: int) -> torch.Tensor:
    """n_rows + 1 zero words on the device and stream: the parse counts the
    tiles of each row and the rows done there, and sets each back to 0."""
    words = _counters_on.get((dev, stream))
    if words is None or words.shape[0] < n_rows + 1:
        words = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
        _counters_on[(dev, stream)] = words
    return words


def parse(rows: torch.Tensor, n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The first launch on the rows' card: (prefix, offsets). prefix
    (B, tiles, 2) int32 holds each tile's entry state and output offset in
    its row, offsets (B + 1,) int64 each row's start in the batch's output
    and its end (arguments as ops/rle1_dec.parse checks them)."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"rle1_dec runs on a CUDA card, not {dev}")
    b, width = rows.shape
    lib = _build.lib()
    tiles = lib.bz2t_rle1_dec_tiles(width)
    if tiles < 0:
        raise ValueError(f"rows of {width} bytes are too wide for rle1_dec")
    agg = torch.empty(b * tiles * AGG_WORDS, dtype=torch.int32, device=dev)
    prefix = torch.empty(b, tiles, 2, dtype=torch.int32, device=dev)
    offsets = torch.empty(b + 1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = _counters(dev, stream, b)
    err = lib.bz2t_rle1_dec_parse(rows.data_ptr(), rows.stride(0), width, n.data_ptr(), b, tiles, agg.data_ptr(),
                                  prefix.data_ptr(), offsets.data_ptr(), counters.data_ptr(), stream)
    _build.check(err, "rle1_dec")
    LAUNCHES["rle1_dec"] += 1
    return prefix, offsets


def expand(rows: torch.Tensor, n: torch.Tensor, prefix: torch.Tensor, offsets: torch.Tensor,
           out: torch.Tensor) -> torch.Tensor:
    """The second launch: the batch's bytes into out[:offsets[B]] (out on
    the rows' card, 16-byte aligned; arguments as ops/rle1_dec.expand
    checks them)."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"rle1_dec runs on a CUDA card, not {dev}")
    if out.data_ptr() % 16:
        raise ValueError("out must start on a 16-byte boundary (a thread stores 16 bytes at once)")
    b, width = rows.shape
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.bz2t_rle1_dec_expand(rows.data_ptr(), rows.stride(0), width, n.data_ptr(), b, prefix.shape[1],
                                   prefix.data_ptr(), offsets.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "rle1_dec")
    LAUNCHES["rle1_dec"] += 1
    return out
