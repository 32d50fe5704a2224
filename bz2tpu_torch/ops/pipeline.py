"""The batch encode pipeline: BWT -> MTF/RLE2 plan -> RLE2 emission +
Huffman + pack/concat (torch).

Port of bz2tpu/ops/pipeline.py's staged form (bwt_stage, mtf_plan_stage,
emit_huff_pack_concat_stage). The JAX form quantises the emission width to
eighths of the capacity because every distinct XLA shape is a compile;
eager torch has none, so the batch emits at its exact max(n_sym). The
output is bit-identical at any width >= max(n_sym).
"""

from __future__ import annotations

import time

import torch

from bz2tpu_torch.ops.bwt import bwt_stage
from bz2tpu_torch.ops.emit import pack_blocks_concat
from bz2tpu_torch.ops.huffman import huffman_assign, max_selectors
from bz2tpu_torch.ops.mtf import mtf_rle2_plan as mtf_plan_stage
from bz2tpu_torch.ops.mtf import rle2_out

__all__ = ["bwt_stage", "mtf_plan_stage", "emit_huff_pack_concat_stage", "encode_batch"]


class StageClock:
    """Adds each stage's seconds to ``timings[name]``. Every lap waits for
    the device, so a clocked run is slightly slower than an unclocked one."""

    def __init__(self, timings: dict, device: torch.device):
        self.timings = timings
        self.device = device
        self.t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        t = self._now()
        self.timings[name] = self.timings.get(name, 0.0) + (t - self.t)
        self.t = t


def _lap(clock: StageClock | None, name: str) -> None:
    if clock is not None:
        clock.lap(name)


def emit_huff_pack_concat_stage(plan, orig_ptr, crcs, *, width: int, clock: StageClock | None = None):
    """RLE2 emission + Huffman planning at ``width`` (>= max n_sym), then
    the whole batch packs into one concatenated stream. Returns (words
    (B*Wb + 1,) int64, total_bits 0-dim int64, block_bits (B,))."""
    maxsel = max_selectors(width - 2)
    sym = rle2_out(plan, width)
    _lap(clock, "rle2_out")
    hp = huffman_assign(sym, plan["n_sym"], plan["n_in_use"], maxsel)
    _lap(clock, "huffman")
    out = pack_blocks_concat(
        sym, hp["selectors"], hp["lengths"], hp["codes"], crcs, orig_ptr,
        plan["used"], hp["n_groups"], hp["n_selectors"], hp["selector_mtf"],
        maxsel=maxsel,
    )
    _lap(clock, "pack")
    return out


def encode_batch(blocks, ns, crcs, timings: dict | None = None):
    """Encode a batch of RLE1 blocks into one concatenated bitstream.

    blocks (B, cap) uint8, ns (B,) int32, crcs (B,) int64 (uint32 values).
    Returns (words (W,) int64 of 32-bit MSB-first words, total_bits 0-dim
    int64). With ``timings``, per-stage seconds accumulate under "bwt",
    "mtf", "rle2_out", "huffman" and "pack" (see StageClock).
    """
    clock = None if timings is None else StageClock(timings, blocks.device)
    last, orig_ptr = bwt_stage(blocks, ns)
    _lap(clock, "bwt")
    plan = mtf_plan_stage(last, ns)
    width = int(plan["n_sym"].max())
    _lap(clock, "mtf")
    words, total_bits, _ = emit_huff_pack_concat_stage(
        plan, orig_ptr, crcs, width=width, clock=clock
    )
    return words, total_bits
