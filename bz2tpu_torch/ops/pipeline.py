"""The batch encode pipeline: BWT -> MTF/RLE2 plan -> RLE2 emission +
Huffman + pack/concat (torch).

Port of bz2tpu/ops/pipeline.py's staged form (bwt_stage, mtf_plan_stage,
emit_huff_pack_concat_stage, and emit_huff_pack_stage for the per-block
form the block mesh uses). The JAX form quantises the emission width to
eighths of the capacity because every distinct XLA shape is a compile;
eager torch has none, so the batch emits at its exact max(n_sym). The
output is bit-identical at any width >= max(n_sym).
"""

from __future__ import annotations

import torch

from bz2tpu_torch.ops.bwt import bwt_stage
from bz2tpu_torch.ops.emit import pack_blocks, pack_blocks_concat
from bz2tpu_torch.ops.huffman import huffman_assign, max_selectors
from bz2tpu_torch.ops.mtf import mtf_rle2_plan as mtf_plan_stage
from bz2tpu_torch.ops.mtf import rle2_out
from bz2tpu_torch.utils.profiling import StageClock, lap, span, wait

__all__ = [
    "bwt_stage", "mtf_plan_stage", "emit_huff_pack_stage", "emit_huff_pack_concat_stage",
    "encode_batch", "encode_blocks",
]


def _emit_huff(plan, *, width: int, clock: StageClock | None):
    """RLE2 emission and Huffman planning at ``width`` (>= max n_sym)."""
    maxsel = max_selectors(width - 2)
    with span("bz2.rle2_out"):
        sym = rle2_out(plan, width)
        lap(clock, "rle2_out")
    with span("bz2.huffman"):
        hp = huffman_assign(sym, plan["n_sym"], plan["n_in_use"], maxsel)
        lap(clock, "huffman")
    return sym, hp, maxsel


def _bwt_mtf(blocks, ns, clock: StageClock | None):
    """A batch's BWT and MTF/RLE2 plan, and its emission width max(n_sym)
    read back: (orig_ptr, plan, width)."""
    with span("bz2.bwt"):
        last, orig_ptr = bwt_stage(blocks, ns)
        lap(clock, "bwt")
    with span("bz2.mtf"):
        plan = mtf_plan_stage(last, ns)
        with wait():
            width = int(plan["n_sym"].max())
        lap(clock, "mtf")
    return orig_ptr, plan, width


def emit_huff_pack_concat_stage(plan, orig_ptr, crcs, *, width: int, clock: StageClock | None = None):
    """RLE2 emission + Huffman planning at ``width`` (>= max n_sym), then
    the whole batch packs into one concatenated stream. Returns (words
    (B*Wb + 1,) int64, total_bits 0-dim int64, block_bits (B,))."""
    sym, hp, maxsel = _emit_huff(plan, width=width, clock=clock)
    with span("bz2.pack"):
        out = pack_blocks_concat(
            sym, hp["selectors"], hp["lengths"], hp["codes"], crcs, orig_ptr,
            plan["used"], hp["n_groups"], hp["n_selectors"], hp["selector_mtf"],
            maxsel=maxsel,
        )
        lap(clock, "pack")
    return out


def emit_huff_pack_stage(plan, orig_ptr, crcs, *, width: int, clock: StageClock | None = None):
    """The same at ``width``, each block packed into its own row
    (bz2tpu.ops.pipeline.emit_huff_pack_stage). Returns the dict of
    n_groups, n_selectors, words (B, Wb) int64, total_bits (B,) int64 and
    meta (B, 6) int32: orig_ptr, n_sym, n_in_use, n_groups, n_selectors,
    total_bits."""
    sym, hp, maxsel = _emit_huff(plan, width=width, clock=clock)
    with span("bz2.pack"):
        words, total_bits = pack_blocks(
            sym, hp["selectors"], hp["lengths"], hp["codes"], crcs, orig_ptr,
            plan["used"], hp["n_groups"], hp["n_selectors"], hp["selector_mtf"],
            maxsel=maxsel,
        )
        lap(clock, "pack")
    meta = torch.stack([t.to(torch.int32) for t in (
        orig_ptr, plan["n_sym"], plan["n_in_use"], hp["n_groups"], hp["n_selectors"], total_bits)], 1)
    return {"n_groups": hp["n_groups"], "n_selectors": hp["n_selectors"],
            "words": words, "total_bits": total_bits, "meta": meta}


def encode_batch(blocks, ns, crcs, timings: dict | None = None):
    """Encode a batch of RLE1 blocks into one concatenated bitstream.

    blocks (B, cap) uint8, ns (B,) int32, crcs (B,) int64 (uint32 values).
    Returns (words (W,) int64 of 32-bit MSB-first words, total_bits 0-dim
    int64). With ``timings``, per-stage seconds accumulate under "bwt",
    "mtf", "rle2_out", "huffman" and "pack" (see utils/profiling.StageClock).
    """
    with span("bz2.encode"):
        clock = None if timings is None else StageClock(timings, blocks.device)
        orig_ptr, plan, width = _bwt_mtf(blocks, ns, clock)
        words, total_bits, _ = emit_huff_pack_concat_stage(
            plan, orig_ptr, crcs, width=width, clock=clock
        )
        return words, total_bits


def encode_blocks(blocks, ns, crcs, timings: dict | None = None):
    """Encode a batch of RLE1 blocks, each into its own complete bitstream
    (bz2tpu.ops.pipeline.encode_blocks / encode_blocks_staged).

    blocks (B, cap) uint8, ns (B,) int32 (a padding row has ns = 1 and
    encodes as a one-byte block), crcs (B,) int64 (uint32 values).
    Returns the JAX pytree's keys: words (B, Wb) int64 of 32-bit MSB-first
    words, each block from bit 0 of its row; total_bits (B,) int64;
    orig_ptr, n_sym, n_in_use, n_groups, n_selectors (B,); used (B, 256);
    meta (B, 6) int32. Wb follows the batch's max(n_sym), not the
    capacity, so rows hold fewer zero words past the bits than JAX's.
    ``timings`` as in encode_batch.
    """
    with span("bz2.encode"):
        clock = None if timings is None else StageClock(timings, blocks.device)
        orig_ptr, plan, width = _bwt_mtf(blocks, ns, clock)
        out = emit_huff_pack_stage(plan, orig_ptr, crcs, width=width, clock=clock)
        out.update(orig_ptr=orig_ptr, used=plan["used"], n_sym=plan["n_sym"], n_in_use=plan["n_in_use"])
        return out
