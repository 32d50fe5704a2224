"""Inverse MTF + RUNA/RUNB run expansion of a batch of blocks (torch).

Port of bz2tpu/ops/mtf_dec.py, batched over (B, M):

  * a maximal RUNA/RUNB digit segment (bijective base 2, LSB first) sums
    (digit + 1) << position_in_segment, a segmented sum over cumsums;
  * each literal "move index j to the front" is a permutation of the
    256-entry list; chunks of 128 literals compose theirs step by step,
    the kernel ``mtf_dec`` (ops/mtf_dec_cuda.py; a lax.fori_loop of 128
    steps in the JAX form), and a Hillis-Steele doubling over the chunk
    axis chains the chunk permutations (torch has no associative_scan);
  * run bytes repeat the last literal byte; the BWT column materialises
    with one searchsorted over the per-symbol output-length cumsum.

Integer widths follow the JAX form (int32 sums), so a corrupt block
wraps where the JAX one wraps.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from bz2tpu_torch.format import constants as C
from bz2tpu_torch.ops.mtf_dec_cuda import CHUNK, chunk_perms

_I32_MAX = 2**31 - 1


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Apply permutation a first, then b: combined[k] = a[b[k]]."""
    return a.gather(-1, b.to(torch.int64))


def inclusive_scan(q: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix composition over axis 1 of (B, n, 256) chunk
    permutations: out[:, c] = compose(... compose(q[:, 0], q[:, 1]) ...,
    q[:, c]), by Hillis-Steele doubling (ceil(log2 n) rounds)."""
    n = q.shape[1]
    d = 1
    while d < n:
        q = torch.cat([q[:, :d], compose(q[:, :-d], q[:, d:])], dim=1)
        d <<= 1
    return q


def mtf_rle2_decode(
    symbols: torch.Tensor,
    n_sym: torch.Tensor,
    initial_list: torch.Tensor,
    eob: torch.Tensor,
    *,
    out_capacity: int,
    lap: Callable[[str], None] = lambda stage: None,
) -> dict[str, torch.Tensor]:
    """Expand MTF/RLE2 symbols into the BWT last column.

    symbols: (B, M) int32 incl. the final EOB, -1 padded, M a multiple of
    128; n_sym, eob: (B,) int32; initial_list: (B, 256) int32 (used byte
    values ascending, 0 padded); out_capacity: the JAX form's static
    buffer size, the bound that ``ok`` checks.

    Returns dict with bwt (B, W) uint8, n_bwt (B,) int32 and ok (B,) bool
    (False if a run overflows out_capacity or a digit run exceeds any
    legal length). W is min(max n_bwt, out_capacity), at least 1 (one
    host sync): the JAX form's (out_capacity,) row cut at W, as every
    entry past n_bwt is 0. ``lap`` is called with "segments" (the
    run sums and the literal compaction), "chunk_perms", "chunk_scan" and
    "expand" as each step ends (a stage clock's lap, for a
    clocked decode).
    """
    B, m = symbols.shape
    if m % CHUNK:
        raise ValueError(f"M={m} must be a multiple of {CHUNK}")
    dev = symbols.device
    i32 = torch.int32
    idx = torch.arange(m, dtype=i32, device=dev)[None, :]
    eob = eob.to(i32)[:, None]
    valid = (idx < n_sym.to(i32)[:, None]) & (symbols >= 0)
    sym = torch.where(valid, symbols, eob)
    is_run = valid & (sym <= C.RUNB)
    is_lit = valid & (sym >= 2) & (sym != eob)

    # --- zero-run segment values (bijective base 2, LSB first) ---
    prev_run = torch.cat([torch.zeros_like(is_run[:, :1]), is_run[:, :-1]], 1)
    head = is_run & ~prev_run
    seg_start = torch.cummax(torch.where(head, idx, -1), 1).values
    pos_in_seg = idx - seg_start
    too_long = (is_run & (pos_in_seg >= 25)).any(1)
    contrib = torch.where(is_run, (sym + 1) << pos_in_seg.clamp(0, 24), 0)
    csum = torch.cumsum(contrib, 1, dtype=i32)
    # Segment end (exclusive): first non-run index after the head.
    nonrun_at = torch.where(~is_run, idx, _I32_MAX)
    after = torch.cat([nonrun_at[:, 1:], torch.full_like(nonrun_at[:, :1], m)], 1)
    seg_end = torch.cummin(after.flip(1), 1).values.flip(1).clamp(max=m)
    excl_before = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], 1)
    run_total = csum.gather(1, (seg_end - 1).clamp(0, m - 1).long()) - excl_before

    # --- literal compaction: js[rank] = sym - 1, padding j = 0 (identity) ---
    # Every literal's sym - 1 lies in [1, 255] (sym < eob <= 257), so uint8
    # holds it.
    lit_i = is_lit.to(i32)
    lit_rank = torch.cumsum(lit_i, 1, dtype=i32) - lit_i
    js = torch.zeros(B, m + 1, dtype=torch.uint8, device=dev)
    js.scatter_(1, torch.where(is_lit, lit_rank, m).long(), (sym - 1).to(torch.uint8))
    js = js[:, :m].contiguous()

    lap("segments")

    # --- inverse MTF: chunk permutations (mtf_dec), then their scan ---
    q, emit = chunk_perms(js)
    del js
    lap("chunk_perms")
    q_incl = inclusive_scan(q)
    q_excl = torch.cat([torch.arange(256, device=dev).to(torch.uint8).expand(B, 1, 256), q_incl[:, :-1]], 1)
    glob_emit = q_excl.gather(2, emit.long())
    del q, q_incl, q_excl
    lap("chunk_scan")
    lit_vals = initial_list.to(i32).gather(1, glob_emit.view(B, m).long())  # byte per literal rank

    # --- per-symbol byte values ---
    lit_val_at = lit_vals.gather(1, lit_rank.clamp(0, m - 1).long())
    last_lit_idx = torch.cummax(torch.where(is_lit, idx, -1), 1).values
    rank_at_last = lit_rank.gather(1, last_lit_idx.clamp(0, m - 1).long())
    run_val = torch.where(
        last_lit_idx >= 0,
        lit_vals.gather(1, rank_at_last.clamp(0, m - 1).long()),
        initial_list[:, :1].to(i32),
    )

    # --- output expansion ---
    out_len = torch.where(head, run_total, lit_i)
    out_cum = torch.cumsum(out_len, 1, dtype=i32)
    n_bwt = out_cum[:, -1]
    ok = (n_bwt <= out_capacity) & (n_bwt > 0) & ~too_long
    width = max(1, min(int(n_bwt.max()), out_capacity))
    q_pos = torch.arange(width, dtype=i32, device=dev).expand(B, width).contiguous()
    src = torch.searchsorted(out_cum.contiguous(), q_pos, right=True).clamp(0, m - 1)
    byte = torch.where(head.gather(1, src), run_val.gather(1, src), lit_val_at.gather(1, src))
    bwt = torch.where(q_pos < n_bwt[:, None], byte, 0).to(torch.uint8)
    lap("expand")
    return {"bwt": bwt, "n_bwt": n_bwt, "ok": ok}
