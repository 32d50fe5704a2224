"""MTF + RLE2 over a batch of BWT columns (torch).

Port of bz2tpu/ops/mtf.py: the run collapse (_collapse), the MTF rank scan
of the collapsed sequence (K3, ops/mtf_cuda.py), the collapsed-domain RLE2
plan (_rle2_plan) and the output-domain emission (_rle2_out). Every
function works on the whole batch at once, (B, cap) in and out, with the
JAX package's dict keys and int32 dtypes.

What changed from the JAX form: the sort-based histogram is a bincount,
the stable-sort compaction a scatter to cumsum slots, and floor(log2) an
exact bucketize over the powers of two (the JAX form's lax.clz).
"""

from __future__ import annotations

import torch

from bz2tpu_torch.ops.mtf_cuda import CHUNK, mtf_ranks

MAX_RUN_DIGITS = 21  # bz2tpu.ops.mtf._MAX_RUN_DIGITS


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(x)) of positive int64 values below 2^62."""
    pow2 = 1 << torch.arange(62, dtype=torch.int64, device=x.device)
    return torch.bucketize(x, pow2, right=True) - 1


def collapse(last: torch.Tensor, ns: torch.Tensor):
    """Dense-symbol mapping + run collapse of a batch of BWT columns.

    last: (B, cap) uint8; ns: (B,) int32. Returns (cseq, cidx, m, used,
    n_in_use): cseq (B, cap) int32 collapsed dense symbols (-1 past m),
    cidx (B, cap) int32 positions of the change points (0 past m), m (B,)
    int32 collapsed lengths, used (B, 256) bool, n_in_use (B,) int32.
    """
    B, cap = last.shape
    dev = last.device
    iota = torch.arange(cap, device=dev)
    valid = iota[None, :] < ns[:, None]
    lasti = last.to(torch.int64)
    rows = torch.arange(B, device=dev)[:, None]
    counts = torch.bincount((rows * 256 + lasti)[valid], minlength=B * 256)
    used = counts.view(B, 256) > 0
    n_in_use = used.sum(1).to(torch.int32)
    dense = torch.cumsum(used, 1) - 1
    seq = torch.where(valid, dense.gather(1, lasti), -1)
    prev = torch.cat([torch.full_like(seq[:, :1], -2), seq[:, :-1]], 1)
    change = valid & (seq != prev)
    slot = torch.where(change, torch.cumsum(change, 1) - 1, cap)  # cap: trash
    cseq = torch.full((B, cap + 1), -1, dtype=torch.int32, device=dev)
    cseq.scatter_(1, slot, seq.to(torch.int32))
    cidx = torch.zeros((B, cap + 1), dtype=torch.int32, device=dev)
    cidx.scatter_(1, slot, iota.to(torch.int32).expand(B, cap))
    m = change.sum(1).to(torch.int32)
    kept = iota[None, :] < m[:, None]
    cseq = torch.where(kept, cseq[:, :cap], -1).contiguous()
    cidx = torch.where(kept, cidx[:, :cap], 0)
    return cseq, cidx, m, used, n_in_use


def rle2_plan(cranks, cidx, m, ns, used, n_in_use) -> dict[str, torch.Tensor]:
    """Collapsed-domain RLE2 plan of a batch (bz2tpu.ops.mtf._rle2_plan,
    vmapped): every array the output-domain emission needs."""
    B, cap = cranks.shape
    dev = cranks.device
    cranks = cranks.to(torch.int64)
    cidx = cidx.to(torch.int64)
    m = m.to(torch.int64)[:, None]
    n = ns.to(torch.int64)[:, None]
    k = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    k_valid = k < m
    # Zero run ending just before collapsed position k; position 0 with
    # rank 0 (already at the list front) prepends a zero to the next run.
    prev_idx = torch.cat([torch.zeros_like(cidx[:, :1]), cidx[:, :-1]], 1)
    gap = torch.where(k > 0, cidx - prev_idx - 1, 0)
    r0_zero = cranks[:, :1] == 0
    tail_gap = torch.where(m > 0, n - 1 - cidx.gather(1, (m - 1).clamp(min=0)), 0)
    gap_eff = torch.where((k == 1) & r0_zero, gap + 1, gap)
    zp1 = torch.where(k_valid, gap_eff, 0) + 1
    sym_here = k_valid & ~((k == 0) & r0_zero)
    emit = torch.where(k_valid, floor_log2(zp1) + sym_here.to(torch.int64), 0)
    offsets = torch.cumsum(emit, 1) - emit
    total = offsets[:, -1] + emit[:, -1]
    has_emit = k_valid & (emit > 0)
    pos = torch.where(has_emit, offsets, 1 << 30)
    kval = torch.where(has_emit, k, 0)
    w1 = (offsets << 9) | (cranks + 1)
    # Trailing run digits + EOB; r0_zero with m == 1: one symbol throughout.
    tz = torch.where((m == 1) & r0_zero, tail_gap + 1, tail_gap)
    tzp1 = tz + 1
    tdig = floor_log2(tzp1.clamp(min=1))
    t_lane = torch.arange(MAX_RUN_DIGITS + 1, dtype=torch.int64, device=dev)[None, :]
    eob = n_in_use.to(torch.int64)[:, None] + 1
    tail_vals = torch.where(
        t_lane < tdig, (tzp1 >> t_lane) & 1, torch.where(t_lane == tdig, eob, -1)
    )
    i32 = torch.int32
    return {
        "w1": w1.to(i32),
        "zp1": zp1.to(i32),
        "pos": pos.to(i32),
        "kval": kval.to(i32),
        "total": total.to(i32),
        "tail_vals": tail_vals.to(i32),
        "n_sym": (total + tdig[:, 0] + 1).to(i32),
        "used": used,
        "n_in_use": n_in_use.to(i32),
    }


def rle2_out(plan: dict[str, torch.Tensor], width: int) -> torch.Tensor:
    """Output-domain RLE2 emission of a batch at ``width`` >= max(n_sym)
    (bz2tpu.ops.mtf._rle2_out with with_freqs=False): (B, width) int32
    symbols (RUNA=0, RUNB=1, rank r -> r+1, EOB), -1 padding."""
    pos = plan["pos"].to(torch.int64)
    B = pos.shape[0]
    dev = pos.device
    j = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    # Output position j belongs to collapsed position k_of[j]: span-start
    # markers (one scatter-max) filled forward by a running max.
    k_of = torch.zeros(B, width + 1, dtype=torch.int64, device=dev)
    k_of.scatter_reduce_(
        1, pos.clamp(max=width), plan["kval"].to(torch.int64), reduce="amax"
    )
    k_of = torch.cummax(k_of[:, :width], 1).values
    w1_j = plan["w1"].to(torch.int64).gather(1, k_of)
    zp1_j = plan["zp1"].to(torch.int64).gather(1, k_of)
    t_of = j - (w1_j >> 9)
    mdig_j = floor_log2(zp1_j.clamp(min=1))
    digit = t_of < mdig_j
    body = torch.where(digit, (zp1_j >> torch.where(digit, t_of, 0)) & 1, w1_j & 0x1FF)
    total = plan["total"].to(torch.int64)[:, None]
    out = torch.full((B, width + MAX_RUN_DIGITS + 2), -1, dtype=torch.int64, device=dev)
    out[:, :width] = torch.where(j < total, body, -1)
    t_lane = torch.arange(MAX_RUN_DIGITS + 1, dtype=torch.int64, device=dev)[None, :]
    out.scatter_(1, total + t_lane, plan["tail_vals"].to(torch.int64))
    return out[:, :width].to(torch.int32)


def mtf_rle2_plan(last: torch.Tensor, ns: torch.Tensor, chunk: int = CHUNK) -> dict[str, torch.Tensor]:
    """Collapse + MTF ranks + RLE2 plan of a batch: the counterpart of
    bz2tpu.ops.pipeline.mtf_plan_stage (vmapped mtf_rle2_plan)."""
    cseq, cidx, m, used, n_in_use = collapse(last, ns)
    cranks = mtf_ranks(cseq, n_in_use, m, chunk)
    return rle2_plan(cranks, cidx, m, ns, used, n_in_use)
