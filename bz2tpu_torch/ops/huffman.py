"""Multi-table Huffman planning over a batch (torch), semantics of stock
bzip2's sendMTFValues.

Port of bz2tpu/ops/huffman.py with the block axis written out: every
function takes (B, ...) tensors. ``huffman_assign`` seeds the tables from
each block's whole histogram, hands the refinement (group assignment and
code-length refits to the fixed point, the choice of the iteration-4 state,
the selector MTF ranks) to ops/huffman_cuda.huffman_plan, which on the card
is the kernel D2, one launch a batch, and on the CPU its plain loop, then
derives the canonical codes. On the card nothing in it waits for the host.
"""

from __future__ import annotations

import torch

from bz2tpu_torch.format import constants as C
from bz2tpu_torch.ops.huffman_cuda import huffman_plan, table_count

ALPHA = C.HUFFMAN_MAX_ALPHABET  # 258
NTAB = C.HUFFMAN_MAX_TABLES  # 6
_I64 = torch.int64


def max_selectors(capacity: int) -> int:
    """Selector-array size for a given symbol capacity (bz2tpu.ops.huffman)."""
    return (capacity + 1 + C.HUFFMAN_GROUP_SIZE - 1) // C.HUFFMAN_GROUP_SIZE + 1


def seed_lengths(freqs: torch.Tensor, n_groups: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Initial (B, 6, 258) length rows: 0 inside each table's frequency
    span, 15 outside; table t's span fills from the highest row down."""
    B = freqs.shape[0]
    dev = freqs.device
    freqs = freqs.to(_I64)
    fp = torch.cat([torch.zeros(B, 1, dtype=_I64, device=dev), torch.cumsum(freqs, 1)], 1)
    cum = fp[:, 1:].contiguous()
    lanes = torch.arange(ALPHA, dtype=_I64, device=dev)[None, :]
    lengths = torch.full((B, NTAB, ALPHA), 15, dtype=_I64, device=dev)
    n_groups = n_groups.to(_I64)[:, None]
    alpha = alpha.to(_I64)[:, None]
    gs = torch.zeros(B, 1, dtype=_I64, device=dev)
    rem_f = freqs.sum(1, keepdim=True)
    rows = torch.arange(B, device=dev)
    for t in range(NTAB):
        active = t < n_groups
        t_freq = torch.div(rem_f, (n_groups - t).clamp(min=1), rounding_mode="floor")
        prefix = fp.gather(1, gs)
        found = torch.searchsorted(cum, prefix + t_freq)
        ge = torch.where(
            t_freq <= 0, gs - 1, torch.minimum(torch.maximum(found, gs), alpha - 1)
        )
        if t % 2 == 1:
            ge = ge - ((ge > gs) & (t != n_groups - 1)).to(_I64)
        a_freq = fp.gather(1, ge + 1) - prefix
        row = (n_groups - 1 - t).clamp(min=0)[:, 0]
        in_span = (lanes >= gs) & (lanes <= ge)
        cur = lengths[rows, row]
        lengths[rows, row] = torch.where(active & in_span, 0, cur)
        gs = torch.where(active, ge + 1, gs)
        rem_f = torch.where(active, rem_f - a_freq, rem_f)
    return lengths


def canonical_codes(lengths: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Canonical code values (B, 6, 258) for lengths (B, 6, 258)."""
    dev = lengths.device
    lanes = torch.arange(ALPHA, dtype=_I64, device=dev)
    valid = (lanes[None, :] < alpha[:, None])[:, None, :]  # (B, 1, 258)
    L = torch.where(valid, lengths, 0)
    onehot = ((L[..., None] == torch.arange(1, 21, device=dev)) & valid[..., None]).to(_I64)
    counts = onehot.sum(2)  # (B, 6, 20) symbols per length
    base = torch.zeros_like(counts)
    vec = torch.zeros_like(counts[..., 0])
    for b in range(20):
        base[..., b] = vec
        vec = (vec + counts[..., b]) << 1
    rank = torch.cumsum(onehot, 2) - onehot
    rank_self = (rank * onehot).sum(3)
    base_self = base.gather(2, (L - 1).clamp(0, 19))
    return torch.where(valid & (L > 0), base_self + rank_self, 0)




def block_histogram(symbols: torch.Tensor) -> torch.Tensor:
    """(B, 258) int64 histogram of each block's symbols (-1 ignored), with
    no host sync: a scatter-add, where bincount would read its maximum.
    Each bin is spread over 64 counters by position, so the adds to the
    commonest symbols (RUNA, RUNB) do not queue on one address."""
    B, S = symbols.shape
    dev = symbols.device
    lanes = 64
    lane = torch.arange(S, dtype=_I64, device=dev) % lanes
    rows = torch.arange(B, dtype=_I64, device=dev)[:, None] * ALPHA
    idx = torch.where(symbols >= 0, rows + symbols.to(_I64), B * ALPHA) * lanes + lane
    counts = torch.zeros((B * ALPHA + 1) * lanes, dtype=_I64, device=dev)
    counts.index_add_(0, idx.view(-1), torch.ones(1, dtype=_I64, device=dev).expand(idx.numel()))
    return counts.view(B * ALPHA + 1, lanes)[:-1].sum(1).view(B, ALPHA)


def huffman_assign(symbols: torch.Tensor, n_sym: torch.Tensor, n_in_use: torch.Tensor, maxsel: int):
    """Full Huffman planning of a batch (bz2tpu.ops.huffman.huffman_assign
    with freqs=None, vmapped).

    symbols: (B, S) int32, -1 padding; n_sym, n_in_use: (B,) int32.
    Returns dict: n_groups, n_selectors (B,), selectors, selector_mtf
    (B, maxsel), lengths, codes (B, 6, 258); all int32. Entries beyond
    the valid alphabet, tables or selector count are don't-care.
    """
    alpha = n_in_use.to(_I64) + 2
    n_groups = table_count(n_sym.to(_I64))
    n_sel = (n_sym.to(_I64) + C.HUFFMAN_GROUP_SIZE - 1) // C.HUFFMAN_GROUP_SIZE
    seed = seed_lengths(block_histogram(symbols), n_groups, alpha)
    i32 = torch.int32
    selectors, selector_mtf, lengths, _ = huffman_plan(
        symbols.to(i32), n_sym.to(i32), n_in_use.to(i32), seed, maxsel)
    return {
        "n_groups": n_groups.to(i32),
        "n_selectors": n_sel.to(i32),
        "selectors": selectors,
        "selector_mtf": selector_mtf,
        "lengths": lengths,
        "codes": canonical_codes(lengths.to(_I64), alpha).to(i32),
    }
