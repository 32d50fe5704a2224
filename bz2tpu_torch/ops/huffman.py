"""Multi-table Huffman planning over a batch (torch), semantics of stock
bzip2's sendMTFValues.

Port of bz2tpu/ops/huffman.py with the block axis written out: every
function takes (B, ...) tensors, and the loops that the JAX form runs per
block under vmap (the depth-cap loop of code_lengths, the refinement to the
fixed point) run once over the batch while any block is still live, with
finished blocks frozen by masks, so each block's result is its own.

The two matrix products of the refinement (group x table cost, per-table
frequencies) run in float64: every count is an integer far below 2^53, so
the products are exact, and TF32 never applies to float64.

The 257-step two-queue tree scan (huffman_depths) is a Python loop of
small batched ops; on a GPU that is some thousands of launches per
refinement iteration.
"""

from __future__ import annotations

import torch

from bz2tpu.format import constants as C

ALPHA = C.HUFFMAN_MAX_ALPHABET  # 258
NTAB = C.HUFFMAN_MAX_TABLES  # 6
_INF_W = 1 << 30
_NEG = -(1 << 30)
_I64 = torch.int64


def max_selectors(capacity: int) -> int:
    """Selector-array size for a given symbol capacity (bz2tpu.ops.huffman)."""
    return (capacity + 1 + C.HUFFMAN_GROUP_SIZE - 1) // C.HUFFMAN_GROUP_SIZE + 1


def table_count(n_sym: torch.Tensor) -> torch.Tensor:
    """Tables per block (2..6) from the symbol count."""
    count = torch.full_like(n_sym, C.HUFFMAN_MIN_TABLES, dtype=_I64)
    for t in C.TABLE_COUNT_THRESHOLDS:
        count += (n_sym >= t).to(_I64)
    return count


def huffman_depths(weights: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Leaf depths of the Huffman trees over weights[r, :alpha[r]].

    weights: (R, 258) int64, entries >= alpha ignored; alpha: (R,). Two
    queues over stably sorted leaves, a leaf preferred over an internal
    node on a weight tie (the oracle's tie-breaks). Returns (R, 258) int64.
    """
    R = weights.shape[0]
    dev = weights.device
    lanes = torch.arange(ALPHA, dtype=_I64, device=dev)
    valid = lanes[None, :] < alpha[:, None]
    leaf_w, order = torch.sort(torch.where(valid, weights, _INF_W), dim=1, stable=True)
    n_nodes = 2 * ALPHA - 1  # leaves by symbol id, internal node j at ALPHA + j
    parent = torch.arange(n_nodes + 1, dtype=_I64, device=dev).repeat(R, 1)  # + trash
    node_w = torch.full((R, ALPHA - 1), _INF_W, dtype=_I64, device=dev)
    li = torch.zeros(R, 1, dtype=_I64, device=dev)
    ii = torch.zeros(R, 1, dtype=_I64, device=dev)
    alpha = alpha[:, None].to(_I64)
    trash = torch.full_like(li, n_nodes)

    def pick(li, ii, j):
        leaf_avail = li < alpha
        node_avail = ii < j
        lw = torch.where(leaf_avail, leaf_w.gather(1, li.clamp(max=ALPHA - 1)), _INF_W)
        nw = torch.where(node_avail, node_w.gather(1, ii.clamp(max=ALPHA - 2)), _INF_W)
        take_leaf = leaf_avail & (~node_avail | (lw <= nw))
        pick_id = torch.where(take_leaf, order.gather(1, li.clamp(max=ALPHA - 1)), ALPHA + ii)
        take = take_leaf.to(_I64)
        return li + take, ii + 1 - take, pick_id, torch.where(take_leaf, lw, nw)

    for j in range(ALPHA - 1):
        active = j < alpha - 1
        li1, ii1, p0, w0 = pick(li, ii, j)
        li2, ii2, p1, w1 = pick(li1, ii1, j)
        node_w[:, j : j + 1] = torch.where(active, w0 + w1, _INF_W)
        parent.scatter_(1, torch.where(active, p0, trash), ALPHA + j)
        parent.scatter_(1, torch.where(active, p1, trash), ALPHA + j)
        li = torch.where(active, li2, li)
        ii = torch.where(active, ii2, ii)

    # Depth = parent hops to the (self-parented) root, by pointer doubling.
    parent = parent[:, :n_nodes]
    hop = (parent != torch.arange(n_nodes, device=dev)[None, :]).to(_I64)
    jump = parent
    for _ in range(10):  # 2^10 > any depth (<= 257)
        hop = hop + hop.gather(1, jump)
        jump = jump.gather(1, jump)
    return torch.where(valid, hop[:, :ALPHA], 0)


def code_lengths(freqs: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Length-limited code lengths (1..17 below alpha, 0 beyond) for each
    row of freqs (R, 258): depths of the Huffman tree, with the weights
    flattened to 1 + w/2 on every row that exceeds the cap, until none does."""
    lanes = torch.arange(ALPHA, dtype=_I64, device=freqs.device)
    valid = lanes[None, :] < alpha[:, None]
    w = torch.where(valid, freqs.to(_I64).clamp(min=1), 0)
    depths = huffman_depths(w, alpha)
    over = depths.max(1).values > C.HUFFMAN_ENCODE_MAX_LENGTH
    while bool(over.any()):
        w = torch.where(over[:, None] & valid, 1 + (w >> 1), w)
        depths = torch.where(over[:, None], huffman_depths(w, alpha), depths)
        over &= depths.max(1).values > C.HUFFMAN_ENCODE_MAX_LENGTH
    return depths


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


def group_frequencies(symbols: torch.Tensor, maxsel: int) -> torch.Tensor:
    """(B, maxsel, 258) histogram of symbols per 50-symbol group."""
    B, S = symbols.shape
    dev = symbols.device
    gid = torch.arange(S, dtype=_I64, device=dev) // C.HUFFMAN_GROUP_SIZE
    rows = torch.arange(B, dtype=_I64, device=dev)[:, None]
    flat = (rows * maxsel + gid[None, :]) * ALPHA + symbols.to(_I64)
    counts = torch.bincount(flat[symbols >= 0], minlength=B * maxsel * ALPHA)
    return counts.view(B, maxsel, ALPHA)


def selector_mtf_ranks(selectors: torch.Tensor, n_sel: torch.Tensor) -> torch.Tensor:
    """MTF rank of each selector against the running table list (B, maxsel)."""
    B, maxsel = selectors.shape
    dev = selectors.device
    lanes = torch.arange(NTAB, dtype=_I64, device=dev)
    pos = torch.arange(maxsel, dtype=_I64, device=dev)[None, :]
    sel = torch.where(pos < n_sel[:, None], selectors.to(_I64), -1)
    times = torch.where(sel[:, :, None] == lanes, pos[:, :, None], _NEG)
    incl = torch.cummax(times, 1).values
    before = torch.cat([torch.full_like(incl[:, :1], _NEG), incl[:, :-1]], 1)
    last = torch.maximum(-(lanes + 1), before)
    own = last.gather(2, sel.clamp(0, NTAB - 1)[:, :, None])
    return (last > own).sum(2)


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


def huffman_assign(symbols: torch.Tensor, n_sym: torch.Tensor, n_in_use: torch.Tensor, maxsel: int):
    """Full Huffman planning of a batch (bz2tpu.ops.huffman.huffman_assign
    with freqs=None, vmapped).

    symbols: (B, S) int32, -1 padding; n_sym, n_in_use: (B,) int32.
    Returns dict: n_groups, n_selectors (B,), selectors, selector_mtf
    (B, maxsel), lengths, codes (B, 6, 258); all int32. Entries beyond
    the valid alphabet, tables or selector count are don't-care.
    """
    B = symbols.shape[0]
    dev = symbols.device
    alpha = n_in_use.to(_I64) + 2
    n_sym = n_sym.to(_I64)
    n_groups = table_count(n_sym)
    n_sel = (n_sym + C.HUFFMAN_GROUP_SIZE - 1) // C.HUFFMAN_GROUP_SIZE
    gfreq = group_frequencies(symbols, maxsel)
    gfreq_f = gfreq.to(torch.float64)
    lengths = seed_lengths(gfreq.sum(1), n_groups, alpha)
    tables = torch.arange(NTAB, device=dev)
    table_ok = tables[None, :] < n_groups[:, None]
    group_valid = torch.arange(maxsel, device=dev)[None, :] < n_sel[:, None]
    alpha_rows = alpha.repeat_interleave(NTAB)

    def refit(sel):
        """Per-table frequencies of the groups assigned to each table."""
        onehot = (sel[:, :, None] == tables) & group_valid[:, :, None]
        return torch.bmm(onehot.to(torch.float64).transpose(1, 2), gfreq_f).to(_I64)

    selectors = torch.zeros(B, maxsel, dtype=_I64, device=dev)
    snap = (lengths, selectors)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    i_fin = torch.zeros(B, dtype=_I64, device=dev)
    for i in range(C.HUFFMAN_REFINE_ITERS):
        if not bool(live.any()):
            break
        cost = torch.bmm(gfreq_f, lengths.to(torch.float64).transpose(1, 2))  # exact
        cost = torch.where(table_ok[:, None, :], cost, float("inf"))
        new_sel = torch.argmin(cost, dim=2)
        # Fixed point: the assignment repeated, so the lengths would too.
        done = (new_sel == selectors).all(1) if i > 0 else torch.zeros_like(live)
        rfreq = refit(new_sel)
        fitted = code_lengths(rfreq.view(B * NTAB, ALPHA), alpha_rows).view(B, NTAB, ALPHA)
        step_len = torch.where(done[:, None, None], lengths, fitted)
        lengths = torch.where(live[:, None, None], step_len, lengths)
        selectors = torch.where(live[:, None], new_sel, selectors)
        if i == 3:
            # Stock's operating point: the state after exactly 4 iterations.
            snap = (
                torch.where(live[:, None, None], lengths, snap[0]),
                torch.where(live[:, None], selectors, snap[1]),
            )
        i_fin = torch.where(live, i + 1, i_fin)
        live &= ~done
    # A block that converged before its 5th iteration has no snapshot: its
    # iteration-4 state is the converged one.
    snapped = i_fin > 3
    lengths4 = torch.where(snapped[:, None, None], snap[0], lengths)
    selectors4 = torch.where(snapped[:, None], snap[1], selectors)

    lane_ok = torch.arange(ALPHA, device=dev)[None, None, :] < alpha[:, None, None]
    tab_mask = table_ok[:, :, None] & lane_ok

    def total_bits(lg, sel):
        """Stream bits that depend on (lengths, selectors): symbol codes,
        selector unaries and delta-coded table rows."""
        sym_bits = (refit(sel) * lg).sum((1, 2))
        sel_bits = torch.where(group_valid, selector_mtf_ranks(sel, n_sel) + 1, 0).sum(1)
        prev = torch.cat([lg[:, :, :1], lg[:, :, :-1]], 2)
        tab_bits = torch.where(tab_mask, 2 * (lg - prev).abs() + 1, 0).sum((1, 2))
        return sym_bits + sel_bits + tab_bits

    prefer4 = total_bits(lengths4, selectors4) < total_bits(lengths, selectors)
    lengths = torch.where(prefer4[:, None, None], lengths4, lengths)
    selectors = torch.where(prefer4[:, None], selectors4, selectors)
    i32 = torch.int32
    return {
        "n_groups": n_groups.to(i32),
        "n_selectors": n_sel.to(i32),
        "selectors": selectors.to(i32),
        "selector_mtf": selector_mtf_ranks(selectors, n_sel).to(i32),
        "lengths": lengths.to(i32),
        "codes": canonical_codes(lengths, alpha).to(i32),
    }
