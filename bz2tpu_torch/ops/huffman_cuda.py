"""D2: the Huffman refinement of a batch (CUDA), beside its plain torch
version.

Port of the refinement loop of bz2tpu/ops/huffman.py:huffman_assign
(:243-289) and its end choice (:291-316), vmapped over blocks: from the
seed lengths, assign each 50-symbol group the table that codes it in the
fewest bits, refit every table's code lengths to the groups it got (the
two-queue Huffman tree of code_lengths, :124-145, with the 17-bit cap's
retries), until the assignment repeats or 32 iterations ran; then keep the
state after iteration 4 instead where it costs fewer stream bits, and give
the selectors' MTF ranks. The JAX form keeps all of it in device loops
(lax.while_loop around lax.scan); eagerly that is a Python loop of ~20
torch ops, two float64 products over the (B, maxsel, 258) group histogram
and one host sync an iteration. The kernel (csrc/huffman_plan.cu, one
thread-block cluster a block) runs the whole refinement of a batch in one
launch. ``huffman_plan_ref`` is the loop itself, batched over blocks with
finished blocks frozen by masks, so each block's result is its own; its
tree scan is ``huffman_depths`` and ``code_lengths_ref``.

The matrix products of the plain version run in float64: every count is an
integer far below 2^53, so they are exact, and TF32 never applies to
float64.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build
from bz2tpu_torch.format import constants as C

ALPHA = C.HUFFMAN_MAX_ALPHABET  # 258
NTAB = C.HUFFMAN_MAX_TABLES  # 6
_INF_W = 1 << 30
_NEG = -(1 << 30)
_I64 = torch.int64
_I32 = torch.int32

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"huffman_plan": 0}


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


def code_lengths_ref(freqs: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Length-limited code lengths (1..17 below alpha, 0 beyond) of each
    row of ``freqs`` (R, 258) int64 with alphabet sizes ``alpha`` (R,):
    the tree scan above, then the cap loop (w <- 1 + w/2 on every row over
    17 bits), with finished rows frozen by masks (one host sync a retry).
    Returns (R, 258) int64."""
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


def huffman_plan_ref(symbols, n_sym, n_in_use, seed, maxsel: int):
    """Plain version of D2: the refinement as a loop over the batch while
    any block is live (one host sync an iteration). Arguments and result
    as ``huffman_plan``."""
    B = symbols.shape[0]
    dev = symbols.device
    alpha = n_in_use.to(_I64) + 2
    n_sym = n_sym.to(_I64)
    n_groups = table_count(n_sym)
    n_sel = (n_sym + C.HUFFMAN_GROUP_SIZE - 1) // C.HUFFMAN_GROUP_SIZE
    gfreq_f = group_frequencies(symbols, maxsel).to(torch.float64)
    lengths = seed.to(_I64)
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
        fitted = code_lengths_ref(rfreq.view(B * NTAB, ALPHA), alpha_rows).view(B, NTAB, ALPHA)
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
    return (selectors.to(_I32), selector_mtf_ranks(selectors, n_sel).to(_I32),
            lengths.to(_I32), i_fin.to(_I32))


def huffman_plan(symbols: torch.Tensor, n_sym: torch.Tensor, n_in_use: torch.Tensor,
                 seed: torch.Tensor, maxsel: int):
    """The refined multi-table Huffman plan of a batch of blocks.

    symbols: (B, S) int32 RLE2 symbols, -1 past each block's n_sym;
    n_sym, n_in_use: (B,) int32; seed: (B, 6, 258) int64 seed lengths
    (ops/huffman.seed_lengths); maxsel: selector slots a block. Returns
    (selectors, selector_mtf) (B, maxsel), lengths (B, 6, 258) and the
    iterations each block ran (B,), all int32; selectors are 0 past a
    block's selector count, and its selector_mtf there is the rank of
    table 0 after the last selector.
    """
    B = symbols.shape[0]
    if symbols.dtype != _I32 or symbols.dim() != 2:
        raise ValueError(f"symbols must be (B, S) int32, got {symbols.dtype} {tuple(symbols.shape)}")
    for name, t in (("n_sym", n_sym), ("n_in_use", n_in_use)):
        if t.dtype != _I32 or t.shape != (B,) or t.device != symbols.device:
            raise ValueError(f"{name} must be a ({B},) int32 tensor on {symbols.device}")
    if seed.dtype != _I64 or seed.shape != (B, NTAB, ALPHA) or seed.device != symbols.device:
        raise ValueError(f"seed must be a ({B}, {NTAB}, {ALPHA}) int64 tensor on {symbols.device}")
    if maxsel < (symbols.shape[1] + C.HUFFMAN_GROUP_SIZE - 1) // C.HUFFMAN_GROUP_SIZE:
        raise ValueError(f"maxsel {maxsel} is below the groups of {symbols.shape[1]} symbols")
    if symbols.device.type == "cpu":
        return huffman_plan_ref(symbols, n_sym, n_in_use, seed, maxsel)
    if symbols.device.type != "cuda":
        raise ValueError(f"unsupported device {symbols.device}")
    dev = symbols.device
    symbols = symbols.contiguous()
    seed32 = seed.to(_I32).contiguous()
    selectors = torch.empty(B, maxsel, dtype=_I32, device=dev)
    selector_mtf = torch.empty_like(selectors)
    lengths = torch.empty(B, NTAB, ALPHA, dtype=_I32, device=dev)
    iters = torch.empty(B, dtype=_I32, device=dev)
    err = _build.lib().bz2t_huffman_plan(
        symbols.data_ptr(), n_sym.contiguous().data_ptr(), n_in_use.contiguous().data_ptr(),
        seed32.data_ptr(), B, symbols.shape[1], maxsel,
        selectors.data_ptr(), selector_mtf.data_ptr(), lengths.data_ptr(), iters.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "huffman_plan")
    LAUNCHES["huffman_plan"] += 1
    return selectors, selector_mtf, lengths, iters
