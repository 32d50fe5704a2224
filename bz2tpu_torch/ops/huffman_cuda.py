"""D2: length-limited Huffman code lengths (CUDA), beside its plain torch
version.

Port of bz2tpu/ops/huffman.py:code_lengths, vmapped over table rows: the
depths of the two-queue Huffman tree, with the weights flattened to
1 + w/2 on every row that exceeds the 17-bit cap until none does. The JAX
form keeps the 257-step merge in a device loop (lax.scan inside a
lax.while_loop); eagerly, that loop is ~50 small launches a step, so the
kernel (csrc/huffman_lengths.cu, one CTA per row) runs it whole on the
card. ``code_lengths_ref`` is the loop itself, batched over rows.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build
from bz2tpu_torch.format import constants as C

ALPHA = C.HUFFMAN_MAX_ALPHABET  # 258
_INF_W = 1 << 30
_I64 = torch.int64

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"huffman_lengths": 0}


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
    """Plain version of D2: the tree scan above, then the cap loop, with
    finished rows frozen by masks (one host sync per retry)."""
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


def code_lengths(freqs: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Length-limited code lengths (1..17 below alpha, 0 beyond) for each
    row of ``freqs`` (R, 258) int64 with alphabet sizes ``alpha`` (R,)
    int64 in 0..258. Returns (R, 258) int64."""
    if freqs.dtype != _I64 or freqs.dim() != 2 or freqs.shape[1] != ALPHA:
        raise ValueError(f"freqs must be (R, {ALPHA}) int64, got {freqs.dtype} {tuple(freqs.shape)}")
    if alpha.dtype != _I64 or alpha.shape != freqs.shape[:1] or alpha.device != freqs.device:
        raise ValueError(f"alpha must be ({freqs.shape[0]},) int64 on {freqs.device}")
    if freqs.device.type == "cpu":
        return code_lengths_ref(freqs, alpha)
    if freqs.device.type != "cuda":
        raise ValueError(f"unsupported device {freqs.device}")
    freqs = freqs.contiguous()
    alpha = alpha.contiguous()
    out = torch.empty_like(freqs)
    err = _build.lib().bz2t_huffman_lengths(
        freqs.data_ptr(), alpha.data_ptr(), out.data_ptr(), freqs.shape[0],
        torch.cuda.current_stream(freqs.device).cuda_stream,
    )
    _build.check(err, "huffman_lengths")
    LAUNCHES["huffman_lengths"] += 1
    return out
