"""Burrows-Wheeler transform by pair-doubling suffix ranking (torch).

Port of bz2tpu/ops/bwt_pallas.py:bwt_encode_pallas, which is contractually
bit-identical to bz2tpu/ops/bwt.py:bwt_encode: a 3-char round 0, then
rounds that sort by (rank, rank[(i + k) mod n]) and double k while any
group is tied (``active > 0``) and ``k < n``.

Each block sorts exactly its n positions. Every sort key is one packed
non-negative int64 with nb = bit_length(n) bits per field:

  round 0:     (key24 << nb) | i                 sorted on bits [nb, nb+24)
  pair round:  (rank << 2nb) | ((s1+1) << nb) | i  sorted on bits [nb, 3nb)

The index in the low bits is the tie-break (keys enter in index order and
the sort is stable) and the order itself (key & (2^nb - 1)). The TPU
path's padding keys (2^24 + i, _BIG) existed only for its fixed shapes and
are gone; the wrapped read rank[(i + k) mod n] is a roll.
"""

from __future__ import annotations

import torch

from bz2tpu_torch.ops.bwt_cuda import rerank, sort_keys


def round0_keys(data: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """Packed round-0 keys of data[:n] (int64): (keys, nb, k0); sort them
    on bits [nb, nb + 24).

    The 24-bit key ranks three chars (data[i], data[i+1], data[i+2],
    wrapping) to depth k0 = 3 when n >= 4, one char (k0 = 1) otherwise, as
    bz2tpu.ops.bwt.round0_keys.
    """
    n = data.numel()
    nb = n.bit_length()
    if n < 4:
        key24, k0 = data << 16, 1
    else:
        key24, k0 = (data << 16) | (torch.roll(data, -1) << 8) | torch.roll(data, -2), 3
    return (key24 << nb) | torch.arange(n, device=data.device), nb, k0


def pair_keys(rank: torch.Tensor, k: int, nb: int) -> torch.Tensor:
    """Packed keys of the pair round at depth k: (rank[i], rank[(i+k) mod
    n], i); sort them on bits [nb, 3nb)."""
    r = rank.to(torch.int64)
    idx = torch.arange(r.numel(), device=r.device)
    return (r << (2 * nb)) | ((torch.roll(r, -k) + 1) << nb) | idx


def bwt_encode(block: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """BWT of the rotations of ``block[:n]``.

    block: (cap,) uint8; 1 <= n <= cap, n < 2^21. Returns (last (cap,)
    uint8, zero past n; orig_ptr 0-dim int32): the last column and the
    sorted position of rotation 0.
    """
    if not 1 <= n <= block.numel() or n >= 1 << 21:
        raise ValueError(f"block length {n} outside 1..min({block.numel()}, 2^21 - 1)")
    keys, nb, k = round0_keys(block[:n].to(torch.int64))
    keys = sort_keys(keys, nb, nb + 24)
    rank, active = rerank(keys, nb)
    while k < n and int(active) > 0:
        keys = sort_keys(pair_keys(rank, k, nb), nb, 3 * nb)
        rank, active = rerank(keys, nb)
        k *= 2
    # Ties surviving k >= n (identical rotations of a periodic block) keep
    # index order: the stable sort's tie-break, as on the TPU path.
    sa = keys & ((1 << nb) - 1)
    is_first = sa == 0
    orig_ptr = torch.argmax(is_first.to(torch.int32)).to(torch.int32)
    prev = torch.where(is_first, n - 1, sa - 1)
    last = torch.zeros_like(block)
    last[:n] = block[prev]
    return last, orig_ptr


def bwt_stage(blocks: torch.Tensor, ns: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch BWT: blocks (B, cap) uint8, ns (B,) int32 -> (last (B, cap)
    uint8, orig_ptr (B,) int32), as bz2tpu.ops.pipeline.bwt_stage."""
    lasts, ptrs = [], []
    for b, n in enumerate(ns.tolist()):
        last, ptr = bwt_encode(blocks[b], int(n))
        lasts.append(last)
        ptrs.append(ptr)
    return torch.stack(lasts), torch.stack(ptrs)
