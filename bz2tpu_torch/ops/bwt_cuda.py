"""K1 and K2: the BWT doubling round's sort and re-rank (CUDA), each beside
its plain torch version.

Port of bz2tpu/ops/bwt_pallas.py. A doubling round's whole lexicographic
key, index tie-break included, is one packed int64 (see ops/bwt.py), so

  * ``sort_keys`` (K1, csrc/bwt_sort.cu) is a stable LSD radix sort over a
    bit range of the packed keys (bitonic_sort_pallas's contract), and
  * ``rerank`` (K2, csrc/bwt_rerank.cu) finds group heads, takes the
    running max of head positions and scatters them back to index order
    (rerank_pallas plus the inverse-permutation sort it was paired with).

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"bwt_sort": 0, "bwt_rerank": 0}


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(
            f"keys must be a contiguous 1-D int64 tensor, got {keys.dtype} "
            f"{tuple(keys.shape)}"
        )
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")


def _bit_field(keys: torch.Tensor, lo_bit: int, hi_bit: int) -> torch.Tensor:
    return (keys >> lo_bit) & ((1 << (hi_bit - lo_bit)) - 1)


def sort_keys_ref(keys: torch.Tensor, lo_bit: int, hi_bit: int) -> torch.Tensor:
    """Plain version of K1: ``keys`` stably sorted by bits [lo_bit, hi_bit)."""
    _, perm = torch.sort(_bit_field(keys, lo_bit, hi_bit), stable=True)
    return keys[perm]


def sort_keys(keys: torch.Tensor, lo_bit: int, hi_bit: int) -> torch.Tensor:
    """Non-negative int64 ``keys`` stably sorted by bits [lo_bit, hi_bit).

    Keys given in index order with the index in the bits below ``lo_bit``
    come out in full lexicographic order: stability is the tie-break.
    """
    _check_keys(keys)
    if not 0 <= lo_bit < hi_bit <= 63:
        raise ValueError(f"bit range [{lo_bit}, {hi_bit}) empty or outside [0, 63)")
    if keys.device.type == "cpu":
        return sort_keys_ref(keys, lo_bit, hi_bit)
    lib = _build.lib()
    n = keys.numel()
    out = torch.empty_like(keys)
    tmp = torch.empty_like(keys)
    hist = torch.empty(lib.bz2t_radix_sort_scratch(n), dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = lib.bz2t_radix_sort_u64(
        keys.data_ptr(), out.data_ptr(), tmp.data_ptr(), hist.data_ptr(),
        n, lo_bit, hi_bit, stream,
    )
    _build.check(err, "bwt_sort")
    LAUNCHES["bwt_sort"] += 1
    return out


def rerank_ref(keys: torch.Tensor, idx_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 (the head/cummax/tied chain of ops/bwt.py plus
    the inverse permutation)."""
    n = keys.numel()
    group = keys >> idx_bits
    head = torch.ones(n, dtype=torch.bool, device=keys.device)
    head[1:] = group[1:] != group[:-1]
    iota = torch.arange(n, device=keys.device)
    pos = torch.cummax(torch.where(head, iota, 0), 0).values
    rank = torch.empty(n, dtype=torch.int32, device=keys.device)
    rank[keys & ((1 << idx_bits) - 1)] = pos.to(torch.int32)
    nxt = torch.ones_like(head)
    nxt[:-1] = head[1:]
    active = (~head | ~nxt).sum().to(torch.int32)
    return rank, active


def rerank(keys: torch.Tensor, idx_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Position ranks of sorted packed keys, in index order.

    ``keys`` is sorted by its group bits (above ``idx_bits``) and carries
    each position's index in the low ``idx_bits`` (a permutation of
    0..n-1). Returns (rank (n,) int32, active 0-dim int32): rank[i] is the
    sorted position of i's group head, active the number of positions in
    groups of size >= 2.
    """
    _check_keys(keys)
    if not 1 <= idx_bits <= 31:
        raise ValueError(f"idx_bits must be in 1..31, got {idx_bits}")
    if keys.device.type == "cpu":
        return rerank_ref(keys, idx_bits)
    lib = _build.lib()
    n = keys.numel()
    rank = torch.empty(n, dtype=torch.int32, device=keys.device)
    active = torch.empty((), dtype=torch.int32, device=keys.device)
    scratch = torch.empty(lib.bz2t_rerank_scratch(n), dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = lib.bz2t_rerank(
        keys.data_ptr(), n, idx_bits, rank.data_ptr(), active.data_ptr(),
        scratch.data_ptr(), stream,
    )
    _build.check(err, "bwt_rerank")
    LAUNCHES["bwt_rerank"] += 1
    return rank, active
