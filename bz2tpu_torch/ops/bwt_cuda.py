"""K1 and K2: the BWT doubling round's sort and re-rank (CUDA), each beside
its plain torch version.

Port of bz2tpu/ops/bwt_pallas.py. A doubling round's whole lexicographic
key, index tie-break and block slot included, is one packed int64 (see
ops/bwt.py), so

  * ``sort_keys`` (K1, csrc/bwt_sort.cu) is a stable LSD radix sort over a
    bit range of the packed keys (bitonic_sort_pallas's contract), one
    call for all blocks of a batch, and
  * ``rerank`` (K2, csrc/bwt_rerank.cu) finds group heads, takes the
    running max of head positions and scatters them back to index order,
    block by block (rerank_pallas plus the inverse-permutation sort it was
    paired with), in one kernel that reads the keys once: the carry
    between tiles is a decoupled look-back over one status word a tile.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"bwt_sort": 0, "bwt_rerank": 0}
MAX_SLOTS = 64  # K2's per-slot counters (csrc/bwt_rerank.cu kMaxSlots)
MAX_KEYS = (1 << 30) - 1  # a count or position fits a status word's 30 value bits


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(
            f"keys must be a contiguous 1-D int64 tensor, got {keys.dtype} "
            f"{tuple(keys.shape)}"
        )
    if keys.numel() > MAX_KEYS:
        raise ValueError(f"at most 2^30 - 1 keys, got {keys.numel()}")
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


def _slot_args(keys: torch.Tensor, slot_shift: int, offsets: torch.Tensor | None) -> torch.Tensor:
    if not 1 <= slot_shift <= 63:
        raise ValueError(f"slot_shift must be in 1..63, got {slot_shift}")
    if offsets is None:
        return torch.zeros(1, dtype=torch.int32, device=keys.device)
    if offsets.dtype != torch.int32 or offsets.dim() != 1 or offsets.device != keys.device:
        raise ValueError(f"offsets must be a 1-D int32 tensor on {keys.device}")
    if not 1 <= offsets.numel() <= MAX_SLOTS:
        raise ValueError(f"1..{MAX_SLOTS} slots, got {offsets.numel()}")
    return offsets.contiguous()


def rerank_ref(
    keys: torch.Tensor, idx_bits: int, slot_shift: int = 63, offsets: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 (the head/cummax/tied chain of bz2tpu's
    ops/bwt.py plus the inverse permutation, per slot)."""
    offsets = _slot_args(keys, slot_shift, offsets)
    n = keys.numel()
    group = keys >> idx_bits
    head = torch.ones(n, dtype=torch.bool, device=keys.device)
    head[1:] = group[1:] != group[:-1]
    iota = torch.arange(n, device=keys.device)
    pos = torch.cummax(torch.where(head, iota, 0), 0).values
    slot = keys >> slot_shift
    off = offsets.to(torch.int64)[slot]
    rank = torch.empty(n, dtype=torch.int32, device=keys.device)
    rank[off + (keys & ((1 << idx_bits) - 1))] = (pos - off).to(torch.int32)
    nxt = torch.ones_like(head)
    nxt[:-1] = head[1:]
    tied = (~head | ~nxt).to(torch.int32)
    active = torch.zeros(offsets.numel(), dtype=torch.int32, device=keys.device)
    return rank, active.index_add_(0, slot, tied)


def rerank(
    keys: torch.Tensor, idx_bits: int, slot_shift: int = 63, offsets: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Position ranks of the sorted packed keys of one or more blocks, each
    block's in index order within its own slice.

    ``keys`` is sorted by its group bits (above ``idx_bits``) and carries
    each position's index within its block in the low ``idx_bits``, and
    the block's slot from ``slot_shift`` up. Slot s holds the positions
    offsets[s] .. offsets[s + 1] - 1 (the last one up to n), in slot order,
    as a stable sort of keys entered in (slot, index) order leaves them.
    ``offsets`` (L,) int32 defaults to one slot at 0. Returns (rank (n,)
    int32, active (L,) int32): rank[offsets[s] + i] is the sorted position,
    within slot s, of the head of i's group; active[s] the number of slot
    s's positions in groups of size >= 2.
    """
    _check_keys(keys)
    if not 1 <= idx_bits <= 31:
        raise ValueError(f"idx_bits must be in 1..31, got {idx_bits}")
    offsets = _slot_args(keys, slot_shift, offsets)
    if keys.device.type == "cpu":
        return rerank_ref(keys, idx_bits, slot_shift, offsets)
    lib = _build.lib()
    n = keys.numel()
    rank = torch.empty(n, dtype=torch.int32, device=keys.device)
    n_slots = offsets.numel()
    # The active counts head the kernel's work buffer (then its tile counter
    # and status words), so that one memset clears all of it.
    work = torch.empty(lib.bz2t_rerank_work(n, n_slots), dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = lib.bz2t_rerank(
        keys.data_ptr(), n, idx_bits, slot_shift, offsets.data_ptr(), n_slots,
        rank.data_ptr(), work.data_ptr(), stream,
    )
    _build.check(err, "bwt_rerank")
    LAUNCHES["bwt_rerank"] += 1
    return rank, work[:n_slots]
