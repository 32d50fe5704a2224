"""Burrows-Wheeler transform by pair-doubling suffix ranking (torch), all
blocks of a batch in one sort per round.

Port of bz2tpu/ops/bwt_pallas.py:bwt_encode_pallas, which is contractually
bit-identical to bz2tpu/ops/bwt.py:bwt_encode: a 3-char round 0, then
rounds that sort by (rank, rank[(i + k) mod n]) and double k while any
group is tied (``active > 0``) and ``k < n``; bz2tpu.ops.pipeline.bwt_stage
runs it per block under vmap.

Here the live blocks of a batch sort together. They lie concatenated in
slot order, each exactly its n positions, and every sort key is one packed
non-negative int64 with nb = bit_length(max n) bits per field, the block's
slot above its key:

  round 0:     (slot << (nb+24)) | (key24 << nb) | i     sorted on bits [nb, nb+24+S)
  pair round:  (slot << 3nb) | (rank << 2nb) | ((s1+1) << nb) | i
                                                        sorted on bits [nb, 3nb+S)

with S = bit_length(live blocks - 1) slot bits and i the index within the
block. A wider field leaves a block's order unchanged, and keys enter in
(slot, index) order, so the stable sort leaves each block contiguous, in
its own order: the index is the tie-break (and the order itself, key &
(2^nb - 1)), the slot keeps blocks apart. A round is one sort (K1), one
re-rank (K2) with per-block ranks and ``active`` counts, and one copy of
those counts to the host; a block leaves once ``k >= n`` or its ``active``
is 0, and the next round sorts only the blocks still live. The TPU path's
padding keys (2^24 + i, _BIG) existed only for its fixed shapes and are
gone; the wrapped read rank[(i + k) mod n] is a gather within the block.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bz2tpu_torch.ops.bwt_cuda import MAX_SLOTS, rerank, sort_keys
from bz2tpu_torch.utils.profiling import count, wait

_I64 = torch.int64
MAX_N = (1 << 21) - 1  # 3 fields of 21 bits fill a non-negative int64


def slot_limit(nb: int) -> int:
    """Blocks one sort can carry with nb-bit fields: their slot bits must
    fit above the widest key (nb + 24 bits in round 0, 3nb in a pair
    round) in a non-negative int64, and K2 counts at most MAX_SLOTS."""
    return min(MAX_SLOTS, 1 << (63 - max(nb + 24, 3 * nb)))


@dataclass
class Layout:
    """Live blocks concatenated in slot order: ``ids`` (the batch row of
    each slot), ``ns`` and ``starts`` (each slot's range) on the host; on
    the device ``off``/``n`` (L,) int64, and per position ``seg`` (its
    slot) and ``idx`` (its index within the block)."""

    ids: list[int]
    ns: list[int]
    starts: list[int]
    off: torch.Tensor
    n: torch.Tensor
    seg: torch.Tensor
    idx: torch.Tensor

    @property
    def slot_bits(self) -> int:
        return (len(self.ids) - 1).bit_length()


def layout(ids: list[int], ns: list[int], device: torch.device) -> Layout:
    """The layout of batch rows ``ids`` with lengths ``ns`` (host lists)."""
    starts = [sum(ns[:s]) for s in range(len(ns))]
    off = torch.tensor(starts, dtype=_I64, device=device)
    n = torch.tensor(ns, dtype=_I64, device=device)
    seg = torch.repeat_interleave(torch.arange(len(ns), device=device), n, output_size=sum(ns))
    return Layout(ids, ns, starts, off, n, seg, torch.arange(sum(ns), device=device) - off[seg])


def _wrapped(lay: Layout, step) -> torch.Tensor:
    """Position of (i + step) mod n within each position's block."""
    return lay.off[lay.seg] + (lay.idx + step) % lay.n[lay.seg]


def round0_keys(blocks: torch.Tensor, lay: Layout, nb: int) -> tuple[torch.Tensor, int]:
    """Packed round-0 keys of the blocks in ``lay`` (rows of ``blocks``
    (B, cap) uint8) and the top bit of their sort range.

    The 24-bit key ranks three chars (data[i], data[i+1], data[i+2],
    wrapping) to depth k0 = 3 when n >= 4, one char (k0 = 1) otherwise, as
    bz2tpu.ops.bwt.round0_keys.
    """
    rows = torch.tensor(lay.ids, dtype=_I64, device=blocks.device)[lay.seg]
    flat = blocks.reshape(-1).to(_I64)
    data = flat[rows * blocks.shape[1] + lay.idx]
    c1, c2 = data[_wrapped(lay, 1)], data[_wrapped(lay, 2)]
    key24 = torch.where(lay.n[lay.seg] < 4, data << 16, (data << 16) | (c1 << 8) | c2)
    keys = (lay.seg << (nb + 24)) | (key24 << nb) | lay.idx
    return keys, nb + 24 + lay.slot_bits


def pair_keys(rank: torch.Tensor, k: torch.Tensor, lay: Layout, nb: int) -> tuple[torch.Tensor, int]:
    """Packed keys of the pair round at depth k[slot] (a (L,) tensor):
    (slot, rank[i], rank[(i+k) mod n], i) of every position, and the top bit
    of their sort range."""
    r = rank.to(_I64)
    s1 = r[_wrapped(lay, k[lay.seg])]
    keys = (lay.seg << (3 * nb)) | (r << (2 * nb)) | ((s1 + 1) << nb) | lay.idx
    return keys, 3 * nb + lay.slot_bits


def _round(keys: torch.Tensor, hi_bit: int, slot_shift: int, lay: Layout, nb: int):
    """One sort and one re-rank of a batch's keys: (sorted keys, ranks,
    per-slot active counts)."""
    count("bwt_rounds")
    keys = sort_keys(keys, nb, hi_bit)
    rank, active = rerank(keys, nb, slot_shift, lay.off.to(torch.int32))
    return keys, rank, active


def _sort_batch(blocks: torch.Tensor, ns: list[int]) -> torch.Tensor:
    """Suffix order of every block (at most slot_limit(nb) of them): (sum
    ns,) int64, block after block, each its positions in sorted order."""
    dev = blocks.device
    nb = max(ns).bit_length()
    lay = layout(list(range(len(ns))), ns, dev)
    starts = lay.starts  # each block's range in sa
    sa = torch.empty(sum(ns), dtype=_I64, device=dev)
    k = [1 if n < 4 else 3 for n in ns]
    keys, hi = round0_keys(blocks, lay, nb)
    keys, rank, active = _round(keys, hi, nb + 24, lay, nb)
    while True:
        with wait():
            act = active.tolist()
        live = [s for s, b in enumerate(lay.ids) if k[b] < ns[b] and act[s] > 0]
        for s, b in enumerate(lay.ids):
            if s not in live:
                # Ties surviving k >= n (identical rotations of a periodic
                # block) keep index order: the stable sort's tie-break, as
                # on the TPU path.
                o = lay.starts[s]
                sa[starts[b] : starts[b] + ns[b]] = keys[o : o + ns[b]] & ((1 << nb) - 1)
        if not live:
            return sa
        if len(live) < len(lay.ids):
            rank = torch.cat([rank[lay.starts[s] : lay.starts[s] + lay.ns[s]] for s in live])
            ids = [lay.ids[s] for s in live]
            lay = layout(ids, [ns[b] for b in ids], dev)
        k_t = torch.tensor([k[b] for b in lay.ids], dtype=_I64, device=dev)
        keys, hi = pair_keys(rank, k_t, lay, nb)
        keys, rank, active = _round(keys, hi, 3 * nb, lay, nb)
        for b in lay.ids:
            k[b] *= 2


def bwt_stage(blocks: torch.Tensor, ns: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch BWT: blocks (B, cap) uint8, ns (B,) int32 -> (last (B, cap)
    uint8, zero past n; orig_ptr (B,) int32), as bz2tpu.ops.pipeline.
    bwt_stage: the last column and the sorted position of rotation 0.

    Needs 1 <= n <= min(cap, 2^21 - 1). The blocks sort together, at most
    slot_limit(nb) of them in one sort (8 at level 9): a larger batch
    splits into that many at a time.
    """
    B, cap = blocks.shape
    dev = blocks.device
    with wait():
        ns_host = [int(n) for n in ns.tolist()]
    for n in ns_host:
        if not 1 <= n <= min(cap, MAX_N):
            raise ValueError(f"block length {n} outside 1..min({cap}, 2^21 - 1)")
    step = slot_limit(max(ns_host).bit_length())
    sa = torch.cat([_sort_batch(blocks[b : b + step], ns_host[b : b + step]) for b in range(0, B, step)])
    lay = layout(list(range(B)), ns_host, dev)
    is_first = sa == 0
    prev = torch.where(is_first, lay.n[lay.seg] - 1, sa - 1)
    rows = lay.seg * cap
    last = torch.zeros_like(blocks)
    last.view(-1)[rows + lay.idx] = blocks.reshape(-1)[rows + prev]
    # Rotation 0's sorted position: one flag per block, found row by row
    # (a sum into B slots would funnel every position into B atomics).
    first = torch.zeros(B, cap, dtype=torch.uint8, device=dev)
    first.view(-1)[rows + lay.idx] = is_first.to(torch.uint8)
    return last, first.argmax(1).to(torch.int32)


def bwt_encode(block: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """BWT of the rotations of ``block[:n]`` (block: (cap,) uint8). Returns
    (last (cap,) uint8, zero past n; orig_ptr 0-dim int32)."""
    last, orig_ptr = bwt_stage(block[None], torch.tensor([n], dtype=torch.int32))
    return last[0], orig_ptr[0]
