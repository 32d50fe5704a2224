"""Inverse BWT of a batch of blocks by pointer doubling (torch).

Port of bz2tpu/ops/ibwt.py, batched over (B, S) with a per-block length
and origin pointer. The T-vector is the stable order of the last column,
with padding keys (257) sorting after every real byte; the walk's orbit
pos[0] = T[orig_ptr], pos[i+1] = T[pos[i]] is materialised in ceil(log2 S)
rounds: after round r the first 2^r entries are known, and the 2^r-step
jump map shifted by f = 2^r gives the next 2^r.
"""

from __future__ import annotations

import torch


def ibwt(last: torch.Tensor, n: torch.Tensor, orig_ptr: torch.Tensor) -> torch.Tensor:
    """Invert the BWT of each row of a padded batch.

    last: (B, S) uint8 last columns, padded past n (content ignored);
    n, orig_ptr: (B,) integer valid lengths and origin pointers. Returns
    (B, S) uint8 decoded bytes, 0 past n. An origin pointer outside the
    row reads its nearest end, as the JAX gather clamps (the caller
    rejects such blocks).
    """
    B, s = last.shape
    dev = last.device
    iota = torch.arange(s, device=dev)[None, :]
    valid = iota < n.to(torch.int64)[:, None]
    key = torch.where(valid, last.to(torch.int16), 257)
    jump = torch.sort(key, dim=1, stable=True).indices  # (B, S) int64
    del key
    ptr = orig_ptr.to(torch.int64).clamp(0, s - 1)[:, None]
    pos = torch.zeros_like(jump)
    pos[:, :1] = jump.gather(1, ptr)
    rounds = max(1, (s - 1).bit_length())
    for r in range(rounds):
        f = 1 << r
        cand = torch.roll(jump.gather(1, pos), f, dims=1)
        pos = torch.where((iota >= f) & (iota < 2 * f), cand, pos)
        if r + 1 < rounds:
            jump = jump.gather(1, jump)
    return torch.where(valid, last.gather(1, pos), 0).to(torch.uint8)
