"""CRC-32/BZIP2 of many byte ranges of one buffer (torch).

Port of bz2tpu/ops/crc.py:crc32_ranges. CRC over GF(2) is affine, so one
unmasked pass over the buffer cut into L equal lanes (all lanes advance
one byte per step) gives every lane's running state; the pass captures
the state at each range endpoint's in-lane offset as it goes by. A
Kogge-Stone fold over the lanes gives the prefix state at each lane
boundary, and the ladders of "advance past 2^k zero bytes" operators turn
endpoint states into range CRCs:

    crc[s, e) from init I  =  M^(e-s)(I xor S(s)) xor S(e)

with S(p) the raw state of the prefix [0, p) from init 0 and M the
one-byte shift operator. CRC states are int64 holding 32-bit values.

The lane loop is k = N / L steps. The JAX form runs it as one device
loop and defaults to 4,096 lanes; in eager torch every step is a few
launches, so the default is 65,536 lanes: 128 steps at the level-9 chunk
of 8 MiB. The CRC does not depend on the lane count.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bz2tpu.format.crc32 import CRC32_TABLE, _op_compose, _op_shift_one_byte, shift_operator

MASK32 = 0xFFFFFFFF
DEFAULT_LANES = 1 << 16


@functools.cache
def _ladder_tables(max_log: int) -> np.ndarray:
    """(max_log, 32) operators, row k advancing a CRC state past 2^k zero
    bytes (the forward half of bz2tpu.ops.crc._ladder_tables; its inverse
    half is unused there too)."""
    fwd = np.empty((max_log, 32), dtype=np.uint32)
    m = _op_shift_one_byte()
    for k in range(max_log):
        fwd[k] = m
        m = _op_compose(m, m)
    return fwd


@functools.cache
def _fold_ops(k: int, rounds: int) -> np.ndarray:
    """(rounds, 32) operators: round r advances past k * 2^r zero bytes."""
    ops = np.empty((rounds, 32), dtype=np.uint32)
    op = shift_operator(k)
    for r in range(rounds):
        ops[r] = op
        op = _op_compose(op, op)
    return ops


def _xor_reduce(t: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (a power of two wide); torch has no XOR
    reduction, so halves fold pairwise."""
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] ^ t[..., h:]
    return t[..., 0]


def apply_op(op: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Apply a GF(2) operator (32 columns, int64) to int64 state(s)."""
    bits = (state[..., None] >> torch.arange(32, device=state.device)) & 1
    return _xor_reduce(torch.where(bits.bool(), op, 0))


def _apply_ladder(ops: torch.Tensor, exponent: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """op^exponent applied by the binary ladder (ops[k] = op^(2^k))."""
    for k in range(ops.shape[0]):
        state = torch.where(((exponent >> k) & 1).bool(), apply_op(ops[k], state), state)
    return state


def crc32_ranges(
    chunk: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor, *, lanes: int = DEFAULT_LANES
) -> torch.Tensor:
    """Finalized CRC-32/BZIP2 of chunk[starts[b]:ends[b]] for each range b.

    chunk: (N,) uint8 (bytes outside every range may be anything);
    starts/ends: (B,) integer ranges, 0 <= start <= end <= N. The lane
    count is the largest power of two <= ``lanes`` dividing N. Returns
    (B,) int64 holding 32-bit CRCs.
    """
    n = chunk.shape[0]
    dev = chunk.device
    lanes_eff = 1
    while lanes_eff * 2 <= lanes and n % (lanes_eff * 2) == 0:
        lanes_eff *= 2
    lanes = lanes_eff
    if n == 0 or n % lanes:
        raise ValueError(f"chunk length {n} must be a positive multiple of the lane count")
    k = n // lanes
    tab = torch.from_numpy(CRC32_TABLE.astype(np.int64)).to(dev)
    lane_data = chunk.view(lanes, k).t().to(torch.int64).contiguous()  # (k, L): step j reads row j

    # Endpoint p == n maps to lane == lanes with offset 0: its captured
    # partial state is the init 0, and its boundary prefix is the full fold.
    pts = torch.cat([starts, ends]).to(torch.int64)
    pt_lane = pts // k
    pt_off = pts % k
    pt_lane_c = pt_lane.clamp(0, lanes - 1)

    states = torch.zeros(lanes, dtype=torch.int64, device=dev)
    captured = torch.zeros(pts.shape[0], dtype=torch.int64, device=dev)
    for j in range(k):
        # states[l] holds lane l's first j bytes from init 0.
        captured = torch.where(pt_off == j, states[pt_lane_c], captured)
        idx = ((states >> 24) ^ lane_data[j]) & 0xFF
        states = ((states << 8) & MASK32) ^ tab[idx]

    # Inclusive lane-boundary prefixes T[m] = S((m + 1) k), by doubling on
    # the recurrence T[m] = M^k(T[m - 1]) xor C[m].
    rounds = lanes.bit_length() - 1
    fold = torch.from_numpy(_fold_ops(k, rounds).astype(np.int64)).to(dev)
    t = states
    for r in range(rounds):
        sh = 1 << r
        shifted = torch.cat([torch.zeros(sh, dtype=torch.int64, device=dev), t[:-sh]])
        t = apply_op(fold[r], shifted) ^ t
    s_bound = torch.where(pt_lane == 0, 0, t[(pt_lane - 1).clamp(0, lanes - 1)])

    # Exponents are at most n, so ceil(log2(n + 1)) rungs cover them all.
    max_log = max(1, int(np.ceil(np.log2(n + 1))))
    fwd = torch.from_numpy(_ladder_tables(max_log).astype(np.int64)).to(dev)
    s_pts = _apply_ladder(fwd, pt_off, s_bound) ^ captured
    b = starts.shape[0]
    span = (ends - starts).to(torch.int64)
    raw = _apply_ladder(fwd, span, s_pts[:b] ^ MASK32) ^ s_pts[b:]
    return raw ^ MASK32
