"""CRC-32/BZIP2 (poly 0x04C11DB7, MSB-first, init/final 0xFFFFFFFF).

Parity: reference include/CRC32.hpp:30-92 (table-driven, one byte at a time).
Redesign: CRC over GF(2) is linear, so we compute it *lane-parallel*: the
input is split into L equal chunks, all L chunk states advance together one
byte-position per step (vectorized over lanes), and the per-chunk results are
folded with the "multiply by x^(8*len)" shift operator via logarithmic
pairwise combines. The device op with the same decomposition (plus masked
range CRCs via invertible shift-operator ladders) is bz2tpu/ops/crc.py;
this NumPy version is the oracle and the host fallback.

Also provides the bzip2 *stream* CRC fold s -> rotl1(s) ^ blockCRC
(reference include/OutputStream.hpp:202, include/InputStream.hpp:132) and its
associative per-block form for order-preserving parallel reduction.
"""

from __future__ import annotations

import numpy as np

_POLY = 0x04C11DB7
_MASK = 0xFFFFFFFF


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ _POLY) if (c & 0x80000000) else (c << 1)
            c &= _MASK
        table[i] = c
    return table.astype(np.uint32)


CRC32_TABLE = _make_table()


def crc32_serial(data: bytes | np.ndarray, crc: int = _MASK) -> int:
    """Byte-at-a-time oracle (semantics of reference CRC32.hpp:62-74).

    `crc` is the running pre-final-XOR state; returns the finalized CRC.
    """
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    state = np.uint32(crc)
    tab = CRC32_TABLE
    for b in arr.tolist():
        state = np.uint32(((int(state) << 8) & _MASK) ^ int(tab[((int(state) >> 24) ^ b) & 0xFF]))
    return int(state) ^ _MASK


# --- GF(2) shift operator: advance a CRC state past n zero bytes ---------


def _op_identity() -> np.ndarray:
    """32x32 GF(2) identity as 32 uint32 columns: op[i] = image of bit i."""
    return (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)


def _op_apply(op: np.ndarray, state: np.ndarray) -> np.ndarray:
    """Apply a GF(2) 32x32 operator (column form) to uint32 state(s)."""
    state = np.asarray(state, dtype=np.uint32)
    bits = (state[..., None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    terms = np.where(bits.astype(bool), op, np.uint32(0))
    return np.bitwise_xor.reduce(terms, axis=-1)


def _op_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose operators: (a . b)[i] = a(b[i])."""
    return _op_apply(a, b)


def _op_shift_one_byte() -> np.ndarray:
    """Operator advancing the CRC state past a single zero byte."""
    basis = _op_identity()
    shifted = ((basis.astype(np.uint64) << 8) & _MASK).astype(np.uint32)
    return shifted ^ CRC32_TABLE[(basis >> 24) & np.uint32(0xFF)]


_SHIFT_BYTE = _op_shift_one_byte()


def shift_operator(n_bytes: int) -> np.ndarray:
    """Operator for advancing a CRC state past n zero bytes (x^(8n) mod P)."""
    op = _op_identity()
    sq = _SHIFT_BYTE
    n = n_bytes
    while n:
        if n & 1:
            op = _op_compose(sq, op)
        sq = _op_compose(sq, sq)
        n >>= 1
    return op


def crc32_combine(crc_a_state: int, crc_b_state: int, len_b: int) -> int:
    """Combine raw (pre-final-XOR, zero-init for b) states: F(a||b)."""
    return int(_op_apply(shift_operator(len_b), np.uint32(crc_a_state))) ^ crc_b_state


def crc32(data: bytes | np.ndarray, lanes: int = 256) -> int:
    """CRC-32/BZIP2 of `data` (finalized).

    Dispatches to the native C core when built (bz2tpu/native/_bz2dec.c),
    else the lane-parallel NumPy path below; both are bit-identical to
    crc32_serial.
    """
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else np.ascontiguousarray(data, dtype=np.uint8)
    try:
        from bz2tpu_torch import native

        if native.HAVE_NATIVE and arr.size >= 4096:
            return int(native.crc32(arr.tobytes()))
    except ImportError:
        pass
    # The pairwise logarithmic fold below assumes every round merges lanes
    # of EQUAL length; a non-power-of-two lane count would mix lengths mid
    # round and fold with the wrong shift operator — round up.
    lanes = 1 << max(lanes - 1, 1).bit_length()
    n = arr.size
    if n == 0:
        return int(_MASK ^ _MASK)  # CRC of empty input: ~init = 0
    if n < lanes * 8:
        return crc32_serial(arr)
    k = n // lanes
    main = arr[: lanes * k].reshape(lanes, k)
    # Lane 0 carries the init state; other lanes start at 0 (linearity).
    states = np.zeros(lanes, dtype=np.uint32)
    states[0] = _MASK
    tab = CRC32_TABLE
    for j in range(k):
        states = ((states << np.uint32(8)) & np.uint32(_MASK)) ^ tab[
            ((states >> np.uint32(24)) ^ main[:, j]) & np.uint32(0xFF)
        ]
    # Pairwise logarithmic fold: all chunks have identical length k, so one
    # shift operator per round, squared between rounds.
    op = shift_operator(k)
    while states.size > 1:  # lane count is a power of two: clean pairing
        a = states[0::2]
        b = states[1::2]
        states = _op_apply(op, a) ^ b
        op = _op_compose(op, op)
    state = int(states[0])
    # Tail bytes, serial (< lanes bytes).
    for b in arr[lanes * k :].tolist():
        state = ((state << 8) & _MASK) ^ int(tab[((state >> 24) ^ b) & 0xFF])
    return state ^ _MASK


# --- Stream (combined) CRC ----------------------------------------------


def stream_crc_fold(stream_crc: int, block_crc: int) -> int:
    """One step of the bzip2 combined CRC: s -> rotl1(s) ^ blockCRC."""
    s = stream_crc & _MASK
    return (((s << 1) | (s >> 31)) & _MASK) ^ (block_crc & _MASK)


def stream_crc(block_crcs) -> int:
    """Fold per-block CRCs in order into the stream CRC.

    Associative form for parallel reduction: the fold over k blocks maps
    s -> rotl_k(s) ^ C where C = xor_i rotl_(k-1-i)(crc_i); pairs
    (k, C) combine associatively. Block counts are small enough that the
    sequential fold is what we ship; the identity is used by the multi-host
    gather to verify shards independently.
    """
    s = 0
    for c in block_crcs:
        s = stream_crc_fold(s, c)
    return s
