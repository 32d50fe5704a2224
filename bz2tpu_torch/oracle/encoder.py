"""The RLE1 pre-pass and stock bzip2's block cuts in NumPy: the part of
bz2tpu/oracle/encoder.py that the port calls (runtime/compressor.
split_blocks falls back to it without the native core), copied verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bz2tpu_torch.format import constants as C
from bz2tpu_torch.format.crc32 import crc32


# --------------------------------------------------------------------------
# Stage 1: RLE1 — run-length pre-pass (reference BlockCompressor.hpp:134-154)
# --------------------------------------------------------------------------


@dataclass
class Rle1Block:
    data: np.ndarray  # RLE1-encoded bytes (uint8)
    raw_length: int  # original bytes consumed by this block
    crc: int  # CRC-32/BZIP2 over the original bytes


def _run_pieces(data: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split input into RLE1 'pieces': independent encoding units.

    A run of length L becomes floor(L/255) pieces of 255 raw bytes (5 output
    bytes each: 4 literals + count 251) plus a final piece of L%255 raw bytes
    (1-3 literals, or 4 literals + count). Pieces re-start the run state, so
    a block may be cut at any piece boundary without changing any encoding —
    this is what makes block splitting vectorizable.

    Returns (piece_values, piece_raw_lens, piece_out_lens).
    """
    n = data.size
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.uint8), z, z
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(data[1:], data[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lens = np.diff(np.append(starts, n))
    vals = data[starts]
    full = lens // 255
    rem = lens % 255
    # Expand: each run i contributes full[i] pieces of 255 + (rem[i]>0) piece.
    counts = full + (rem > 0)
    piece_vals = np.repeat(vals, counts)
    piece_lens = np.full(int(counts.sum()), 255, dtype=np.int64)
    # Positions of final (remainder) pieces within the expanded array.
    ends = np.cumsum(counts)
    has_rem = rem > 0
    piece_lens[ends[has_rem] - 1] = rem[has_rem]
    out_lens = np.where(piece_lens >= C.RLE1_MIN_RUN, 5, piece_lens)
    return piece_vals, piece_lens, out_lens


def _emit_pieces(vals: np.ndarray, raw_lens: np.ndarray, out_lens: np.ndarray) -> np.ndarray:
    """Materialize RLE1 output bytes for a sequence of pieces (vectorized)."""
    lit_counts = np.minimum(raw_lens, C.RLE1_MIN_RUN)
    total = int(out_lens.sum())
    out = np.empty(total, dtype=np.uint8)
    # Literal bytes.
    ends = np.cumsum(out_lens)
    starts = ends - out_lens
    lit_idx = np.repeat(starts, lit_counts) + _ragged_arange(lit_counts)
    out[lit_idx] = np.repeat(vals, lit_counts)
    # Count bytes for pieces >= 4 raw bytes.
    counted = raw_lens >= C.RLE1_MIN_RUN
    out[ends[counted] - 1] = (raw_lens[counted] - C.RLE1_MIN_RUN).astype(np.uint8)
    return out


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for counts array (classic cumsum trick)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ids = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(total, dtype=np.int64) - ids


def rle1_split(data: np.ndarray, level: int) -> list[Rle1Block]:
    """RLE1-encode `data` and split into blocks, stock bzip2's fill rule.

    CRC is over the *original* bytes of each block (reference
    BlockCompressor.hpp:137). Cuts follow bzlib EXACTLY (verified against
    libbz2's own block spans, tests/test_native.py): pieces flush while
    the block's output is < block_capacity (= nblockMAX, 100000*level -
    19), so the block ends at the FIRST CROSSING piece — overshoot up to
    4 bytes — and the in-progress run carries entirely into the next
    block (stock's mid-stream compressBlock runs WITHOUT flush_RL).
    Matching stock's boundaries makes every block's content identical to
    libbz2's (round 5: the level-6 sweep's +0.006% ratio was entirely
    boundary drift).
    """
    data = np.ascontiguousarray(data, dtype=np.uint8)
    cap = C.block_capacity(level)
    vals, raw_lens, out_lens = _run_pieces(data)
    blocks: list[Rle1Block] = []
    if vals.size == 0:
        return blocks
    out_cum = np.cumsum(out_lens)
    raw_cum = np.cumsum(raw_lens)
    n_pieces = vals.size
    piece0 = 0
    out_base = 0
    raw_base = 0
    while piece0 < n_pieces:
        # First piece whose cumulative output reaches cap (inclusive cut);
        # no crossing -> the rest is the final block.
        k = int(np.searchsorted(out_cum, out_base + cap, side="left"))
        k = min(k, n_pieces - 1)
        sl = slice(piece0, k + 1)
        block_bytes = _emit_pieces(vals[sl], raw_lens[sl], out_lens[sl])
        raw_end = int(raw_cum[k])
        blocks.append(
            Rle1Block(
                data=block_bytes,
                raw_length=raw_end - raw_base,
                crc=crc32(data[raw_base:raw_end]),
            )
        )
        out_base = int(out_cum[k])
        raw_base = raw_end
        piece0 = k + 1
    return blocks
