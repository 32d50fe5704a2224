"""Oracle bzip2 decoder: accepts ALL conformant .bz2 streams (incl. stock).

Semantics of reference include/InputStream.hpp:36-159 (stream orchestration),
include/BlockDecompressor.hpp:37-284 (block decode), and
include/HuffmanStageDecoder.hpp (canonical limit/base/perm tables), but at
standard 100k-900k block scale — the reference rejects real bzip2 streams
(include/BlockDecompressor.hpp:213-215); this decoder does not.

Vectorized where the format allows: the inverse BWT T-walk is extracted by
permutation pointer-doubling (log2(n) gathers instead of n dependent hops),
and inverse RLE1 bulk-copies literal spans between >=4-runs.
"""

from __future__ import annotations

import numpy as np

from bz2tpu_torch.format import constants as C
from bz2tpu_torch.format.bitio import BitReader
from bz2tpu_torch.format.crc32 import crc32, stream_crc_fold


class Bz2FormatError(ValueError, OSError):
    """Malformed stream. Subclasses BOTH ValueError (this package's
    historical contract) and OSError (what stdlib bz2 raises, so code
    migrated from `import bz2` keeps catching corruption errors)."""


class Bz2CrcError(Bz2FormatError):
    pass


# --------------------------------------------------------------------------
# Huffman canonical decode tables (reference HuffmanStageDecoder.hpp:86-136)
# --------------------------------------------------------------------------


def build_decode_tables(lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(limit, base, perm, min_len) for one table's code lengths."""
    lengths = np.asarray(lengths, dtype=np.int64)
    max_l = int(lengths.max())
    min_l = int(lengths.min())
    if not (1 <= min_l and max_l <= C.HUFFMAN_DECODE_MAX_ACCEPTED_LENGTH):
        raise Bz2FormatError(f"invalid code length range {min_l}..{max_l}")
    perm = np.argsort(lengths, kind="stable").astype(np.int64)
    limit = np.zeros(C.HUFFMAN_DECODE_MAX_LENGTH + 1, dtype=np.int64)
    base = np.zeros(C.HUFFMAN_DECODE_MAX_LENGTH + 2, dtype=np.int64)
    count = np.bincount(lengths, minlength=C.HUFFMAN_DECODE_MAX_LENGTH + 1)
    vec = 0
    total = 0
    for bits in range(min_l, max_l + 1):
        base[bits] = vec - total  # code - base = rank into perm
        vec += int(count[bits])
        total += int(count[bits])
        limit[bits] = vec - 1
        vec <<= 1
    limit[max_l + 1 :] = np.iinfo(np.int64).max
    return limit, base, perm, min_l


# --------------------------------------------------------------------------
# Block decode
# --------------------------------------------------------------------------


def _read_symbol_map(r: BitReader) -> np.ndarray:
    ranges = r.read_bits(16)
    used = np.zeros(256, dtype=bool)
    for i in range(16):
        if ranges & (0x8000 >> i):
            bits = r.read_bits(16)
            for j in range(16):
                if bits & (0x8000 >> j):
                    used[16 * i + j] = True
    return used


def _read_tables(r: BitReader, n_groups: int, alpha_size: int) -> np.ndarray:
    lengths = np.zeros((n_groups, alpha_size), dtype=np.int64)
    for t in range(n_groups):
        cur = r.read_bits(5)
        for v in range(alpha_size):
            while r.read_bit():
                cur += -1 if r.read_bit() else 1
            if not 1 <= cur <= C.HUFFMAN_DECODE_MAX_ACCEPTED_LENGTH:
                raise Bz2FormatError("code length out of range")
            lengths[t, v] = cur
    return lengths


def _decode_selectors(r: BitReader, n_groups: int, n_selectors: int) -> np.ndarray:
    mtf = list(range(n_groups))
    out = np.empty(n_selectors, dtype=np.int64)
    for i in range(n_selectors):
        j = r.read_unary()
        if j >= n_groups:
            raise Bz2FormatError("selector out of range")
        s = mtf.pop(j)
        mtf.insert(0, s)
        out[i] = s
    return out


def _decode_huffman_data(
    r: BitReader,
    selectors: np.ndarray,
    tables: list[tuple[np.ndarray, np.ndarray, np.ndarray, int]],
    used_bytes: np.ndarray,
    alpha_size: int,
    max_block_bytes: int,
) -> np.ndarray:
    """Huffman symbols -> RUNA/RUNB expansion -> inverse MTF -> BWT bytes.

    Semantics of reference BlockDecompressor.hpp:187-242.
    """
    eob = alpha_size - 1
    mtf = list(used_bytes.tolist())  # dense value -> byte
    out = np.empty(max_block_bytes, dtype=np.uint8)
    n_out = 0
    run = 0
    run_bit = 0
    group = -1
    gcount = 0
    limit = base = perm = None
    min_l = 0
    while True:
        if gcount == 0:
            group += 1
            if group >= selectors.size:
                raise Bz2FormatError("ran out of selectors")
            limit, base, perm, min_l = tables[int(selectors[group])]
            gcount = C.HUFFMAN_GROUP_SIZE
        gcount -= 1
        # canonical decode: extend code until <= limit[len]
        bits = min_l
        code = r.read_bits(min_l)
        while code > limit[bits]:
            code = (code << 1) | r.read_bit()
            bits += 1
            if bits > C.HUFFMAN_DECODE_MAX_ACCEPTED_LENGTH:
                raise Bz2FormatError("invalid Huffman code")
        perm_idx = code - int(base[bits])
        if not 0 <= perm_idx < perm.size:
            raise Bz2FormatError("invalid Huffman code")
        sym = int(perm[perm_idx])
        if sym in (C.RUNA, C.RUNB):
            run += (sym + 1) << run_bit
            run_bit += 1
            continue
        if run:
            if n_out + run > max_block_bytes:
                raise Bz2FormatError("block exceeds declared block size")
            out[n_out : n_out + run] = mtf[0]
            n_out += run
            run = 0
            run_bit = 0
        if sym == eob:
            break
        # inverse MTF for value sym-1 >= 1
        j = sym - 1
        v = mtf.pop(j)
        mtf.insert(0, v)
        if n_out >= max_block_bytes:
            raise Bz2FormatError("block exceeds declared block size")
        out[n_out] = v
        n_out += 1
    return out[:n_out]


def inverse_bwt(last: np.ndarray, orig_ptr: int) -> np.ndarray:
    """Invert the BWT via stable counting order + pointer doubling.

    The reference walks the T-vector one dependent hop per byte
    (BlockDecompressor.hpp:269-282); here the walk orbit is materialized with
    log2(n) batched gathers (jump arrays order^(2^k)), which is the same
    formulation the TPU decode path uses.
    """
    n = last.size
    if not 0 <= orig_ptr < n:
        raise Bz2FormatError("origin pointer out of range")
    order = np.argsort(last, kind="stable").astype(np.int64)
    pos = np.empty(n, dtype=np.int64)
    pos[0] = order[orig_ptr]
    filled = 1
    jump = order
    while filled < n:
        take = min(filled, n - filled)
        pos[filled : filled + take] = jump[pos[:take]]
        filled += take
        if filled < n:
            jump = jump[jump]
    return last[pos]


def inverse_rle1(data: np.ndarray) -> np.ndarray:
    """Undo the RLE1 pre-pass (reference BlockDecompressor.hpp:55-90).

    Bulk-copies literal spans; only >=4-run groups are visited in Python.
    """
    n = data.size
    if n == 0:
        return data
    # Segment (run) decomposition of the encoded bytes.
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(data[1:], data[:-1], out=change[1:])
    seg_id = np.cumsum(change) - 1
    seg_starts = np.flatnonzero(change)
    seg_ends = np.append(seg_starts[1:], n)  # end of the segment containing each start
    end_of = seg_ends[seg_id]  # end index of the segment containing position i
    candidates = seg_starts[(seg_ends - seg_starts) >= C.RLE1_MIN_RUN]

    pieces: list[np.ndarray] = []
    extras_val: list[int] = []
    extras_cnt: list[int] = []
    pos = 0
    for cand in candidates.tolist():
        if cand < pos:
            cand = pos  # partially consumed by a previous count byte
        # Literal span before this run region.
        while True:
            run_end = int(end_of[cand]) if cand < n else cand
            run = run_end - cand
            if run < C.RLE1_MIN_RUN:
                break
            if cand > pos:
                pieces.append(data[pos:cand])
            if cand + C.RLE1_MIN_RUN >= n:
                raise Bz2FormatError("RLE1 run missing count byte")
            pieces.append(data[cand : cand + C.RLE1_MIN_RUN])
            extra = int(data[cand + C.RLE1_MIN_RUN])
            if extra:
                extras_val.append(int(data[cand]))
                extras_cnt.append(extra)
                pieces.append(_EXTRA_MARKER)
            pos = cand + C.RLE1_MIN_RUN + 1
            cand = pos
            if cand >= n:
                break
    if pos < n:
        pieces.append(data[pos:n])
    # Assemble: replace markers by repeated values.
    out_parts: list[np.ndarray] = []
    ei = 0
    for p in pieces:
        if p is _EXTRA_MARKER:
            out_parts.append(np.full(extras_cnt[ei], extras_val[ei], dtype=np.uint8))
            ei += 1
        else:
            out_parts.append(p)
    return np.concatenate(out_parts) if out_parts else np.zeros(0, dtype=np.uint8)


_EXTRA_MARKER = np.zeros(0, dtype=np.uint8)  # identity-compared sentinel


# --------------------------------------------------------------------------
# Stream decode
# --------------------------------------------------------------------------


def decompress(stream: bytes | np.ndarray, verify_crc: bool = True) -> bytes:
    """Decode a standard .bz2 stream, verifying per-block and stream CRCs."""
    try:
        return _decompress_inner(stream, verify_crc)
    except EOFError as e:  # BitReader exhaustion anywhere = truncated stream
        raise Bz2FormatError(f"truncated stream: {e}") from None


def _decompress_inner(stream: bytes | np.ndarray, verify_crc: bool) -> bytes:
    if len(stream) == 0:
        return b""  # stdlib parity: bz2.decompress(b"") == b""
    r = BitReader(stream)
    out_parts: list[np.ndarray] = []
    first_member = True
    # Multi-member streams: like stock bzip2 / stdlib bz2, keep decoding
    # while the byte-aligned remainder begins a valid stream header.
    # stdlib parity (measured against CPython bz2.decompress): trailing
    # data that ERRORS during decode is ignored, but trailing data that is
    # merely TRUNCATED — a proper prefix of "BZh<digit>", or a valid-magic
    # member cut short — raises, matching stdlib's eof check.
    while True:
        if not first_member:
            r.align_to_byte()
            rem = r.bits_remaining // 8
            if rem == 0:
                break
            mark = r.bit_position
            head = bytes(r.read_bits(8) for _ in range(min(rem, 4)))
            r._pos = mark
            want = C.STREAM_MAGIC  # b"BZh"
            if head[:3] != want[: min(len(head), 3)] or (
                len(head) >= 4 and not (ord("1") <= head[3] <= ord("9"))
            ):
                break  # junk tail: ignore
            if rem < 4:
                raise EOFError("trailing stream-magic prefix cut short")
        checkpoint = len(out_parts)
        try:
            if r.read_bits(24) != int.from_bytes(C.STREAM_MAGIC, "big"):
                raise Bz2FormatError("bad stream magic (expected BZh)")
            level = r.read_bits(8) - ord("0")
            if not C.MIN_LEVEL <= level <= C.MAX_LEVEL:
                raise Bz2FormatError(f"bad block-size level {level}")
            _decode_member(r, level, verify_crc, out_parts)
        except EOFError:
            # Truncation of a member whose header validated: re-raise
            # (wrapped by decompress() into Bz2FormatError), stdlib parity.
            raise
        except (Bz2FormatError, Bz2CrcError):
            if first_member:
                raise
            del out_parts[checkpoint:]  # discard the undecodable trailing member
            break
        first_member = False
    return (np.concatenate(out_parts) if out_parts else np.zeros(0, dtype=np.uint8)).tobytes()


def _decode_member(r: BitReader, level: int, verify_crc: bool, out_parts: list) -> None:
    max_block = C.BLOCK_SIZE_BASE * level
    s_crc = 0
    while True:
        marker = r.read_bits(48)
        if marker == C.STREAM_END_MARKER:
            stored = r.read_bits(32)
            if verify_crc and stored != s_crc:
                raise Bz2CrcError(f"stream CRC mismatch: {stored:#x} != {s_crc:#x}")
            break
        if marker != C.BLOCK_HEADER_MARKER:
            raise Bz2FormatError(f"bad block marker {marker:#x}")
        block_crc = r.read_bits(32)
        randomised = r.read_bit()
        orig_ptr = r.read_bits(24)
        used = _read_symbol_map(r)
        used_bytes = np.flatnonzero(used)
        if used_bytes.size == 0:
            raise Bz2FormatError("empty symbol map")
        alpha_size = used_bytes.size + 2
        n_groups = r.read_bits(3)
        if not C.HUFFMAN_MIN_TABLES <= n_groups <= C.HUFFMAN_MAX_TABLES:
            raise Bz2FormatError(f"bad table count {n_groups}")
        n_selectors = r.read_bits(15)
        # 18002-cap: standard-scale analog of the reference's check
        # (include/BlockDecompressor.hpp:158-161).
        if not 1 <= n_selectors <= C.HUFFMAN_MAX_SELECTORS:
            raise Bz2FormatError(f"bad selector count {n_selectors}")
        selectors = _decode_selectors(r, n_groups, n_selectors)
        lengths = _read_tables(r, n_groups, alpha_size)
        tables = [build_decode_tables(lengths[t]) for t in range(n_groups)]
        bwt_last = _decode_huffman_data(r, selectors, tables, used_bytes, alpha_size, max_block)
        walked = inverse_bwt(bwt_last, orig_ptr)
        if randomised:
            # libbz2 XORs the walk output (pre-RLE1), NOT the last column.
            walked = _derandomise(walked)
        decoded = inverse_rle1(walked)
        if verify_crc:
            got = crc32(decoded)
            if got != block_crc:
                raise Bz2CrcError(f"block CRC mismatch: {block_crc:#x} != {got:#x}")
        s_crc = stream_crc_fold(s_crc, block_crc)
        out_parts.append(decoded)


def rand_fire_positions(n: int) -> np.ndarray:
    """Byte indices (< n) whose value a randomised block XORs with 1.

    The bzip2 0.9.0 schedule (libbz2 decompress.c BZ_RAND_* macros) reloads
    a countdown from C.RAND_NUMS (cycled) whenever it hits 0, decrements
    once per post-BWT byte, and fires while the countdown reads 1 — i.e.
    the k-th fire lands exactly at byte cumsum(RAND_NUMS cycled)[k] - 2.
    The schedule never depends on the data, so it is a closed-form position
    list here instead of the serial per-byte counter (a vectorization the
    serial reference formulation hides). Verified against stock bzip2 via a
    crafted randomised stream (tests/test_randomised.py)."""
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    tab = np.asarray(C.RAND_NUMS, dtype=np.int64)
    reps = int(n // int(tab.sum())) + 2  # min entry 50 bounds fires <= n/50+1
    fires = np.cumsum(np.tile(tab, reps)) - 2
    return fires[fires < n]


def _derandomise(data: np.ndarray) -> np.ndarray:
    """Undo legacy bzip2 0.9.0 block randomisation (XOR-1 at the RAND_NUMS
    schedule positions of the post-BWT byte stream). Stock bzip2 decodes
    such blocks; the reference rejects them (BlockDecompressor.hpp:274-277)
    — this is the one place the decoder surface exceeds it."""
    out = data.copy()
    out[rand_fire_positions(out.size)] ^= 1
    return out
