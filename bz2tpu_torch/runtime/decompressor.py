"""Host decompression: the native C core, block-parallel for large
streams, the NumPy oracle without it.

The port's copy of bz2tpu/runtime/decompressor.py, with its imports pointed
into bz2tpu_torch:

- the native C core (bz2tpu_torch/native/_bz2dec.c) decodes any
  conformant stream;
- large streams decode block-parallel: a native bit scan finds the block
  boundaries and a thread pool decodes them concurrently (the C decoder
  releases the GIL); the chain of offsets is verified exactly and any
  mismatch falls back to the sequential decode;
- the NumPy decoder (bz2tpu_torch.oracle.decoder) is the no-extension
  fallback;
- ``StreamDecompressor`` decodes pushed chunks with bounded memory,
  ``decompress_file`` decodes a file through an mmap and a sliding window
  of threads (a chunked sequential push decode where the block chain
  breaks), and ``recover`` salvages the intact blocks of a damaged stream.

All of it is host code and takes no device.
"""

from __future__ import annotations

import bisect
import os
from concurrent.futures import ThreadPoolExecutor

from bz2tpu_torch import native
from bz2tpu_torch.format.crc32 import stream_crc_fold
from bz2tpu_torch.oracle.decoder import Bz2CrcError, Bz2FormatError  # noqa: F401
from bz2tpu_torch.oracle.decoder import decompress as _oracle_decompress

_PARALLEL_THRESHOLD = 1 << 20  # compressed bytes


def _tail_is_memberlike(buf, end_bit: int) -> bool:
    """True if the byte-aligned remainder after a stream's 32-bit CRC (which
    starts at ``end_bit``, the end-marker bit) begins with a (possibly
    truncated) "BZh<1-9>" magic — i.e. the optimistic single-member parallel
    paths must defer to the sequential decoder, which knows the multi-member
    / truncated-magic semantics (native decode_stream, _bz2dec.c:424-500).
    Non-magic junk tails are ignorable everywhere, so False."""
    end_byte = (end_bit + 48 + 32 + 7) // 8
    tail = bytes(buf[end_byte : end_byte + 4])
    if not tail:
        return False
    k = min(len(tail), 3)
    if tail[:k] != b"BZh"[:k]:
        return False
    return len(tail) < 4 or ord("1") <= tail[3] <= ord("9")


def _member_starts(buf, headers) -> tuple[list[tuple[int, int]], list[int]]:
    """Member starts: byte-aligned "BZh<1-9>" magics directly followed by
    a scanned block header (levels can differ per member). False positives
    (a magic-like byte string inside block data coinciding with a spurious
    header match) break the callers' chain checks -> sequential fallback.
    Returns (mstarts [(first header bit, level)], start_bits)."""
    mstarts: list[tuple[int, int]] = []
    for h in headers:
        if h >= 32 and (h - 32) % 8 == 0:
            tag = bytes(buf[(h - 32) // 8 : (h - 32) // 8 + 4])
            if tag[:3] == b"BZh" and ord("1") <= tag[3] <= ord("9"):
                mstarts.append((h, tag[3] - ord("0")))
    return mstarts, [s for s, _ in mstarts]


def _level_at(mstarts, start_bits, off: int) -> int:
    """Level of the member containing bit offset ``off``."""
    return mstarts[bisect.bisect_right(start_bits, off) - 1][1]


def walk_members(buf, headers, ends, block_end):
    """The chain of members of a stream from its scanned block headers and
    end markers, with ``block_end(start bit)`` giving the end bit of the
    block that starts there (None if it has none). Returns (blocks
    [(start bit, end bit, member level)], members [(level, block count,
    end-marker bit)]), or None where the sequential decoder owns the
    semantics.

    The first member starts at bit 32 with a "BZh<1-9>" magic, and every
    member at a byte-aligned magic directly followed by a block header
    (``_member_starts``). Blocks abut: one that ends on a block header goes
    on into the next block of its member; the member's last block must end
    exactly on an end marker; the next member, if any, begins at the very
    next byte boundary after the 32-bit stream CRC. Any irregularity (a
    block with no end, empty members with no block header after their
    magic, junk BETWEEN members, a member-like magic beyond the chain's end
    or a truncated one after it) gives None. Non-magic junk after the last
    member is ignorable (sequential decode_stream parity).
    """
    mstarts, start_bits = _member_starts(buf, headers)
    if not mstarts or mstarts[0][0] != 32:
        return None
    levels = dict(mstarts)
    header_set, end_set = set(headers), set(ends)
    blocks: list[tuple[int, int, int]] = []
    members: list[tuple[int, int, int]] = []
    cur = 32
    while True:
        level, first = levels[cur], len(blocks)
        while True:  # blocks of this member
            end = block_end(cur)
            if end is None or end <= cur:
                return None
            blocks.append((cur, end, level))
            if end not in header_set:
                break
            cur = end
        if end not in end_set:
            return None
        members.append((level, len(blocks) - first, end))
        next_start = ((end + 48 + 32 + 7) // 8) * 8 + 32
        if next_start in levels:
            cur = next_start
            continue
        if start_bits[-1] > end or _tail_is_memberlike(buf, end):
            return None
        return blocks, members


def _decompress_parallel(stream: bytes, verify_crc: bool) -> bytes | None:
    """Block-parallel decode (multi-member aware); None = 'go sequential'.

    Members (concatenated .bz2 streams, e.g. pbzip2 output) chain through
    the same exact verification as blocks (``walk_members``), each block's
    end taken from its decode, and each member's stream CRC must fold. Any
    irregularity defers to the sequential decoder, which owns the
    error/trailing-data semantics.
    """
    if len(stream) < 4 or stream[:3] != b"BZh":
        return None  # sequential path raises the proper format error
    headers, ends = native.scan_blocks(stream)
    if len(headers) < 2 or not ends:
        return None
    if headers[0] != 32:  # first block follows BZh<level> immediately
        return None
    mstarts, start_bits = _member_starts(stream, headers)
    if not mstarts or mstarts[0][0] != 32:
        return None

    def decode_one(off):
        try:
            return native.decode_block_at(
                stream, off, _level_at(mstarts, start_bits, off), verify_crc
            )
        except ValueError:
            # Spurious marker match — the caller falls back to sequential
            # decode, which raises properly if the stream is genuinely bad.
            return None

    workers = min(len(headers), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = dict(zip(headers, pool.map(decode_one, headers)))

    # Walk the block chain by POSITION (blocks abut bit-exactly), not by
    # header index: a spurious marker match lands OFF the chain and is
    # simply never visited, so its (wasted, possibly failed) decode does
    # not force the O(2x) restart-from-scratch the round-4 review flagged.
    # Only an ON-chain failure — a block the stream actually needs that
    # would not decode — defers to the sequential path, which owns the
    # error semantics.
    def decoded_end(off):
        r = results.get(off)
        return None if r is None else r[2]

    chain = walk_members(stream, headers, ends, decoded_end)
    if chain is None:
        return None
    blocks, members = chain
    out = []
    first = 0
    for member_no, (_, n_blocks, end_bit) in enumerate(members):
        s_crc = 0
        for start, _, _ in blocks[first : first + n_blocks]:
            data, crc, _ = results[start]
            out.append(data)
            s_crc = stream_crc_fold(s_crc, crc)
        first += n_blocks
        pos = end_bit + 48
        if pos + 32 > len(stream) * 8:
            raise Bz2FormatError("truncated stream CRC")
        if verify_crc:
            stored = _read_bits_at(stream, pos, 32)
            if stored != s_crc:
                if member_no > 0:
                    # Sequential semantics for a bad LATER member are
                    # rollback-to-boundary, not raise — defer to it.
                    return None
                raise Bz2CrcError(
                    f"stream CRC mismatch: {stored:#x} != {s_crc:#x}"
                )
    return b"".join(out)


def _read_bits_at(buf, pos: int, nbits: int) -> int:
    v = 0
    for b in range(nbits):
        v = (v << 1) | ((buf[(pos + b) >> 3] >> (7 - ((pos + b) & 7))) & 1)
    return v



def recover(stream: bytes, verify_crc: bool = True) -> tuple[bytes, int, int]:
    """Salvage intact blocks from a damaged .bz2 stream (bzip2recover
    analog, built on the same marker scan as parallel decode).

    Every 48-bit block-marker match is tried as an independent block;
    blocks that decode (and pass their own CRC, unless verify_crc=False)
    are concatenated in stream order. Returns (data, blocks_recovered,
    candidates_seen). Requires the native core.
    """
    if not native.HAVE_NATIVE:
        raise RuntimeError("recovery requires the native extension")
    stream = bytes(stream)
    headers, _ = native.scan_blocks(stream)
    # Be liberal: decode with the largest block buffer regardless of what a
    # (possibly damaged) header claims — level only bounds the buffer.
    level = 9
    pieces = []
    ok = 0
    for off in headers:
        try:
            data, _, _ = native.decode_block_at(stream, off, level, verify_crc)
        except ValueError:
            continue
        pieces.append(data)
        ok += 1
    return b"".join(pieces), ok, len(headers)


def decompress_file(
    in_path: str,
    out_path: str,
    verify_crc: bool = True,
    window: int = 16,
) -> None:
    """Decode a .bz2 file to disk with bounded memory.

    The input is mmapped (never copied through the slow host heap); blocks
    decode in a thread pool through the GIL-releasing native core with at
    most `window` decoded blocks in flight, and bytes stream to the output
    as each block completes in order. Streams the optimistic block scan
    cannot chain (multi-member, marker false positives) fall back to a
    sequential push decode that is STILL bounded-memory (chunked
    StreamDecompressor; only without the native core does the pure-NumPy
    whole-buffer oracle run). Output appears atomically (temp + rename).
    """
    import mmap

    from bz2tpu_torch.utils.atomic import atomic_output

    with open(in_path, "rb") as fin, atomic_output(out_path) as fout:
        if os.fstat(fin.fileno()).st_size == 0:
            raise Bz2FormatError("empty input")
        mm = mmap.mmap(fin.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            ok = native.HAVE_NATIVE and _stream_file_parallel(mm, fout, verify_crc, window)
            if not ok:
                # Discard any partial optimistic output, decode sequentially.
                fout.seek(0)
                fout.truncate()
                if native.HAVE_NATIVE:
                    _stream_file_sequential(mm, fout, verify_crc)
                else:
                    fout.write(decompress(mm[:], verify_crc=verify_crc))
        finally:
            mm.close()


_SEQ_CHUNK = 8 << 20  # compressed bytes pushed per StreamDecompressor call


def _stream_file_sequential(mm, fout, verify_crc: bool) -> None:
    """Bounded-memory sequential fallback, native decode_stream parity.

    Chunked push decode through StreamDecompressor, chaining multi-member
    streams. Trailing-data semantics match _bz2dec.c:424-500 (measured
    stdlib-bz2 parity there): junk after >= 1 complete member is ignored,
    a member that ERRORS mid-decode after >= 1 complete member is rolled
    back to the member boundary (fout truncate), and TRUNCATION of a
    member whose header validated raises.
    """
    total = len(mm)
    pos = 0
    members_done = 0
    pending = b""  # unused_data carried past a member boundary
    while True:
        dec = StreamDecompressor(verify_crc)
        member_start = fout.tell()
        try:
            if pending:
                fout.write(dec.decompress(pending))
                pending = b""
            while not dec.eof and pos < total:
                chunk = mm[pos : pos + _SEQ_CHUNK]
                pos += len(chunk)
                fout.write(dec.decompress(chunk))
            if not dec.eof:
                raise Bz2FormatError("truncated stream")
        except (Bz2FormatError, Bz2CrcError) as e:
            if members_done > 0 and not str(e).startswith("truncated"):
                fout.seek(member_start)
                fout.truncate()
                return
            raise
        members_done += 1
        # Byte-aligned remainder after the end marker: empty -> done; a
        # valid "BZh<1-9>" -> next member; a proper PREFIX of the magic at
        # EOF -> truncated; anything else -> ignored junk tail.
        head = dec.unused_data[:4]
        if len(head) < 4 and pos < total:
            head += mm[pos : pos + 4 - len(head)]
        if not head:
            return
        k = min(len(head), 3)
        if head[:k] != b"BZh"[:k] or (
            len(head) >= 4 and not (ord("1") <= head[3] <= ord("9"))
        ):
            return
        if len(head) < 4:
            raise Bz2FormatError("truncated stream")
        pending = dec.unused_data


def _stream_file_parallel(mm, fout, verify_crc: bool, window: int) -> bool:
    """Ordered sliding-window block decode to a file; False = use fallback.

    Multi-member aware with the same chain rules as _decompress_parallel
    (members verify per-member stream CRCs and must abut byte-exactly).
    NOTE: the truncated output left behind on False is discarded by the
    caller's temp-file handling (decode restarts via the fallback path)."""
    if len(mm) < 4 or mm[:3] != b"BZh" or not (ord("1") <= mm[3] <= ord("9")):
        return False
    headers, ends = native.scan_blocks(mm)
    if not headers or not ends or headers[0] != 32:
        return False
    ends_set = set(ends)
    n = len(headers)
    mstarts, start_bits = _member_starts(mm, headers)
    if not mstarts or mstarts[0][0] != 32:
        return False
    starts_set = set(start_bits)

    def decode_one(off):
        try:
            return native.decode_block_at(
                mm, off, _level_at(mstarts, start_bits, off), verify_crc
            )
        except ValueError:
            return None

    s_crc = 0
    member_idx = 0
    with ThreadPoolExecutor(max_workers=min(window, os.cpu_count() or 1)) as pool:
        futures = []
        next_submit = 0
        for done in range(n):
            while next_submit < n and len(futures) < window:
                futures.append(pool.submit(decode_one, headers[next_submit]))
                next_submit += 1
            res = futures.pop(0).result()
            if res is None:
                return False
            data, crc, end_bit = res
            s_crc = stream_crc_fold(s_crc, crc)
            if done + 1 < n and end_bit == headers[done + 1]:
                fout.write(data)
                continue  # next block of the same member
            # Member boundary: end marker + stream CRC, next member abuts.
            if end_bit not in ends_set:
                return False
            pos_crc = end_bit + 48
            if pos_crc + 32 > len(mm) * 8:
                raise Bz2FormatError("truncated stream CRC")
            if verify_crc:
                stored = _read_bits_at(mm, pos_crc, 32)
                if stored != s_crc:
                    if member_idx > 0:
                        return False  # sequential owns later-member rollback
                    raise Bz2CrcError(
                        f"stream CRC mismatch: {stored:#x} != {s_crc:#x}"
                    )
            fout.write(data)
            s_crc = 0
            member_idx += 1
            if done + 1 < n:
                nxt = ((pos_crc + 32 + 7) // 8) * 8 + 32
                if headers[done + 1] != nxt or nxt not in starts_set:
                    return False
            elif _tail_is_memberlike(mm, end_bit):
                return False  # defer to the sequential member-chainer
    return True


class StreamDecompressor:
    """Incremental push-style decoder (stdlib bz2.BZ2Decompressor parity).

    The reference's InputStream is pull-based and needs the whole stream
    behind it (include/InputStream.hpp:51-95); this accepts arbitrary
    chunks, emits every block that is complete so far, and keeps bounded
    memory by discarding consumed compressed bytes. One stream per
    instance: after ``eof``, the remaining bytes are in ``unused_data``
    and further ``decompress()`` calls raise EOFError (stdlib parity).

    Requires the native core (the one-shot paths work without it).
    """

    def __init__(self, verify_crc: bool = True) -> None:
        if not native.HAVE_NATIVE:
            raise RuntimeError("StreamDecompressor requires the native extension")
        self._verify = verify_crc
        self._buf = bytearray()
        self._bit = 0  # absolute bit position within _buf
        self._level = None
        self._s_crc = 0
        self.eof = False
        self.unused_data = b""
        self.needs_input = True

    def _read_bits(self, pos: int, n: int) -> int | None:
        if pos + n > len(self._buf) * 8:
            return None
        v = 0
        for k in range(n):
            p = pos + k
            v = (v << 1) | ((self._buf[p >> 3] >> (7 - (p & 7))) & 1)
        return v

    def decompress(self, data: bytes) -> bytes:
        if self.eof:
            raise EOFError("End of stream already reached")
        self._buf += data
        out: list[bytes] = []
        while True:
            if self._level is None:
                if len(self._buf) < 4:
                    break
                if bytes(self._buf[:3]) != b"BZh" or not (
                    ord("1") <= self._buf[3] <= ord("9")
                ):
                    raise Bz2FormatError("bad stream magic (expected BZh)")
                self._level = self._buf[3] - ord("0")
                self._bit = 32
            marker = self._read_bits(self._bit, 48)
            if marker is None:
                break
            if marker == 0x177245385090:
                stored = self._read_bits(self._bit + 48, 32)
                if stored is None:
                    break
                if self._verify and stored != self._s_crc:
                    raise Bz2CrcError(
                        f"stream CRC mismatch: {stored:#x} != {self._s_crc:#x}"
                    )
                end_byte = (self._bit + 80 + 7) // 8
                self.eof = True
                self.needs_input = False
                self.unused_data = bytes(self._buf[end_byte:])
                break
            if marker != 0x314159265359:
                raise Bz2FormatError(f"bad block marker {marker:#x}")
            try:
                block, crc, end_bit = native.decode_block_at(
                    bytes(self._buf), self._bit, self._level, self._verify
                )
            except native.CrcError as e:
                raise Bz2CrcError(str(e)) from None
            except ValueError as e:
                if str(e).startswith("truncated"):
                    break  # need more input
                raise Bz2FormatError(str(e)) from None
            out.append(block)
            self._s_crc = stream_crc_fold(self._s_crc, crc)
            self._bit = end_bit
            # Bounded memory: drop consumed whole bytes.
            drop = self._bit >> 3
            if drop > (1 << 16):
                del self._buf[:drop]
                self._bit -= drop * 8
        self.needs_input = not self.eof
        return b"".join(out)


def decompress(stream: bytes, verify_crc: bool = True) -> bytes:
    stream = bytes(stream)
    if native.HAVE_NATIVE:
        try:
            if len(stream) >= _PARALLEL_THRESHOLD:
                out = _decompress_parallel(stream, verify_crc)
                if out is not None:
                    return out
            return native.decode_stream(stream, verify_crc)
        except native.CrcError as e:
            raise Bz2CrcError(str(e)) from None
        except Bz2CrcError:
            raise
        except ValueError as e:
            raise Bz2FormatError(str(e)) from None
    return _oracle_decompress(stream, verify_crc=verify_crc)
