"""The plain reference for a stream of several members: a concatenation of
bzip2 streams, as Wikimedia's multistream dumps and pbzip2 write them.

Each member is one bzip2 stream (``bzip2_ref``): a ``BZh1``-``BZh9``
header, its blocks, its end marker and stream CRC, then zero bits to the
next byte. A member ends at the first end marker after its header, and the
next member starts at the byte after that member's padding; every byte of
the input belongs to a member. Each member is decoded by ``bzip2_ref``'s
block decoder, block CRCs and stream CRC included, and the result is the
concatenation of the members' bytes, as bzip2 1.0.8 and Python's bz2 read
such a file. It imports NumPy and the standard library only.
"""

from __future__ import annotations

import bisect

from . import bzip2_ref as R


def member_spans(stream: bytes) -> list[tuple[int, int]]:
    """(first byte, end byte) of each member; StreamError where the
    input is not a whole number of members."""
    ends = R.find_magic(stream, R.END_MAGIC)
    spans, pos = [], 0
    while pos < len(stream):
        j = bisect.bisect_left(ends, 8 * pos + 32)
        if j == len(ends):
            raise R.StreamError(f"member {len(spans) + 1} (byte {pos}): no end marker")
        end = (ends[j] + 80 + 7) // 8
        if end > len(stream):
            raise R.StreamError(f"member {len(spans) + 1} (byte {pos}): stream CRC cut off")
        spans.append((pos, end))
        pos = end
    if not spans:
        raise R.StreamError("no member")
    return spans


def decode_member(member: bytes) -> bytes:
    """The bytes of one member (one bzip2 stream); StreamError where it is
    malformed or a CRC does not hold."""
    jobs, end = R.block_jobs(member)
    results = [R.decode_block(*job) for job in jobs]
    if R._Bits(member, end + 48, end + 80).read(32) != R.stream_crc(crc for _, crc in results):
        raise R.StreamError("stream CRC mismatch")
    return b"".join(raw for raw, _ in results)


def decode(stream: bytes) -> bytes:
    """The concatenated bytes of every member; StreamError naming the
    first member that does not decode."""
    out = []
    for k, (a, b) in enumerate(member_spans(stream)):
        try:
            out.append(decode_member(stream[a:b]))
        except R.StreamError as e:
            raise R.StreamError(f"member {k + 1} (byte {a}): {e}") from None
    return b"".join(out)


def check_members(stream: bytes, expected: bytes) -> str | None:
    """None where ``stream`` is a concatenation of bzip2 streams that
    decodes to exactly ``expected``; otherwise what is wrong."""
    try:
        got = decode(stream)
    except R.StreamError as e:
        return str(e)
    if len(got) != len(expected):
        return f"decodes to {len(got)} bytes, not {len(expected)}"
    if got != expected:
        return "decoded bytes differ"
    return None
