"""The plain reference for several members (reference/members_ref.py)
against the standard library's bz2, which reads a concatenation of bzip2
streams as the concatenation of their contents."""

import bz2

import numpy as np
import pytest

from portbench.reference import members_ref as M


def _members(seed: int) -> list[tuple[bytes, bytes]]:
    """Seeded members of mixed levels, an empty one among them, as
    ``(member, what it decodes to)``."""
    rng = np.random.default_rng(seed)
    text = b" ".join(b"word%d" % i for i in rng.zipf(1.3, 40_000) % 3000)
    pieces = [text[: int(n)] for n in rng.integers(1, 120_000, 4)] + [b""]
    levels = rng.integers(1, 10, len(pieces))
    return [(bz2.compress(p, int(lv)), p) for p, lv in zip(pieces, levels)]


@pytest.mark.parametrize("seed", [1, 2])
def test_members_reference_decodes_concatenated_streams(seed):
    members = _members(seed)
    stream = b"".join(m for m, _ in members)
    want = b"".join(p for _, p in members)
    assert bz2.decompress(stream) == want
    assert M.decode(stream) == want and M.check_members(stream, want) is None
    assert len(M.member_spans(stream)) == len(members)
    assert M.check_members(stream, want[:-1]) is not None
    # One member alone is one bzip2 stream.
    assert M.decode(members[0][0]) == members[0][1]


def test_members_reference_names_the_broken_member():
    members = [m for m, _ in _members(3)]
    second = bytearray(members[1])
    second[-3] ^= 0x01  # inside the second member's stream CRC
    broken = members[0] + bytes(second) + b"".join(members[2:])
    why = M.check_members(broken, b"")
    assert why.startswith(f"member 2 (byte {len(members[0])}): ") and "stream CRC mismatch" in why
    # Bytes that are no member: junk between members, a cut member at the end.
    assert M.check_members(members[0] + b"junk" + members[1], b"").startswith("member 2")
    assert M.check_members(members[0] + members[1][:-1], b"").startswith("member 2")
    assert M.check_members(b"", b"") == "no member"
