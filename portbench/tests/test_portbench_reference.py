"""The plain reference against the standard library's bz2."""

import bz2

import numpy as np
import pytest

from portbench.reference import bzip2_ref as R


def _inputs():
    rng = np.random.default_rng(9)
    text = b" ".join(b"word%d" % i for i in rng.zipf(1.3, 40_000) % 3000)
    return [b"", b"x", b"aaaa", b"aaaaa" * 7, b"ab" * 3 + b"\0" * 1000, bytes(range(256)) * 40,
            rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes(), text, text[:99_990] * 3]


@pytest.mark.parametrize("level", [1, 9])
def test_reference_decodes_stock_streams(level):
    for data in _inputs():
        assert R.check_stream(bz2.compress(data, level), data) is None


def test_crc_matches_the_serial_definition():
    rng = np.random.default_rng(2)
    for n in (0, 1, 255, 256, 257, 1000, 70_001):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        c = 0xFFFFFFFF
        for b in data:
            c = ((c << 8) & 0xFFFFFFFF) ^ int(R.TABLE[(c >> 24) ^ b])
        assert R.crc32(data) == c ^ 0xFFFFFFFF


@pytest.mark.parametrize("level", [1, 9])
def test_reference_rejects_broken_streams(level):
    data = _inputs()[-2]
    good = bz2.compress(data, level)
    flipped = bytearray(good)
    flipped[len(good) // 2] ^= 0x10
    wrong_crc = bytearray(good)
    wrong_crc[-3] ^= 0x01  # inside the stream CRC
    assert R.check_stream(bytes(flipped), data) is not None
    assert R.check_stream(bytes(wrong_crc), data) is not None
    assert R.check_stream(good[:-1], data) is not None
    assert R.check_stream(good + b"\0", data) is not None
    assert R.check_stream(good, data[:-1]) is not None
    assert R.check_stream(good, data[:-1] + b"?") is not None
    two = bz2.compress(data[:5000], level) + bz2.compress(data[5000:], level)
    assert R.check_stream(two, data) is not None


def test_reference_uses_processes():
    data = _inputs()[-1]
    with R.BlockPool(2) as pool:
        assert R.check_stream(bz2.compress(data, 1), data, pool) is None
        broken = bytearray(bz2.compress(data, 1))
        broken[len(broken) // 3] ^= 0x04
        assert R.check_stream(bytes(broken), data, pool) is not None
        assert R.check_stream(bz2.compress(data, 9), data, pool) is None
    assert all(p.poll() is not None for p in pool.procs)
