"""The port's block scan (bz2tpu_torch.native.scan_blocks).

It searches byte-wise behind a two-byte filter; it must give exactly the
lists of a bit-serial scan, which these tests write in NumPy and which
bz2tpu.native.scan_blocks still is.
"""

import bz2 as stdlib_bz2

import numpy as np
import pytest

from bz2tpu import native
from bz2tpu_torch import native as port_native

from conftest import make_corpus

pytestmark = pytest.mark.skipif(not port_native.HAVE_NATIVE, reason="the port's extension not built")

BLOCK_MARKER = 0x314159265359
END_MARKER = 0x177245385090


def _scan_ref(buf: bytes) -> tuple[list[int], list[int]]:
    """Every bit offset whose next 48 bits are a block or an end marker."""
    bits = np.unpackbits(np.frombuffer(buf, np.uint8)).astype(np.int64)
    n = bits.size - 47
    if n <= 0:
        return [], []
    win = np.zeros(n, np.int64)
    for k in range(48):
        win = (win << 1) | bits[k : k + n]
    return np.flatnonzero(win == BLOCK_MARKER).tolist(), np.flatnonzero(win == END_MARKER).tolist()


def _plant(buf: bytes, plants: list[tuple[int, int]]) -> bytes:
    """buf with each (bit offset, marker) written over it in turn, cut at
    the buffer's end."""
    bits = np.unpackbits(np.frombuffer(buf, np.uint8))
    for pos, marker in plants:
        mbits = np.array([(marker >> (47 - k)) & 1 for k in range(48)], np.uint8)
        end = min(pos + 48, bits.size)
        bits[pos:end] = mbits[: end - pos]
    return np.packbits(bits).tobytes()


def _scan_case(case: str) -> bytes:
    rng = np.random.default_rng(1700 + sum(map(ord, case)))
    noise = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
    kind, _, arg = case.partition("-")
    if kind in ("block", "end"):  # one marker at bit `arg` of a byte, mid-buffer
        marker = BLOCK_MARKER if kind == "block" else END_MARKER
        return _plant(noise(257), [(8 * 100 + int(arg), marker)])
    if kind == "adjacent":  # block, end, block back to back from bit `arg`
        p = 8 * 40 + int(arg)
        return _plant(noise(200), [(p, BLOCK_MARKER), (p + 48, END_MARKER), (p + 96, BLOCK_MARKER)])
    if kind == "overlapping":  # markers written over each other's tails
        p = 8 * 30 + int(arg)
        return _plant(noise(200), [(p, BLOCK_MARKER), (p + 13, BLOCK_MARKER), (p + 40, END_MARKER),
                                   (p + 47, END_MARKER), (p + 90, BLOCK_MARKER)])
    if kind == "last":  # a marker at the last bit it fits, in buffers of 64-71 bytes
        n = 64 + int(arg)
        return _plant(noise(n), [(8 * n - 48, END_MARKER), (8 * n - 48 - 77, BLOCK_MARKER)])
    if kind == "short":  # the same one bit past it: its last bit falls off
        n = 64 + int(arg)
        return _plant(noise(n), [(8 * n - 47, END_MARKER), (8 * n - 47 - 77, BLOCK_MARKER)])
    if kind == "tiny":  # 0-7 bytes, a marker at every offset it fits
        n = int(arg)
        if n < 6:
            return noise(n)
        return _plant(noise(n), [(8 * n - 48 - s, BLOCK_MARKER if s % 2 else END_MARKER) for s in range(8 * n - 47)])
    if kind == "dense":  # 400 markers at random offsets in 2 KiB
        offs = rng.integers(0, 8 * 2048 - 48, 400)
        return _plant(noise(2048), [(int(p), (BLOCK_MARKER, END_MARKER)[i % 2]) for i, p in enumerate(offs)])
    if kind == "stdlib":  # a real stream at level `arg`
        return stdlib_bz2.compress(make_corpus(rng, "text", 250_000), int(arg))
    if kind == "port":  # the port's own stream
        import bz2tpu_torch

        return bz2tpu_torch.compress(make_corpus(rng, "text", 250_000), level=1, device="cpu")
    raise ValueError(case)


SCAN_CASES = (
    [f"{k}-{s}" for k in ("block", "end", "adjacent", "overlapping") for s in range(8)]
    + [f"{k}-{s}" for k in ("last", "short") for s in range(8)]
    + [f"tiny-{n}" for n in range(8)]
    + ["dense", "stdlib-1", "stdlib-2", "stdlib-9", "port-1"]
)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_port_scan_blocks_matches_bit_serial(case):
    buf = _scan_case(case)
    want = _scan_ref(buf)
    assert port_native.scan_blocks(buf) == want
    if native.HAVE_NATIVE:
        assert native.scan_blocks(buf) == want  # the bit-serial C scan
    if case.split("-")[0] in ("block", "end", "last"):
        assert want[0] or want[1]  # the planted marker is there to find


# --------------------------------------------------------------------------
# The resumable split: rle1_split(data, level, start, max_blocks) from a
# block boundary gives the blocks one pass gives there.


def _split_input(level: int, kind: str) -> np.ndarray:
    """About 3.5 blocks of ``kind`` at ``level`` (2.2 of zeros, whose
    blocks hold 51 raw bytes an RLE1 byte)."""
    rng = np.random.default_rng([1750, level, len(kind)])
    cap = level * 100_000
    if kind == "text":
        return np.frombuffer(make_corpus(rng, "text", 7 * cap // 2), np.uint8)
    if kind == "random":
        return rng.integers(0, 256, 7 * cap // 2, dtype=np.uint8)
    if kind == "zeros":
        return np.zeros(int(2.2 * 51 * cap), np.uint8)
    return _runs_across_cuts(rng, level * 100_000 - 19)


def _runs_across_cuts(rng: np.random.Generator, cap: int) -> np.ndarray:
    """Runs of 4-600 equal bytes, each after 0-40 literals, and three blocks
    that each end inside a run: literals up to one RLE1 byte short of
    ``cap``, then a run of 600 whose first 255-byte piece crosses it, so
    the next block starts 345 bytes before the run's end."""
    counts = []
    out = 0  # RLE1 bytes in the block so far
    full = 0
    while full < 3 or out < cap // 2:
        if full < 3 and cap - out <= 100:
            counts += [1] * (cap - out - 1) + [600]
            full, out = full + 1, 10  # the run's last two pieces, 255 and 90 bytes
            continue
        lit, run = int(rng.integers(0, 41)), int(rng.integers(4, 601))
        counts += [1] * lit + [run]
        out += lit + 5 * (run // 255) + (5 if run % 255 >= 4 else run % 255)
    # Each value differs from the one before, so no literal joins a run.
    vals = np.cumsum(rng.integers(1, 256, len(counts))) % 256
    return np.repeat(vals.astype(np.uint8), counts)


def _one_pass_cuts(blocks) -> list[int]:
    return np.cumsum([0] + [raw for _, raw, _ in blocks]).tolist()


@pytest.mark.parametrize("kind", ["text", "runs", "random", "zeros"])
@pytest.mark.parametrize("level", [1, 2, 9])
def test_resumed_split_matches_one_pass(level, kind):
    from bz2tpu_torch.runtime.compressor import BlockRange, split_blocks

    data = _split_input(level, kind)
    whole = port_native.rle1_split(data, level)
    cuts = _one_pass_cuts(whole)
    assert len(whole) >= 2 and cuts[-1] == data.size
    if kind == "runs":  # every block after the first starts inside a run
        assert all(data[c - 1] == data[c] for c in cuts[1:-1]) and len(whole) == 4
    for j, start in enumerate(cuts[:-1]):
        for most in (1, 2, 3):
            want = whole[j : j + most]
            assert port_native.rle1_split(data, level, start, most) == want, (start, most)
            got = split_blocks(BlockRange(data, start, most), level)
            assert [(bytes(b.data), b.raw_length, b.crc) for b in got] == want, (start, most)
    assert port_native.rle1_split(data, level, start=cuts[1]) == whole[1:]
    assert port_native.rle1_split(data, level, data.size, 1) == []


@pytest.mark.parametrize("kind", ["text", "runs", "random", "zeros"])
@pytest.mark.parametrize("level", [1, 2])
def test_numpy_resumed_split_matches_one_pass(level, kind, monkeypatch):
    """Without the C core split_blocks resumes on the oracle, given a
    window of the input that max_blocks blocks cannot outgrow."""
    from bz2tpu_torch.oracle.encoder import rle1_split
    from bz2tpu_torch.runtime import compressor

    data = _split_input(level, kind)
    whole = rle1_split(data, level)
    cuts = _one_pass_cuts([(None, b.raw_length, None) for b in whole])
    monkeypatch.setattr(port_native, "HAVE_NATIVE", False)
    for j, start in enumerate(cuts[:-1]):
        for most in (1, 2, 3):
            got = compressor.split_blocks(compressor.BlockRange(data, start, most), level)
            assert len(got) == len(whole[j : j + most]), (start, most)
            for g, w in zip(got, whole[j : j + most]):
                assert (g.raw_length, g.crc) == (w.raw_length, w.crc), (start, most)
                np.testing.assert_array_equal(g.data, w.data)


@pytest.mark.parametrize("bad", [{"start": -1}, {"start": 11}, {"max_blocks": -1}])
def test_resumed_split_refuses_bad_ranges(bad):
    with pytest.raises(ValueError, match="start must be"):
        port_native.rle1_split(b"0123456789", 1, **bad)
