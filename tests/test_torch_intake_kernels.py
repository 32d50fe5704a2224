"""The device intake's range CRCs (crc_ranges, ops/crc_cuda.py) and block
cuts (block_cuts, ops/rle1_cuda.py) on the CPU, where each wrapper takes
its plain torch version:

  * ops/crc.crc32_ranges and crc32_ranges_ref against
    bz2tpu.ops.crc.crc32_ranges on JAX-CPU and the serial CRC of
    format/crc32, on chunks of odd lengths with empty ranges, ranges that
    end at N, single bytes, overlapping and unordered ranges, B = 1 and 16;
  * ops/rle1.block_cuts and block_cuts_ref against
    bz2tpu.ops.rle1.block_cuts on empty input, one under-full block, cuts
    that land exactly on the capacity or overshoot it, runs and random
    data;
  * crc_ranges' shift maps (ops/crc_cuda.shift_maps, map k moving a state
    past 2^k zero bytes as nibble tables) and the byte table the kernel
    derives from them against the polynomial arithmetic they stand for,
    shifts composed from them against byte steps, and the first design's
    x^(2^k) table that tools/probe_intake_kernels.cu carries;
  * the premise of block_cuts' windows on RLE1's sums: every cut lands in
    the window its warp loads;
  * each wrapper's argument checks, the CPU dispatch (no launch counted)
    and the refusal of any other device;
  * ops/intake.device_intake's step laps, which leave its results as
    they are.

Every comparison is exact (integer codec, tolerance 0). The kernels
themselves run in tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bz2tpu.ops import crc as jax_crc  # noqa: E402
from bz2tpu.ops import rle1 as jax_rle1  # noqa: E402
from bz2tpu_torch.format import constants as C  # noqa: E402
from bz2tpu_torch.format.crc32 import crc32_serial  # noqa: E402
from bz2tpu_torch.ops import crc, crc_cuda, intake, rle1, rle1_cuda  # noqa: E402

from conftest import make_corpus  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "bz2tpu_torch" / "csrc"
INT32_MAX = 2**31 - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs in several
    worker processes, and torch's default of one thread a core in each
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranges(rng, n: int, b: int) -> tuple[np.ndarray, np.ndarray]:
    """b ranges of [0, n]: the whole chunk, an empty one at n, a single
    byte, one that ends at n, an empty one inside, then random ones
    (overlapping, in no order, some empty)."""
    fixed = [(0, n), (n, n), (n // 2, n // 2 + 1), (n - 1, n), (n // 3, n // 3)]
    a, c = rng.integers(0, n + 1, b), rng.integers(0, n + 1, b)
    starts, ends = np.minimum(a, c), np.maximum(a, c)
    for i, (s, e) in enumerate(fixed[:b]):
        starts[i], ends[i] = s, e
    if b > 8:
        starts[7], ends[7] = starts[6], starts[6]  # empty, where a range starts
    return starts.astype(np.int32), ends.astype(np.int32)


# --- crc_ranges ------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4097, 3 * 4096 + 1, 1 << 14])
@pytest.mark.parametrize("b", [1, 16])
def test_crc32_ranges_match_jax_and_the_serial_crc(n, b):
    rng = np.random.default_rng(900 + n + b)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    starts, ends = _ranges(rng, n, b)
    want = [crc32_serial(data[s:e]) for s, e in zip(starts, ends)]
    args = (torch.from_numpy(data), torch.from_numpy(starts), torch.from_numpy(ends))
    assert crc.crc32_ranges_ref(*args).tolist() == want
    got = crc.crc32_ranges(*args)
    assert got.dtype == torch.int64 and got.tolist() == want
    jax_got = jax_crc.crc32_ranges(jnp.asarray(data), jnp.asarray(starts), jnp.asarray(ends))
    assert np.asarray(jax_got).astype(np.int64).tolist() == want


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_crc32_ranges_take_either_index_dtype_and_lane_count(dtype):
    rng = np.random.default_rng(910)
    n = 1 << 15
    data = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8))
    starts, ends = _ranges(rng, n, 16)
    want = [crc32_serial(data.numpy()[s:e]) for s, e in zip(starts, ends)]
    s, e = torch.from_numpy(starts).to(dtype), torch.from_numpy(ends).to(dtype)
    for lanes in (1, 64, crc.DEFAULT_LANES):
        assert crc.crc32_ranges(data, s, e, lanes=lanes).tolist() == want


def test_crc32_ranges_on_the_intake_cuts_of_a_chunk():
    # The ranges device_intake hands the CRC: each block's raw bytes, and
    # the unused slots' empty ranges at the final cut.
    rng = np.random.default_rng(920)
    n, N = 200_000, intake.chunk_capacity(1, 4)
    padded = np.zeros(N, np.uint8)
    padded[:n] = np.frombuffer(make_corpus(rng, "text", n), np.uint8)
    enc = rle1.rle1_encode(torch.from_numpy(padded), n)
    _, raw_cuts, n_blocks = rle1.block_cuts(enc["piece_out_cum"], enc["piece_raw_cum"], enc["n_pieces"],
                                           cap=C.block_capacity(1), max_blocks=4)
    assert int(n_blocks) == 3  # the fourth slot repeats the final cut
    starts = torch.cat([torch.zeros(1, dtype=torch.int32), raw_cuts[:-1]])
    want = [crc32_serial(padded[s:e]) for s, e in zip(starts.tolist(), raw_cuts.tolist())]
    assert crc.crc32_ranges(torch.from_numpy(padded), starts, raw_cuts).tolist() == want
    assert want[-1] == 0


def _poly_mulmod(a: int, b: int) -> int:
    p = 0
    for i in range(32):
        if b >> i & 1:
            p ^= a << i
    for i in range(62, 31, -1):
        if p >> i & 1:
            p ^= 0x104C11DB7 << (i - 32)
    return p


def _x_to_the_powers_of_two() -> list[int]:
    """x^(2^k) mod P for k = 0..32 by repeated squaring."""
    want, v = [], 2  # x
    for _ in range(33):
        want.append(v)
        v = _poly_mulmod(v, v)
    return want


def test_crc_kernel_table_is_x_to_the_powers_of_two_mod_p():
    # The kernel's shift maps: map k multiplies a state by x^(8 2^k) =
    # x^(2^(k + 3)) mod P, nibble j of the state holding v mapping to
    # (v x^(4 j)) x^(2^(k + 3)) mod P; k runs to 31, and x^(2^32) = x
    # mod P, so the maps cover every byte count below 2^32 (the exponent's
    # cycle); x^8 moves a state past one zero byte as the byte table does.
    maps = crc_cuda.shift_maps()
    assert maps.shape == (32, 8, 16) and maps.dtype == np.uint32
    xp = _x_to_the_powers_of_two()
    assert xp[32] == xp[0]
    for k in range(32):
        mult = xp[(k + 3) % 32]
        for j in range(8):
            assert maps[k, j].tolist() == [_poly_mulmod(v << (4 * j), mult) for v in range(16)], (k, j)
    state = 0x80000001
    stepped = ((state << 8) & 0xFFFFFFFF) ^ int(crc.CRC32_TABLE[state >> 24])
    assert _poly_mulmod(state, xp[3]) == stepped
    # Map 2 (four zero bytes) is b x^32 on a byte b: the byte table, which
    # the kernel builds from its polynomial constant; its carry-less
    # products reduce their high word by map 2 too.
    byte_table = [int(maps[2, 0, b & 15] ^ maps[2, 1, b >> 4]) for b in range(256)]
    assert byte_table == crc.CRC32_TABLE.tolist()
    src = (CSRC / "crc_ranges.cu").read_text()
    assert int(re.search(r"constexpr u32 kPoly = (0x[0-9A-Fa-f]{8})u;", src).group(1), 16) == 0x04C11DB7
    assert "return lo ^ apply_map(maps + 2 * kMapWords, hi);" in src
    for a, b in ((0x80000001, 0x04C11DB7), (0xFFFFFFFF, 0x12345678), (xp[9], xp[17])):
        prod = 0
        for i in range(32):
            if b >> i & 1:
                prod ^= a << i
        lo, hi = prod & 0xFFFFFFFF, prod >> 32
        assert lo ^ int(np.bitwise_xor.reduce([maps[2, j, (hi >> (4 * j)) & 15] for j in range(8)])) == \
            _poly_mulmod(a, b)
    # Its tile: 64 bytes a thread, 2^kLogThreads threads.
    log_seg = int(re.search(r"constexpr int kLogSeg = (\d+);", src).group(1))
    log_threads = int(re.search(r"constexpr int kLogThreads = (\d+);", src).group(1))
    assert crc_cuda.TILE_BYTES == 1 << (log_seg + log_threads)
    # The first design's table, which the probe of tools/ still carries.
    probe = (CSRC.parent.parent / "tools" / "probe_intake_kernels.cu").read_text()
    body = re.search(r"kXPow2\[32\] = \{(.*?)\};", probe, re.S).group(1)
    assert [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)] == xp[:32]


def test_crc_kernel_shifts_compose_like_the_byte_steps():
    # A state moved past n zero bytes by one map a set bit of n (the
    # kernel's shift_bytes) equals the state stepped through n zero bytes,
    # and a range's CRC follows from its endpoints' states as the kernel
    # combines them.
    maps = crc_cuda.shift_maps()

    def shift(v: int, n: int) -> int:
        k = 0
        while n:
            if n & 1:
                v = int(np.bitwise_xor.reduce([maps[k, j, (v >> (4 * j)) & 15] for j in range(8)]))
            n, k = n >> 1, k + 1
        return v

    def step(v: int, data) -> int:
        for b in data:
            v = ((v << 8) & 0xFFFFFFFF) ^ int(crc.CRC32_TABLE[(v >> 24) ^ int(b)])
        return v

    rng = np.random.default_rng(905)
    for n in (0, 1, 63, 64, 65, 1000, 4097):
        v = int(rng.integers(0, 2**32))
        assert shift(v, n) == step(v, bytes(n))
    data = rng.integers(0, 256, 3000, dtype=np.uint8)
    for s, e in ((0, 3000), (17, 2999), (1000, 1000), (64, 128)):
        moved = shift(step(0, data[:s]) ^ 0xFFFFFFFF, e - s)
        assert moved ^ step(0, data[:e]) ^ 0xFFFFFFFF == crc32_serial(data[s:e])


# --- block_cuts --------------------------------------------------------------------


def _cuts_all(poc: np.ndarray, prc: np.ndarray, n_pieces: int, cap: int, max_blocks: int):
    """block_cuts_ref, block_cuts and bz2tpu's on the same sums: all equal."""
    args = (torch.from_numpy(poc.astype(np.int32)), torch.from_numpy(prc.astype(np.int32)),
            torch.tensor(n_pieces, dtype=torch.int32))
    ref = rle1.block_cuts_ref(*args, cap=cap, max_blocks=max_blocks)
    got = rle1.block_cuts(*args, cap=cap, max_blocks=max_blocks)
    want = jax_rle1.block_cuts(jnp.asarray(poc, jnp.int32), jnp.asarray(prc, jnp.int32), jnp.int32(n_pieces),
                               cap=cap, max_blocks=max_blocks)
    for r, g, w in zip(ref, got, want):
        assert r.dtype == g.dtype == torch.int32
        np.testing.assert_array_equal(r.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [g.numpy() for g in got]


@pytest.mark.parametrize("kind,n", [("text", 250_000), ("runs", 180_000), ("random", 90_000), ("zeros", 60_000),
                                    ("text", 300), ("random", 0)])
@pytest.mark.parametrize("max_blocks", [1, 3, 8])
def test_block_cuts_match_jax_on_rle1_pieces(kind, n, max_blocks):
    rng = np.random.default_rng(930 + n + max_blocks)
    N = 1 << 18
    padded = rng.integers(0, 256, N, dtype=np.uint8)  # bytes past n are ignored
    if n:
        padded[:n] = np.frombuffer(make_corpus(rng, kind, n), np.uint8)
    enc = rle1.rle1_encode(torch.from_numpy(padded), n)
    out_cuts, raw_cuts, n_blocks = _cuts_all(enc["piece_out_cum"].numpy(), enc["piece_raw_cum"].numpy(),
                                             int(enc["n_pieces"]), C.block_capacity(1), max_blocks)
    if n == 0:
        assert n_blocks == 0 and (out_cuts == 0).all() and (raw_cuts == 0).all()
    # Unused slots repeat the final cut; the last live cut covers the input
    # unless every slot is taken.
    assert (out_cuts[n_blocks:] == out_cuts[max(n_blocks - 1, 0)]).all()
    if n_blocks < max_blocks:
        assert raw_cuts[-1] == n


def test_block_cuts_of_one_under_full_block():
    rng = np.random.default_rng(940)
    n = 5_000
    padded = np.zeros(1 << 14, np.uint8)
    padded[:n] = np.frombuffer(make_corpus(rng, "text", n), np.uint8)
    enc = rle1.rle1_encode(torch.from_numpy(padded), n)
    out_cuts, raw_cuts, n_blocks = _cuts_all(enc["piece_out_cum"].numpy(), enc["piece_raw_cum"].numpy(),
                                             int(enc["n_pieces"]), C.block_capacity(1), 4)
    assert n_blocks == 1 and (raw_cuts == n).all() and (out_cuts == int(enc["out_len"])).all()


@pytest.mark.parametrize("cap", [1, 25, 100, 101, 399, 400])
def test_block_cuts_land_on_the_capacity_or_overshoot_it(cap):
    # 400 one-byte pieces: every cut lands exactly on a multiple of cap.
    n = 400
    poc = np.full(1 << 10, INT32_MAX, np.int64)
    prc = poc.copy()
    poc[:n] = np.arange(1, n + 1)
    prc[:n] = np.arange(1, n + 1)
    out_cuts, _, n_blocks = _cuts_all(poc, prc, n, cap, 8)
    assert out_cuts[0] == min(cap, n)
    # 100 runs of four to 255 bytes (five output bytes each): a cut
    # overshoots the capacity by up to 4 bytes.
    poc[:100] = 5 * np.arange(1, 101)
    prc[:100] = np.cumsum(np.random.default_rng(950 + cap).integers(4, 256, 100))
    poc[100:] = prc[100:] = INT32_MAX
    out_cuts, raw_cuts, n_blocks = _cuts_all(poc, prc, 100, cap, 8)
    assert 0 <= out_cuts[0] - min(cap, 500) <= 4


def test_block_cuts_clamp_to_the_last_piece():
    # A capacity past the chunk's output: the search lands on the padding
    # and the cut clamps to the last piece; the full array (n_pieces = N)
    # finds no entry and clamps the same way.
    poc = np.array([3, 7, 12, INT32_MAX, INT32_MAX], np.int64)
    prc = np.array([3, 9, 20, INT32_MAX, INT32_MAX], np.int64)
    out_cuts, raw_cuts, n_blocks = _cuts_all(poc, prc, 3, 1000, 2)
    assert out_cuts.tolist() == [12, 12] and raw_cuts.tolist() == [20, 20] and n_blocks == 1
    full = np.array([3, 7, 12], np.int64)
    out_cuts, raw_cuts, n_blocks = _cuts_all(full, full, 3, 1000, 1)
    assert out_cuts.tolist() == [12] and n_blocks == 1


@pytest.mark.parametrize("kind", ["text", "runs", "random", "zeros"])
def test_block_cuts_windows_hold_every_cut_of_rle1_sums(kind):
    # What the kernel speculates on: a piece's output is 1 to 5 bytes, so
    # cut m of a group of 31 that starts at a resolved sum B lands within
    # the window of 4 m + 5 entries from the first entry >= B + (m + 1) cap;
    # RLE1's sums never send a cut down the slow path.
    rng = np.random.default_rng(980)
    n, N = 250_000, 1 << 18
    padded = np.zeros(N, np.uint8)
    if kind != "zeros":
        padded[:n] = np.frombuffer(make_corpus(rng, kind, n), np.uint8)
    enc = rle1.rle1_encode(torch.from_numpy(padded), n)
    poc = enc["piece_out_cum"].numpy().astype(np.int64)
    assert np.diff(poc[: int(enc["n_pieces"])]).min() >= 1 and np.diff(poc[: int(enc["n_pieces"])]).max() <= 5
    for cap in (1, 7, 100, C.block_capacity(1) // 40):
        out_cuts, _, n_blocks = rle1.block_cuts_ref(*(enc[k] for k in ("piece_out_cum", "piece_raw_cum", "n_pieces")),
                                                   cap=cap, max_blocks=64)
        out_cuts = out_cuts.numpy().astype(np.int64)
        for b in range(int(n_blocks)):
            m, group_base = b % 31, (out_cuts[b - b % 31 - 1] if b >= 31 else 0)
            base = out_cuts[b - 1] if b else 0
            lo = np.searchsorted(poc, group_base + (m + 1) * cap)
            answer = np.searchsorted(poc, base + cap)
            assert lo <= answer, (cap, b)
            assert answer - lo < 4 * m + 5 or lo + 4 * m + 5 >= N, (cap, b, answer - lo)


# --- argument checks, dispatch ------------------------------------------------------


def test_crc32_ranges_rejects_bad_arguments():
    chunk = torch.zeros(64, dtype=torch.uint8)
    se = torch.zeros(2, dtype=torch.int32)
    for bad in (chunk.to(torch.int32), chunk[:0], chunk.view(8, 8), chunk[::2]):
        with pytest.raises(ValueError):
            crc.crc32_ranges(bad, se, se)
    for bad in (se.float(), se.view(2, 1), se[:1], se.bool(), se.to(torch.int16)):
        with pytest.raises(ValueError):
            crc.crc32_ranges(chunk, se, bad)
        with pytest.raises(ValueError):
            crc.crc32_ranges(chunk, bad, se)
    with pytest.raises(ValueError, match="is on meta"):
        crc.crc32_ranges(chunk, se.to("meta"), se)
    with pytest.raises(ValueError, match="unsupported device"):
        crc.crc32_ranges(chunk.to("meta"), se.to("meta"), se.to("meta"))
    with pytest.raises(ValueError, match="CUDA card"):
        crc_cuda.crc_ranges(chunk, se, se)


def test_block_cuts_rejects_bad_arguments():
    poc = torch.arange(1, 9, dtype=torch.int32)
    n_pieces = torch.tensor(8, dtype=torch.int32)
    for bad in (poc.long(), poc[:0], poc.view(2, 4), poc[:4], torch.arange(1, 17, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError):
            rle1.block_cuts(poc, bad, n_pieces, cap=4, max_blocks=2)
    for bad in (n_pieces.long(), n_pieces.view(1)):
        with pytest.raises(ValueError):
            rle1.block_cuts(poc, poc, bad, cap=4, max_blocks=2)
    with pytest.raises(ValueError, match="max_blocks"):
        rle1.block_cuts(poc, poc, n_pieces, cap=4, max_blocks=0)
    with pytest.raises(ValueError, match="one device"):
        rle1.block_cuts(poc, poc, n_pieces.to("meta"), cap=4, max_blocks=2)
    with pytest.raises(ValueError, match="unsupported device"):
        rle1.block_cuts(poc.to("meta"), poc.to("meta"), n_pieces.to("meta"), cap=4, max_blocks=2)
    with pytest.raises(ValueError, match="CUDA card"):
        rle1_cuda.block_cuts(poc, poc, n_pieces, cap=4, max_blocks=2)


def test_cpu_intake_takes_the_plain_versions_and_launches_nothing(monkeypatch):
    calls = {"crc": 0, "cuts": 0}
    real_crc, real_cuts = crc.crc32_ranges_ref, rle1.block_cuts_ref

    def count_crc(*a, **k):
        calls["crc"] += 1
        return real_crc(*a, **k)

    def count_cuts(*a, **k):
        calls["cuts"] += 1
        return real_cuts(*a, **k)

    monkeypatch.setattr(crc, "crc32_ranges_ref", count_crc)
    monkeypatch.setattr(rle1, "block_cuts_ref", count_cuts)
    crc_cuda.LAUNCHES["crc_ranges"] = rle1_cuda.LAUNCHES["block_cuts"] = 0
    rng = np.random.default_rng(960)
    n, N = 100_000, intake.chunk_capacity(1, 2)
    padded = np.zeros(N, np.uint8)
    padded[:n] = np.frombuffer(make_corpus(rng, "runs", n), np.uint8)
    res = intake.device_intake(torch.from_numpy(padded), n, level=1, max_blocks=2)
    assert calls == {"crc": 1, "cuts": 1}
    assert crc_cuda.LAUNCHES == {"crc_ranges": 0} and rle1_cuda.LAUNCHES == {"block_cuts": 0}
    nb = int(res["n_blocks"])
    starts = np.concatenate([[0], np.cumsum(res["raw_lens"].numpy())])
    assert res["crcs"][:nb].tolist() == [crc32_serial(padded[starts[i]:starts[i + 1]]) for i in range(nb)]


def test_device_intake_laps_its_steps_and_keeps_its_results():
    from bz2tpu_torch.utils.profiling import StageClock

    rng = np.random.default_rng(970)
    n, N = 100_000, intake.chunk_capacity(1, 2)
    padded = np.zeros(N, np.uint8)
    padded[:n] = np.frombuffer(make_corpus(rng, "text", n), np.uint8)
    chunk = torch.from_numpy(padded)
    steps: dict[str, float] = {}
    clocked = intake.device_intake(chunk, n, level=1, max_blocks=2, lap=StageClock(steps, chunk.device).lap)
    plain = intake.device_intake(chunk, n, level=1, max_blocks=2)
    assert list(steps) == ["rle1_encode", "block_cuts", "rows", "crc32_ranges"]
    assert all(s >= 0 for s in steps.values())
    assert clocked.keys() == plain.keys() and all(torch.equal(clocked[k], plain[k]) for k in plain)
