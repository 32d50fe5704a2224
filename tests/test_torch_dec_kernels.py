"""The device decode's group-symbol decode (dec_symbols, ops/dec_cuda.py)
and inverse-MTF chunk permutations (mtf_dec, ops/mtf_dec_cuda.py) on the
CPU, where each wrapper takes its plain torch version:

  * decode_symbol_data and mtf_rle2_decode through the wrappers against
    bz2tpu's on JAX-CPU: stdlib streams at levels 1, 2 and 9, corrupt
    symbol data and bad codes, a batch of unequal group counts, and
    symbol rows of 1, 2 and 57 chunks, move index 255 and all-run blocks;
  * each plain version against a literal copy of the loop it came from;
  * each wrapper's argument checks, and no launch counted on the CPU.

Every comparison is exact (integer codec, tolerance 0). The kernels
themselves run in tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import bz2 as stdlib_bz2

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from bz2tpu_torch.format import constants as C  # noqa: E402
from bz2tpu_torch.ops import dec_cuda, huffman_dec, mtf_dec, mtf_dec_cuda  # noqa: E402
from bz2tpu_torch.runtime import device_decode  # noqa: E402

from conftest import make_corpus  # noqa: E402
from test_torch_decode import _blocks, _mtf_pair, _symbol_batch  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs in several
    worker processes, and torch's default of one thread a core in each
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _nbc(blocks) -> int:
    return 1 << max(12, (max(p["end_bit"] - p["data_start_bit"] for p in blocks) - 1).bit_length())


def _check_symbols(got, want, G) -> None:
    """The port's batch against JAX's per-block results: ok, n_sym and the
    symbols, whatever ok says."""
    for r, w in enumerate(want):
        assert bool(got["ok"][r]) == bool(w["ok"])
        assert int(got["n_sym"][r]) == int(w["n_sym"])
        _equal(got["symbols"][r], np.asarray(w["symbols"])[: G * 50])
        assert (np.asarray(w["symbols"])[G * 50 :] == -1).all()


# --- decode_symbol_data through dec_symbols ---------------------------------------


@pytest.mark.parametrize("level", [1, 2, 9])
def test_decode_symbol_data_through_dec_symbols_matches_jax(level):
    rng = np.random.default_rng(300 + level)
    data = make_corpus(rng, "text", 160_000) + make_corpus(rng, "random", 50_000)
    comp = stdlib_bz2.compress(data, level)
    blocks = _blocks(comp)
    got, want, G = _symbol_batch(comp, blocks, _nbc(blocks))
    assert bool(got["ok"].all())
    _check_symbols(got, want, G)


def test_decode_symbol_data_unequal_group_counts_match_jax():
    rng = np.random.default_rng(311)
    data = make_corpus(rng, "text", 130_000) + make_corpus(rng, "runs", 60_000) + make_corpus(rng, "random", 30_000)
    comp = stdlib_bz2.compress(data, 1)
    blocks = _blocks(comp)
    assert len({p["selectors"].size for p in blocks}) == len(blocks) > 1
    got, want, G = _symbol_batch(comp, blocks, _nbc(blocks))
    assert bool(got["ok"].all())
    _check_symbols(got, want, G)


@pytest.mark.parametrize("case", ["flipped-bit", "bad-codes"])
def test_decode_symbol_data_corrupt_matches_jax(case):
    rng = np.random.default_rng(320)
    comp = stdlib_bz2.compress(make_corpus(rng, "text", 150_000), 1)
    blocks = _blocks(comp)
    if case == "flipped-bit":
        # The last bit of block 0's symbol data, inside its EOB code: the
        # walk reads on past the block's end bit. (A flip in the middle
        # turns a code into another and the prefix code falls back into
        # step: EOB still lands at the end.)
        bad = bytearray(comp)
        pos = blocks[0]["end_bit"] - 1
        bad[pos >> 3] ^= 0x80 >> (pos & 7)
        comp = bytes(bad)
    else:
        # The canonical bases of block 1's first table far above its codes:
        # every code of that table decodes to a negative index, so its
        # groups, the first among them, give -2.
        t = int(blocks[1]["selectors"][0])
        lim, bas, prm, min_l = blocks[1]["tables"][t]
        blocks[1]["tables"][t] = (lim, bas + 1000, prm, min_l)
    got, want, G = _symbol_batch(comp, blocks, _nbc(blocks))
    _check_symbols(got, want, G)
    broken = 0 if case == "flipped-bit" else 1
    assert not bool(got["ok"][broken]) and bool(got["ok"][1 - broken])
    if case == "bad-codes":
        assert int(got["symbols"][1][0]) == -2


# --- mtf_rle2_decode through mtf_dec ------------------------------------------------


def _symbol_row(rng, n, alpha, kind):
    """n MTF/RLE2 symbols ending in EOB: literals in [2, eob) with runs of
    1 to 3 digits between them ("mixed"), the same with most literals the
    last list entry ("last": move index 255 at alpha 258), or only RUNA /
    RUNB digits ("runs", a block of one repeated byte)."""
    eob = alpha - 1
    if kind == "runs":
        return [int(d) for d in rng.integers(0, 2, n - 1)] + [eob]
    body = []
    while len(body) < n - 1:
        if rng.random() < 0.3:
            body += [int(d) for d in rng.integers(0, 2, int(rng.integers(1, 4)))]
        body.append(eob - 1 if kind == "last" and rng.random() < 0.7 else int(rng.integers(2, eob)))
    return body[: n - 1] + [eob]


@pytest.mark.parametrize("n_chunks", [1, 2, 57])
def test_mtf_rle2_decode_through_mtf_dec_matches_jax(n_chunks):
    # A batch of 128 * n_chunks symbols a row: a row of literals and runs
    # that fills it, an all-run block padded far past its EOB, and a row
    # whose literals mostly move index 255 (alpha 258).
    rng = np.random.default_rng(400 + n_chunks)
    m = 128 * n_chunks
    rows = [(m, 200, "mixed"), (14, 30, "runs"), (m - 37, 258, "last")]
    syms = np.full((len(rows), m), -1, np.int32)
    il = np.zeros((len(rows), 256), np.int32)
    for r, (n, alpha, kind) in enumerate(rows):
        syms[r, :n] = _symbol_row(rng, n, alpha, kind)
        il[r, : alpha - 2] = np.sort(rng.choice(256, alpha - 2, replace=False))
    n_sym = np.array([n for n, _, _ in rows], np.int32)
    eob = np.array([alpha - 1 for _, alpha, _ in rows], np.int32)
    assert (syms[2] == 256).sum() > 0.5 * (m - 37) * 0.7  # move index 255 throughout
    got = _mtf_pair(syms, n_sym, il, eob, out_capacity=1 << 17)
    assert bool(got["ok"].all())
    # The all-run block: every output byte is the first entry of its list.
    n = int(got["n_bwt"][1])
    assert n > 0 and (got["bwt"][1, :n] == il[1, 0]).all()


# --- the plain versions against the loops they came from --------------------------


def _decode_groups_loop(words, offs, tbl, lut, lut_idx, base, perm):
    """The step-4 loop of ops/huffman_dec.decode_symbol_data as it stood
    before the dec_symbols kernel, copied literally."""
    B, G = tbl.shape
    T = base.shape[1]
    dev = words.device
    group = C.HUFFMAN_GROUP_SIZE
    alpha = C.HUFFMAN_MAX_ALPHABET
    KMAX, LUT_BITS = huffman_dec.KMAX, huffman_dec.LUT_BITS

    def window23(words, bitpos):
        w32 = words[(bitpos >> 3).clamp(0, words.shape[0] - 1)]
        return (w32 >> (9 - (bitpos & 7))) & ((1 << 23) - 1)

    bt = torch.arange(B, device=dev)[:, None] * T + tbl.long()  # (B, G) table row
    lut_g = lut_idx.long().gather(1, tbl.long()) << LUT_BITS
    flat_lut, flat_base, flat_perm = lut.view(-1), base.reshape(-1), perm.reshape(-1)
    syms, lens = [], []
    for _ in range(group):
        v = window23(words, offs)
        ln = flat_lut[lut_g + (v >> 3)].to(torch.int64)
        matched = ln <= KMAX
        ln = torch.where(matched, ln.clamp(min=1), 1)
        pidx = (v >> (23 - ln)) - flat_base[bt * (KMAX + 1) + ln]
        bad = ~matched | (pidx < 0) | (pidx >= alpha)
        sym = flat_perm[bt * alpha + pidx.clamp(0, alpha - 1)]
        syms.append(torch.where(bad, -2, sym))
        lens.append(ln)
        offs = offs + ln
    flat_syms = torch.stack(syms, 2).view(B, G * group)
    flat_lens = torch.stack(lens, 2).view(B, G * group)
    return flat_syms, flat_lens


def _random_group_inputs(rng, B=3, T=6, U=5, G=40, n_bytes=3000):
    """Arbitrary inputs of decode_groups: random LUT lengths 0..22 (some
    beyond 20), bases that put some indices out of [0, 258), starts that
    reach past the stream's end."""
    stream = torch.from_numpy(rng.integers(0, 256, n_bytes).astype(np.uint8))
    words = huffman_dec.window_words(stream)
    offs = torch.from_numpy(rng.integers(0, 8 * n_bytes + 200, (B, G))).to(torch.int64)
    tbl = torch.from_numpy(rng.integers(0, T, (B, G)).astype(np.int32))
    lut = torch.from_numpy(rng.integers(0, 23, (U, 1 << 20)).astype(np.int8))
    lut_idx = torch.from_numpy(rng.integers(0, U, (B, T)).astype(np.int32))
    base = torch.from_numpy(rng.integers(-300, 1 << 18, (B, T, 21)).astype(np.int32))
    perm = torch.from_numpy(rng.integers(0, 258, (B, T, 258)).astype(np.int32))
    return words, offs, tbl, lut, lut_idx, base, perm


def test_decode_groups_ref_equals_the_loop_it_came_from():
    rng = np.random.default_rng(500)
    args = _random_group_inputs(rng)
    want_syms, want_lens = _decode_groups_loop(*args)
    assert (want_syms == -2).any() and (want_lens == 1).any()
    for fn in (dec_cuda.decode_groups_ref, dec_cuda.decode_groups):
        syms, lens = fn(*args)
        assert syms.dtype == lens.dtype == torch.int32
        _equal(syms, want_syms)
        _equal(lens, want_lens)


def _chunk_perms_loop(js):
    """The chunk loop of ops/mtf_dec.mtf_rle2_decode as it stood before the
    mtf_dec kernel, copied literally (js int64 there)."""
    B, m = js.shape
    dev = js.device
    CHUNK = 128
    n_chunks = m // CHUNK
    jc = js.view(B, n_chunks, CHUNK)
    k256 = torch.arange(256, device=dev)
    q0 = k256.to(torch.uint8).expand(B, n_chunks, 256)
    q = q0.clone()
    emit = torch.zeros(B, n_chunks, CHUNK, dtype=torch.uint8, device=dev)
    for i in range(CHUNK):
        j = jc[:, :, i : i + 1]  # (B, n_chunks, 1)
        e = q.gather(2, j)
        emit[:, :, i : i + 1] = e
        q = torch.where(k256 == 0, e, torch.where(k256 <= j, torch.roll(q, 1, 2), q))
    return q, emit


@pytest.mark.parametrize("n_chunks", [1, 2, 57])
def test_chunk_perms_ref_equals_the_loop_it_came_from(n_chunks):
    rng = np.random.default_rng(600 + n_chunks)
    js = rng.integers(0, 256, (3, 128 * n_chunks))
    js[0, : 128 * n_chunks // 2] = 255
    js[1, 100:] = 0  # padding: the identity
    js[2, ::3] = 0
    want_q, want_emit = _chunk_perms_loop(torch.from_numpy(js))
    for fn in (mtf_dec_cuda.chunk_perms_ref, mtf_dec_cuda.chunk_perms):
        q, emit = fn(torch.from_numpy(js.astype(np.uint8)))
        assert q.dtype == emit.dtype == torch.uint8
        _equal(q, want_q)
        _equal(emit, want_emit)
    # Every chunk's list stays a permutation of 0..255.
    assert (want_q.sort(2).values == torch.arange(256, dtype=torch.uint8)).all()


# --- argument checks, launch counts, the decode's split --------------------------


def test_decode_groups_rejects_bad_arguments():
    rng = np.random.default_rng(700)
    words, offs, tbl, lut, lut_idx, base, perm = _random_group_inputs(rng, G=4)
    good = dict(words=words, offs=offs, tbl=tbl, lut=lut, lut_idx=lut_idx, base=base, perm=perm)
    bad = {
        "words": [words.to(torch.int32), words[:0], words.view(-1, 1)],
        "offs": [offs.to(torch.int32), offs[0], offs.t()],
        "tbl": [tbl.long(), tbl[:, :2], tbl.t().contiguous().t()],
        "lut": [lut.to(torch.uint8), lut[:, :100], lut[:0]],
        "lut_idx": [lut_idx.long(), lut_idx[:, :3]],
        "base": [base.long(), base[:, :, :20].contiguous(), torch.zeros(3, 7, 21, dtype=torch.int32), base[:, :0]],
        "perm": [perm.long(), perm[:, :, :257].contiguous(), perm[:, :5].contiguous()],
    }
    for name, cases in bad.items():
        for value in cases:
            with pytest.raises(ValueError):
                dec_cuda.decode_groups(**{**good, name: value})
    with pytest.raises(ValueError, match="unsupported device"):
        dec_cuda.decode_groups(*(t.to("meta") for t in good.values()))


def test_chunk_perms_rejects_bad_arguments():
    js = torch.zeros(2, 256, dtype=torch.uint8)
    for value in (js.long(), js[:, :200].contiguous(), js.view(-1), js.t().contiguous().t()[:, :128], js[0:0, :100]):
        with pytest.raises(ValueError):
            mtf_dec_cuda.chunk_perms(value)
    with pytest.raises(ValueError, match="unsupported device"):
        mtf_dec_cuda.chunk_perms(js.to("meta"))


def test_cpu_decode_launches_no_kernel_and_splits_its_stages():
    rng = np.random.default_rng(800)
    data = make_corpus(rng, "text", 120_000) + make_corpus(rng, "random", 20_000)
    comp = stdlib_bz2.compress(data, 1)
    for counts in (dec_cuda.LAUNCHES, mtf_dec_cuda.LAUNCHES):
        for name in counts:
            counts[name] = 0
    timings, split = {}, {}
    assert device_decode._decompress_device_inner(comp, True, CPU, timings, split) == data
    assert dec_cuda.LAUNCHES == {"dec_chain": 0, "dec_symbols": 0}
    assert mtf_dec_cuda.LAUNCHES == {"mtf_dec": 0}
    assert set(timings) == {"parse", "members", "tables", "huffman", "mtf", "ibwt", "rle1_crc"}
    assert set(split) == {"jump_maps", "dec_chain", "dec_symbols", "validate", "segments", "chunk_perms",
                          "chunk_scan", "expand"}
    assert all(v >= 0 for v in split.values())
    # The split's steps lie inside their stages.
    assert sum(split.values()) <= timings["huffman"] + timings["mtf"] + timings["tables"]
    # Without a clock, no split.
    split2 = {}
    assert device_decode._decompress_device_inner(comp, True, CPU, None, split2) == data
    assert split2 == {}
    assert mtf_dec.CHUNK == mtf_dec_cuda.CHUNK == 128
