"""bz2tpu_torch's device decode against the JAX package, stage by stage and
end to end: ibwt, mtf_rle2_decode, build_len_luts, decode_symbol_data and
the group chain (dec_chain's plain loop) against their bz2tpu forms, and
decompress_device(device="cpu") against bz2tpu.decompress_device and
stdlib bz2, including its host fallbacks and errors. Inputs come from
numpy seeds; every comparison is exact (integer codec, tolerance 0).
"""

import bz2 as stdlib_bz2

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bz2tpu import native  # noqa: E402
from bz2tpu.ops import huffman_dec as jax_huffman_dec  # noqa: E402
from bz2tpu.ops.ibwt import ibwt_batch as jax_ibwt_batch  # noqa: E402
from bz2tpu.ops.mtf_dec import mtf_rle2_decode as jax_mtf_rle2_decode  # noqa: E402
from bz2tpu.oracle.encoder import bwt_encode as oracle_bwt  # noqa: E402
from bz2tpu.oracle.encoder import mtf_rle2_encode as oracle_mtf  # noqa: E402
from bz2tpu.runtime import device_decode as jax_device_decode  # noqa: E402
from bz2tpu_torch.ops import dec_cuda, huffman_dec, ibwt, mtf_dec  # noqa: E402
from bz2tpu_torch.runtime import device_decode  # noqa: E402

from conftest import make_corpus  # noqa: E402
from test_randomised import craft_randomised_stream  # noqa: E402

CPU = torch.device("cpu")


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- inverse BWT -------------------------------------------------------------


@pytest.mark.parametrize("kinds", [("text", "runs", "zeros"), ("random", "alternating", "text")])
def test_ibwt_matches_jax(rng, kinds):
    S = 4096
    last = np.zeros((len(kinds), S), np.uint8)
    ns, ptrs, datas = [], [], []
    for i, kind in enumerate(kinds):
        data = np.frombuffer(make_corpus(rng, kind, 3000 + 500 * i), np.uint8)
        col, ptr = oracle_bwt(data)
        last[i, : col.size] = col
        last[i, col.size :] = rng.integers(0, 256, S - col.size)  # padding is ignored
        ns.append(data.size)
        ptrs.append(ptr)
        datas.append(data)
    got = ibwt.ibwt(torch.from_numpy(last), torch.tensor(ns), torch.tensor(ptrs))
    want = jax_ibwt_batch(jnp.asarray(last), jnp.asarray(ns, jnp.int32), jnp.asarray(ptrs, jnp.int32))
    _equal(got, want)
    for i, data in enumerate(datas):
        assert bytes(got[i, : data.size].numpy()) == data.tobytes()


def test_ibwt_tiny_and_periodic():
    for data in (np.array([9], np.uint8), np.tile(np.array([1, 2, 3], np.uint8), 400)):
        col, ptr = oracle_bwt(data)
        S = 2048
        last = np.zeros((1, S), np.uint8)
        last[0, : col.size] = col
        got = ibwt.ibwt(torch.from_numpy(last), torch.tensor([data.size]), torch.tensor([ptr]))
        want = jax_ibwt_batch(jnp.asarray(last), jnp.asarray([data.size], jnp.int32), jnp.asarray([ptr], jnp.int32))
        _equal(got, want)


# --- inverse MTF + RUNA/RUNB expansion ------------------------------------------


def _mtf_inputs(rng, kinds, n):
    """Rows of MTF/RLE2 symbols (-1 padded), n_sym, initial lists, EOBs."""
    encs = [oracle_mtf(oracle_bwt(np.frombuffer(make_corpus(rng, k, n), np.uint8))[0]) for k in kinds]
    M = -(-max(e.symbols.size for e in encs) // 128) * 128
    syms = np.full((len(encs), M), -1, np.int32)
    il = np.zeros((len(encs), 256), np.int32)
    for i, e in enumerate(encs):
        syms[i, : e.symbols.size] = e.symbols
        used = np.flatnonzero(e.used)
        il[i, : used.size] = used
    n_sym = np.array([e.symbols.size for e in encs], np.int32)
    eob = np.array([e.alpha_size - 1 for e in encs], np.int32)
    return syms, n_sym, il, eob


def _mtf_pair(syms, n_sym, il, eob, out_capacity):
    got = mtf_dec.mtf_rle2_decode(
        torch.from_numpy(syms), torch.from_numpy(n_sym), torch.from_numpy(il),
        torch.from_numpy(eob), out_capacity=out_capacity,
    )
    want = jax.vmap(
        lambda s, n, i, e: jax_mtf_rle2_decode(s, n, i, e, out_capacity=out_capacity)
    )(jnp.asarray(syms), jnp.asarray(n_sym), jnp.asarray(il), jnp.asarray(eob))
    _equal(got["n_bwt"], want["n_bwt"])
    _equal(got["ok"], want["ok"])
    W = got["bwt"].shape[1]
    _equal(got["bwt"], np.asarray(want["bwt"])[:, :W])
    assert not np.asarray(want["bwt"])[:, W:].any()  # the JAX row is 0 past W
    return got


def test_mtf_dec_matches_jax_over_many_chunks(rng):
    # Random bytes give ~all literals: thousands of 128-literal chunks, so
    # the chunk permutations' scan composes across many rounds.
    syms, n_sym, il, eob = _mtf_inputs(rng, ["random", "text", "runs", "zeros"], 12_000)
    assert n_sym[0] > 50 * 128
    got = _mtf_pair(syms, n_sym, il, eob, out_capacity=1 << 14)
    assert bool(got["ok"].all())


def test_mtf_dec_flags_overflow_and_long_runs_like_jax(rng):
    syms, n_sym, il, eob = _mtf_inputs(rng, ["text", "runs"], 3000)
    bad = syms.copy()
    bad[1, :30] = 0  # a 30-digit RUNA run: longer than any legal run
    bad[1, 30:] = syms[1, : syms.shape[1] - 30]
    n_bad = np.minimum(n_sym + np.array([0, 30], np.int32), syms.shape[1]).astype(np.int32)
    got = _mtf_pair(bad, n_bad, il, eob, out_capacity=1 << 12)
    assert not bool(got["ok"][1])
    got = _mtf_pair(syms, n_sym, il, eob, out_capacity=1000)  # output overflows
    assert not bool(got["ok"].any())


def test_chunk_scan_composes_in_order(rng):
    # compose(a, b) applies a first; the scan's order matters.
    q = torch.from_numpy(np.stack([rng.permutation(256) for _ in range(7)]).astype(np.uint8))[None]
    got = mtf_dec.inclusive_scan(q)
    want = q[0, 0].long()
    for c in range(7):
        if c:
            want = want[q[0, c].long()]
        _equal(got[0, c].long(), want.numpy())


# --- Huffman symbol decode -----------------------------------------------------


def _blocks(comp):
    headers, ends = native.scan_blocks(comp)
    bounds = headers[1:] + [ends[-1]]
    out = []
    for start, end in zip(headers, bounds):
        hdr = device_decode._parse_block_header(comp, start)
        hdr["end_bit"] = end
        out.append(hdr)
    return out


def test_parse_block_header_matches_jax(rng):
    comp = stdlib_bz2.compress(make_corpus(rng, "text", 150_000), 1)
    headers, _ = native.scan_blocks(comp)
    for h in headers:
        got = device_decode._parse_block_header(comp, h)
        want = jax_device_decode._parse_block_header(comp, h)
        assert got.keys() == want.keys()
        for key in ("crc", "orig_ptr", "alpha", "data_start_bit"):
            assert got[key] == want[key]
        np.testing.assert_array_equal(got["selectors"], want["selectors"])
        np.testing.assert_array_equal(got["used_bytes"], want["used_bytes"])


def test_build_len_luts_matches_jax(rng):
    comp = stdlib_bz2.compress(make_corpus(rng, "text", 60_000), 1)
    hdr = _blocks(comp)[0]
    got_arrays = huffman_dec.decode_tables_arrays(hdr["tables"])
    want_arrays = jax_huffman_dec.decode_tables_arrays(hdr["tables"])
    for g, w in zip(got_arrays, want_arrays):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    thr = np.zeros((got_arrays[3].shape[0] + 1, 21), np.int32)
    thr[1:] = got_arrays[3]  # row 0: the all-zero row of unused table slots
    got = huffman_dec.build_len_luts(torch.from_numpy(thr))
    assert got.dtype == torch.int8 and got.shape == (thr.shape[0], 1 << 20)
    _equal(got, jax_huffman_dec.build_len_luts(jnp.asarray(thr)))


def _symbol_batch(comp, blocks, nbc):
    """The port's batched decode_symbol_data over ``blocks``, and JAX's per
    block at the same bit-range cap."""
    b = len(blocks)
    T = 6
    G = max(p["selectors"].size for p in blocks)
    gmax = 1 << max(4, (G - 1).bit_length())
    sel = np.zeros((b, G), np.int32)
    base = np.zeros((b, T, 21), np.int32)
    perm = np.zeros((b, T, 258), np.int32)
    lidx = np.zeros((b, T), np.int32)
    thr_rows = [np.zeros(21, np.int32)]
    jax_out = []
    stream = jnp.asarray(np.frombuffer(comp, np.uint8))
    for r, p in enumerate(blocks):
        n = p["selectors"].size
        sel[r, :n] = p["selectors"]
        limit, base_a, perm_a, thr_a = huffman_dec.decode_tables_arrays(p["tables"])
        base[r, : base_a.shape[0]] = base_a
        perm[r, : perm_a.shape[0]] = perm_a
        for t in range(thr_a.shape[0]):
            lidx[r, t] = len(thr_rows)
            thr_rows.append(thr_a[t])
        jsel = np.zeros(gmax, np.int32)
        jsel[:n] = p["selectors"]
        jax_out.append(jax_huffman_dec.decode_symbol_data(
            stream, jnp.int32(p["data_start_bit"]), jnp.int32(p["end_bit"]), jnp.asarray(jsel),
            jnp.int32(n), jnp.asarray(limit), jnp.asarray(base_a), jnp.asarray(perm_a),
            jnp.int32(p["alpha"] - 1), jnp.asarray(thr_a), max_groups=gmax, n_bits_cap=nbc,
        ))
    lut = huffman_dec.build_len_luts(torch.from_numpy(np.stack(thr_rows)))
    words = huffman_dec.window_words(torch.from_numpy(np.frombuffer(comp, np.uint8).copy()))
    got = huffman_dec.decode_symbol_data(
        words,
        torch.tensor([p["data_start_bit"] for p in blocks]),
        torch.tensor([p["end_bit"] for p in blocks]),
        torch.from_numpy(sel),
        torch.tensor([p["selectors"].size for p in blocks], dtype=torch.int32),
        torch.from_numpy(base), torch.from_numpy(perm),
        torch.tensor([p["alpha"] - 1 for p in blocks], dtype=torch.int32),
        lut, torch.from_numpy(lidx), n_bits_cap=nbc,
    )
    return got, jax_out, G


@pytest.mark.parametrize("kind,level", [("text", 1), ("random", 1), ("runs", 2), ("text", 9)])
def test_decode_symbol_data_matches_jax(rng, kind, level):
    comp = stdlib_bz2.compress(make_corpus(rng, kind, 220_000), level)
    blocks = _blocks(comp)
    nbc = 1 << max(12, (max(p["end_bit"] - p["data_start_bit"] for p in blocks) - 1).bit_length())
    got, want, G = _symbol_batch(comp, blocks, nbc)
    for r, w in enumerate(want):
        assert bool(w["ok"]) and bool(got["ok"][r])
        assert int(got["n_sym"][r]) == int(w["n_sym"])
        _equal(got["symbols"][r], np.asarray(w["symbols"])[: G * 50])
        assert (np.asarray(w["symbols"])[G * 50 :] == -1).all()


def test_decode_symbol_data_rejects_a_wrong_end_like_jax(rng):
    comp = stdlib_bz2.compress(make_corpus(rng, "text", 40_000), 1)
    blocks = _blocks(comp)
    blocks[0]["end_bit"] -= 1
    got, want, _ = _symbol_batch(comp, blocks, 1 << 18)
    assert not bool(want[0]["ok"]) and not bool(got["ok"][0])


# --- the group chain (dec_chain's plain loop) ------------------------------------


def _jax_chain(jump50, tbl, n_groups):
    """The chain of bz2tpu/ops/huffman_dec.py:231-239, vmapped over blocks."""
    G, nbc = tbl.shape[1], jump50.shape[2]

    def one(j50, t, ng):
        def chain_step(g, carry):
            cur, starts = carry
            starts = starts.at[g].set(cur)
            nxt = j50[t[g], jnp.clip(cur, 0, nbc - 1)]
            return jnp.where(g < ng, nxt, cur), starts

        return jax.lax.fori_loop(0, G, chain_step, (jnp.int32(0), jnp.zeros(G, jnp.int32)))[1]

    return jax.vmap(one)(jnp.asarray(jump50), jnp.asarray(tbl), jnp.asarray(n_groups))


def test_group_starts_ref_matches_jax_chain():
    rng = np.random.default_rng(21)
    B, T, nbc, G = 3, 6, 5000, 90
    # Forward jumps of 50..1000 bits, clipped at the end, as jump50 maps are.
    jump50 = np.minimum(np.arange(nbc) + rng.integers(50, 1000, (B, T, nbc)), nbc - 1).astype(np.int32)
    tbl = rng.integers(0, T, (B, G)).astype(np.int32)
    n_groups = np.array([G, 37, 1], np.int32)
    args = [torch.from_numpy(a) for a in (jump50, tbl, n_groups)]
    want = _jax_chain(jump50, tbl, n_groups)
    _equal(dec_cuda.group_starts_ref(*args), want)
    _equal(dec_cuda.group_starts(*args), want)  # a CPU tensor takes the plain loop


def test_group_starts_are_the_true_group_boundaries(rng):
    # On a real block, each start is where the serial decode of the
    # previous group's 50 symbols ends.
    comp = stdlib_bz2.compress(make_corpus(rng, "text", 30_000), 1)
    p = _blocks(comp)[0]
    nbc = 1 << 18
    limit, base, perm, thr = huffman_dec.decode_tables_arrays(p["tables"])
    lut = huffman_dec.build_len_luts(torch.from_numpy(thr))
    words = huffman_dec.window_words(torch.from_numpy(np.frombuffer(comp, np.uint8).copy()))
    T = thr.shape[0]
    start = torch.tensor([p["data_start_bit"]])
    jump50 = huffman_dec.jump50_maps(words, start, lut, torch.arange(T, dtype=torch.int32)[None], nbc)
    tbl = torch.from_numpy(p["selectors"])[None]
    starts = dec_cuda.group_starts(jump50, tbl, torch.tensor([tbl.shape[1]], dtype=torch.int32))[0]
    # Serial decode of group lengths.
    bits = []
    pos = p["data_start_bit"]
    words_np = words.numpy()
    for g in range(tbl.shape[1] - 1):
        bits.append(pos - p["data_start_bit"])
        t = int(p["selectors"][g])
        for _ in range(50):
            v = int(words_np[pos >> 3] >> (9 - (pos & 7))) & ((1 << 23) - 1)
            pos += int(np.searchsorted(thr[t], v, side="right"))
    _equal(starts[: len(bits)], np.array(bits, np.int32))


# --- decompress_device end to end -------------------------------------------------


@pytest.mark.parametrize("level", [1, 2, 9])
@pytest.mark.parametrize("kind", ["text", "runs", "zeros", "random"])
def test_decompress_device_matches_jax_and_stdlib(kind, level):
    rng = np.random.default_rng(100 + level)
    data = make_corpus(rng, kind, 150_000 if level < 9 else 250_000)
    comp = stdlib_bz2.compress(data, level)
    inner = device_decode._decompress_device_inner(comp, True, CPU)
    assert inner == data  # every block decoded by the device path, no fallback
    assert device_decode.decompress_device(comp, device="cpu") == data
    assert jax_device_decode.decompress_device(comp) == data


def test_decompress_device_own_streams_multiblock(rng):
    import bz2tpu_torch

    data = make_corpus(rng, "text", 230_000) + make_corpus(rng, "random", 40_000)
    comp = bz2tpu_torch.compress(data, level=1, device="cpu")
    assert device_decode._decompress_device_inner(comp, True, CPU) == data
    assert jax_device_decode.decompress_device(comp) == data


def test_decompress_device_fallbacks_match_jax(rng):
    a = make_corpus(rng, "text", 120_000)
    b = make_corpus(rng, "runs", 60_000)
    multi = stdlib_bz2.compress(a, 1) + stdlib_bz2.compress(b, 9)
    randomised = craft_randomised_stream(make_corpus(rng, "text", 20_000))
    for stream, want in ((multi, a + b), (randomised, stdlib_bz2.decompress(randomised))):
        # Both forms leave these streams to the host decoder.
        assert device_decode._decompress_device_inner(stream, True, CPU) is None
        assert jax_device_decode._decompress_device_inner(stream, True) is None
        assert device_decode.decompress_device(stream, device="cpu") == want
        assert jax_device_decode.decompress_device(stream) == want


def test_decompress_device_corrupt_raises_like_jax(rng):
    comp = bytearray(stdlib_bz2.compress(make_corpus(rng, "text", 150_000), 1))
    for off in range(60, 600, 60):
        comp[off] ^= 0x04
    with pytest.raises(ValueError) as want:
        jax_device_decode.decompress_device(bytes(comp))
    with pytest.raises(ValueError) as got:
        device_decode.decompress_device(bytes(comp), device="cpu")
    assert type(got.value) is type(want.value)
    with pytest.raises(ValueError):
        device_decode.decompress_device(b"BZh9garbage", device="cpu")


def test_decompress_device_timings_cover_every_stage(rng):
    data = make_corpus(rng, "text", 30_000)
    timings = {}
    assert device_decode.decompress_device(stdlib_bz2.compress(data, 1), device="cpu", timings=timings) == data
    assert set(timings) == {"parse", "tables", "huffman", "mtf", "ibwt", "rle1_crc"}


def test_decompress_device_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_decode.decompress_device(stdlib_bz2.compress(b"abc"))
