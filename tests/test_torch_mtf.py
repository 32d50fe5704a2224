"""bz2tpu_torch MTF + RLE2 (K3 rank scan, collapse, RLE2 plan and
emission) against the JAX package: mtf_ranks_pallas in interpret mode, the
list oracle, and bz2tpu.ops.mtf's _collapse / mtf_rle2_plan / _rle2_out.
All comparisons are exact.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bz2tpu.ops import mtf as jax_mtf  # noqa: E402
from bz2tpu.ops.mtf_pallas import mtf_ranks_pallas  # noqa: E402
from bz2tpu.oracle.encoder import bwt_encode as oracle_bwt  # noqa: E402
from bz2tpu.oracle.encoder import mtf_rle2_encode as oracle_mtf  # noqa: E402
from bz2tpu_torch import interop  # noqa: E402
from bz2tpu_torch.ops import mtf, mtf_cuda  # noqa: E402

from conftest import CORPUS_KINDS, make_corpus  # noqa: E402


def _oracle_ranks(seq, n_in_use):
    lst = list(range(n_in_use))
    out = []
    for v in seq:
        j = lst.index(v)
        out.append(j)
        lst.pop(j)
        lst.insert(0, v)
    return out


def _collapsed_seq(rng, n_sym, length):
    seq = [int(rng.integers(n_sym))]
    while len(seq) < length:
        v = int(rng.integers(n_sym))
        if v != seq[-1]:
            seq.append(v)
    return seq


@pytest.mark.parametrize(
    "n_sym,length,chunk",
    [(5, 100, 64), (256, 1000, 128), (30, 4095, 512), (3, 17, 256), (60, 1500, mtf_cuda.CHUNK)],
)
def test_ranks_vs_pallas_and_oracle(rng, n_sym, length, chunk):
    seq = _collapsed_seq(rng, n_sym, length)
    cap = length + 37
    padded = np.full(cap, -1, np.int32)
    padded[:length] = seq
    got = mtf_cuda.mtf_ranks_ref(
        torch.from_numpy(padded)[None], torch.tensor([n_sym], dtype=torch.int32),
        torch.tensor([length], dtype=torch.int32), chunk,
    )[0].numpy()
    pal = np.asarray(
        mtf_ranks_pallas(
            jnp.asarray(padded), jnp.int32(n_sym), m=jnp.int32(length), chunk=chunk, interpret=True
        )
    )
    np.testing.assert_array_equal(got[:length], _oracle_ranks(seq, n_sym))
    np.testing.assert_array_equal(got[:length], pal[:length])
    assert not got[length:].any()  # ranks past m are 0


def test_ranks_batch_of_unequal_lengths(rng):
    # The batch form: each row's carry is its own, rows end at their own m.
    rows = [(7, 900), (256, 300), (2, 1)]
    cap = 1000
    seq = np.full((len(rows), cap), -1, np.int32)
    for i, (k, ln) in enumerate(rows):
        seq[i, :ln] = _collapsed_seq(rng, k, ln)
    got = mtf_cuda.mtf_ranks(
        torch.from_numpy(seq), torch.tensor([k for k, _ in rows], dtype=torch.int32),
        torch.tensor([ln for _, ln in rows], dtype=torch.int32), 128,
    ).numpy()
    for i, (k, ln) in enumerate(rows):
        np.testing.assert_array_equal(got[i, :ln], _oracle_ranks(seq[i, :ln].tolist(), k))
        assert not got[i, ln:].any()


# (alphabet, m) of each row: m = 1, m = cap, m far below cap, alphabets of 1
# and 256.
_CHUNK_ROWS = [(1, 1), (256, 700), (256, 40), (7, 700), (2, 33), (40, 300)]


@pytest.mark.parametrize("chunk", [1, 32, 256, 2048, 4096])
def test_ranks_do_not_depend_on_the_chunk(chunk):
    rng = np.random.default_rng(5)  # the same rows for every chunk
    cap = 700
    seq = np.full((len(_CHUNK_ROWS), cap), -1, np.int32)
    for i, (k, ln) in enumerate(_CHUNK_ROWS):
        seq[i, :ln] = _collapsed_seq(rng, k, ln) if k > 1 else [0]
    got = mtf_cuda.mtf_ranks(
        torch.from_numpy(seq), torch.tensor([k for k, _ in _CHUNK_ROWS], dtype=torch.int32),
        torch.tensor([ln for _, ln in _CHUNK_ROWS], dtype=torch.int32), chunk,
    ).numpy()
    for i, (k, ln) in enumerate(_CHUNK_ROWS):
        np.testing.assert_array_equal(got[i, :ln], _oracle_ranks(seq[i, :ln].tolist(), k))
        assert not got[i, ln:].any()


def test_wrapper_checks_chunk_and_batch():
    seq = torch.zeros(2, 8, dtype=torch.int32)
    ones = torch.ones(2, dtype=torch.int32)
    for chunk in (0, 4097):
        with pytest.raises(ValueError):
            mtf_cuda.mtf_ranks(seq, ones, ones, chunk)
    assert mtf_cuda.CHUNK == 256


def _last_columns(rng, kinds, n, cap):
    last = np.zeros((len(kinds), cap), np.uint8)
    ns = np.zeros(len(kinds), np.int32)
    for i, kind in enumerate(kinds):
        arr = np.frombuffer(make_corpus(rng, kind, n - 97 * i), np.uint8)
        col, _ = oracle_bwt(arr)
        last[i, : arr.size] = col
        ns[i] = arr.size
    return last, ns


def test_collapse_matches_jax(rng):
    last, ns = _last_columns(rng, CORPUS_KINDS, 1500, 2048)
    got = mtf.collapse(torch.from_numpy(last), torch.from_numpy(ns))
    want = jax.vmap(jax_mtf._collapse)(jnp.asarray(last), jnp.asarray(ns))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _plan_pair(last, ns):
    from bz2tpu.ops.pipeline import mtf_plan_stage

    got = mtf.mtf_rle2_plan(torch.from_numpy(last), torch.from_numpy(ns))
    want = interop.from_jax(jax.device_get(mtf_plan_stage(jnp.asarray(last), jnp.asarray(ns))))
    return got, want


def test_plan_matches_jax(rng):
    last, ns = _last_columns(rng, CORPUS_KINDS, 3000, 4096)
    got, want = _plan_pair(last, ns)
    assert got.keys() == want.keys()
    m = mtf.collapse(torch.from_numpy(last), torch.from_numpy(ns))[2]
    k_valid = torch.arange(last.shape[1])[None, :] < m[:, None].long()
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        if key == "w1":  # the JAX ranks past m are unspecified
            torch.testing.assert_close(got[key][k_valid], want[key][k_valid], rtol=0, atol=0)
        else:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def test_rle2_out_matches_jax_and_oracle(rng):
    last, ns = _last_columns(rng, ["text", "runs", "zeros"], 3000, 4096)
    got_plan, jax_plan = _plan_pair(last, ns)
    width = int(got_plan["n_sym"].max())
    got = mtf.rle2_out(got_plan, width)
    # The JAX plan through the port's emission, and the JAX emission.
    torch.testing.assert_close(mtf.rle2_out(jax_plan, width), got, rtol=0, atol=0)
    jplan = interop.to_jax(jax_plan)
    want = jax.vmap(lambda p: jax_mtf._rle2_out(p, width, with_freqs=False)[0])(jplan)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(last.shape[0]):
        ref = oracle_mtf(last[i, : ns[i]]).symbols
        n_sym = int(got_plan["n_sym"][i])
        np.testing.assert_array_equal(got[i, :n_sym].numpy(), ref)
        assert (got[i, n_sym:] == -1).all()


def test_interop_round_trip():
    tree = {
        "a": np.arange(5, dtype=np.int32),
        "b": np.array([True, False]),
        "c": np.array([0xFFFFFFFF, 7], dtype=np.uint32),
        "d": np.arange(3, dtype=np.uint8),
    }
    port = interop.from_jax(tree)
    assert port["a"].dtype == torch.int32 and port["c"].dtype == torch.int64
    assert int(port["c"][0]) == 0xFFFFFFFF
    back = interop.to_jax(port)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
