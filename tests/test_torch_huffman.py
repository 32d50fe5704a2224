"""bz2tpu_torch Huffman planning against bz2tpu.ops.huffman: the batched
tree scan, depth cap, seeding, refinement, codes and selector MTF. Exact.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bz2tpu.ops import huffman as jax_huff  # noqa: E402
from bz2tpu.oracle.encoder import bwt_encode as oracle_bwt  # noqa: E402
from bz2tpu.oracle.encoder import mtf_rle2_encode as oracle_mtf  # noqa: E402
from bz2tpu_torch.ops import huffman, huffman_cuda  # noqa: E402

from conftest import CORPUS_KINDS, make_corpus  # noqa: E402
from huffman_cases import PLAN_CASES, plan_case  # noqa: E402


def _freq_rows(rng):
    """Rows that exercise ties, zeros, a one-symbol-heavy skew and a
    Fibonacci profile deep enough to hit the 17-bit depth cap."""
    rows, alphas = [], []
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    for alpha, make in [
        (258, lambda: rng.integers(0, 1000, 258)),
        (20, lambda: np.full(258, 7)),
        (3, lambda: np.array([0, 5, 0] + [0] * 255)),
        (40, lambda: np.array(fib + [0] * 218)),
        (100, lambda: np.where(np.arange(258) == 4, 1 << 20, rng.integers(0, 3, 258))),
    ]:
        rows.append(make().astype(np.int64))
        alphas.append(alpha)
    return np.stack(rows), np.array(alphas)


def test_code_lengths_match_jax(rng):
    freqs, alphas = _freq_rows(rng)
    got = huffman_cuda.code_lengths_ref(torch.from_numpy(freqs), torch.from_numpy(alphas)).numpy()
    assert got.max() <= 17
    for i in range(freqs.shape[0]):
        want = jax_huff.code_lengths(jnp.asarray(freqs[i], jnp.int32), jnp.int32(alphas[i]))
        np.testing.assert_array_equal(got[i], np.asarray(want))


def _cap_retries(row: np.ndarray, alpha: int) -> int:
    """How often the depth cap flattens the row's weights."""
    valid = np.arange(258) < alpha
    w = torch.from_numpy(np.where(valid, np.maximum(row, 1), 0))[None]
    a = torch.tensor([alpha])
    n = 0
    while int(huffman_cuda.huffman_depths(w, a).max()) > 17:
        w = torch.where(torch.from_numpy(valid), 1 + (w >> 1), w)
        n += 1
    return n


_FIB = [1, 1]
while len(_FIB) < 42:
    _FIB.append(_FIB[-1] + _FIB[-2])

# (alpha, row, least number of cap retries): all-equal weights over the
# whole alphabet, and two rows deep enough to need several flattenings.
_CODE_LENGTH_CASES = {
    "all-equal-258": (258, np.full(258, 13), 0),
    "fibonacci-42": (42, np.array(_FIB + [0] * 216), 2),
    "powers-of-two": (130, np.array([1 << k for k in range(30)] + [1] * 100 + [0] * 128), 2),
}


@pytest.mark.parametrize("case", list(_CODE_LENGTH_CASES))
def test_code_lengths_ref_cases_match_jax(case):
    alpha, row, min_retries = _CODE_LENGTH_CASES[case]
    row = row.astype(np.int64)
    assert _cap_retries(row, alpha) >= min_retries
    freqs = torch.from_numpy(np.stack([row, row[::-1].copy()]))
    alphas = torch.tensor([alpha, 258])
    got = huffman_cuda.code_lengths_ref(freqs, alphas)
    for i in range(2):
        want = jax_huff.code_lengths(jnp.asarray(freqs[i].numpy(), jnp.int32), jnp.int32(alphas[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert 1 <= int(got[0, :alpha].min()) and int(got.max()) <= 17


def test_code_lengths_wrapper_checks_inputs():
    # The code lengths run inside huffman_plan now; its wrapper refuses
    # what the kernel does not take.
    sym = torch.zeros(3, 120, dtype=torch.int32)
    n = torch.full((3,), 120, dtype=torch.int32)
    seed = torch.zeros(3, 6, 258, dtype=torch.int64)
    huffman_cuda.huffman_plan(sym, n, n, seed, 4)
    with pytest.raises(ValueError):
        huffman_cuda.huffman_plan(sym.long(), n, n, seed, 4)
    with pytest.raises(ValueError):
        huffman_cuda.huffman_plan(sym, n[:2], n, seed, 4)
    with pytest.raises(ValueError):
        huffman_cuda.huffman_plan(sym, n, n, seed[:, :, :100], 4)
    with pytest.raises(ValueError):
        huffman_cuda.huffman_plan(sym, n, n, seed, 2)  # 120 symbols are 3 groups


def test_seed_lengths_match_jax(rng):
    B = 6
    freqs = rng.integers(0, 500, (B, 258)).astype(np.int64)
    freqs[1, 10:] = 0
    freqs[2] = 0
    freqs[2, 0] = 9
    n_groups = np.array([2, 3, 4, 5, 6, 6])
    alphas = np.array([258, 12, 30, 200, 258, 50])
    freqs[np.arange(258)[None, :] >= alphas[:, None]] = 0
    got = huffman.seed_lengths(
        torch.from_numpy(freqs), torch.from_numpy(n_groups), torch.from_numpy(alphas)
    ).numpy()
    for b in range(B):
        want = jax_huff.seed_lengths(
            jnp.asarray(freqs[b], jnp.int32), jnp.int32(n_groups[b]), jnp.int32(alphas[b])
        )
        np.testing.assert_array_equal(got[b], np.asarray(want))


def test_selector_mtf_and_canonical_codes_match_jax(rng):
    sel = rng.integers(0, 6, (3, 40))
    n_sel = np.array([40, 17, 1])
    got = huffman_cuda.selector_mtf_ranks(torch.from_numpy(sel), torch.from_numpy(n_sel)).numpy()
    freqs, alphas = _freq_rows(rng)
    lengths = huffman_cuda.code_lengths_ref(torch.from_numpy(freqs), torch.from_numpy(alphas))
    codes = huffman.canonical_codes(lengths[:, None, :], torch.from_numpy(alphas)).numpy()
    for b in range(3):
        want = jax_huff.selector_mtf_ranks(jnp.asarray(sel[b], jnp.int32), jnp.int32(n_sel[b]))
        np.testing.assert_array_equal(got[b, : n_sel[b]], np.asarray(want)[: n_sel[b]])
    for i in range(freqs.shape[0]):
        want = jax_huff.canonical_codes(jnp.asarray(lengths[i : i + 1].numpy(), jnp.int32), jnp.int32(alphas[i]))
        np.testing.assert_array_equal(codes[i], np.asarray(want))


def _symbol_batch(rng, kinds, sizes):
    streams = []
    for kind, n in zip(kinds, sizes):
        arr = np.frombuffer(make_corpus(rng, kind, n), np.uint8)
        last, _ = oracle_bwt(arr)
        streams.append(oracle_mtf(last))
    width = max(s.symbols.size for s in streams) + 3
    sym = np.full((len(streams), width), -1, np.int32)
    for i, s in enumerate(streams):
        sym[i, : s.symbols.size] = s.symbols
    n_sym = np.array([s.symbols.size for s in streams], np.int32)
    n_in_use = np.array([s.alpha_size - 2 for s in streams], np.int32)
    return sym, n_sym, n_in_use


def test_huffman_assign_matches_jax(rng):
    # Sizes span every table count (2..6 tables) and a long refinement.
    kinds = CORPUS_KINDS + ["text", "random"]
    sizes = [4000, 3000, 5000, 2000, 1000, 150, 20_000]
    sym, n_sym, n_in_use = _symbol_batch(rng, kinds, sizes)
    maxsel = huffman.max_selectors(sym.shape[1] - 2)
    got = huffman.huffman_assign(
        torch.from_numpy(sym), torch.from_numpy(n_sym), torch.from_numpy(n_in_use), maxsel
    )
    want = jax.vmap(
        lambda s, ns, niu: jax_huff.huffman_assign(s, ns, None, niu, maxsel=maxsel)
    )(jnp.asarray(sym), jnp.asarray(n_sym), jnp.asarray(n_in_use))
    want = {k: np.asarray(v) for k, v in want.items()}
    for key in got:
        assert got[key].dtype == torch.int32, key
    np.testing.assert_array_equal(got["n_groups"].numpy(), want["n_groups"])
    np.testing.assert_array_equal(got["n_selectors"].numpy(), want["n_selectors"])
    for b in range(sym.shape[0]):
        ns_, ng, alpha = int(want["n_selectors"][b]), int(want["n_groups"][b]), int(n_in_use[b]) + 2
        for key in ("selectors", "selector_mtf"):
            np.testing.assert_array_equal(got[key][b, :ns_].numpy(), want[key][b, :ns_], err_msg=key)
        for key in ("lengths", "codes"):
            np.testing.assert_array_equal(
                got[key][b, :ng, :alpha].numpy(), want[key][b, :ng, :alpha], err_msg=key
            )


@pytest.mark.parametrize("case", PLAN_CASES)
def test_huffman_plan_ref_matches_jax(case, monkeypatch):
    sym, n_sym, n_in_use, want_iters = plan_case(case)
    maxsel = huffman.max_selectors(sym.shape[1] - 2)
    sym_t, n_sym_t, niu_t = map(torch.from_numpy, (sym, n_sym, n_in_use))
    n_groups = huffman_cuda.table_count(n_sym_t.long())
    seed = huffman.seed_lengths(huffman.block_histogram(sym_t), n_groups, niu_t.long() + 2)
    depth_calls, refits = [], []
    real_depths = huffman_cuda.huffman_depths
    monkeypatch.setattr(huffman_cuda, "huffman_depths", lambda w, a: depth_calls.append(1) or real_depths(w, a))
    real_lengths = huffman_cuda.code_lengths_ref
    monkeypatch.setattr(huffman_cuda, "code_lengths_ref", lambda f, a: refits.append((f, a)) or real_lengths(f, a))
    # On the CPU the wrapper is the plain version.
    sel, sel_mtf, lengths, iters = huffman_cuda.huffman_plan(sym_t, n_sym_t, niu_t, seed, maxsel)
    want = jax.vmap(
        lambda s, ns, niu: jax_huff.huffman_assign(s, ns, None, niu, maxsel=maxsel)
    )(jnp.asarray(sym), jnp.asarray(n_sym), jnp.asarray(n_in_use))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want["selectors"]))
    np.testing.assert_array_equal(sel_mtf.numpy(), np.asarray(want["selector_mtf"]))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want["lengths"]))
    if want_iters is not None:
        assert iters.tolist() == want_iters
    if case == "table-counts-and-alphabets":
        assert sorted(set(n_groups.tolist())) == [2, 3, 4, 5, 6] and n_sym[0] < 50
        # Groups whose seed costs tie between tables: argmin takes the first.
        gfreq = huffman_cuda.group_frequencies(sym_t, maxsel).double()
        cost = torch.bmm(gfreq, seed.double().transpose(1, 2))
        live = torch.arange(6)[None, None, :] < n_groups[:, None, None]
        cost = torch.where(live, cost, float("inf"))
        ties = (cost == cost.min(2, keepdim=True).values).sum(2) > 1
        assert bool(ties.any())
    if case == "cap-retries":
        assert len(depth_calls) > int(iters.max())  # one tree pass an iteration, plus retries
        assert int(lengths.max()) == 17
    if case == "cap-retries-on-several-tables":
        # Three of one iteration's table refits flatten their weights twice.
        f, a = refits[0]
        assert sum(_cap_retries(f[i].numpy(), int(a[i])) >= 2 for i in range(f.shape[0])) == 3
