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
from bz2tpu_torch.ops import huffman  # noqa: E402

from conftest import CORPUS_KINDS, make_corpus  # noqa: E402


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
    got = huffman.code_lengths(torch.from_numpy(freqs), torch.from_numpy(alphas)).numpy()
    assert got.max() <= 17
    for i in range(freqs.shape[0]):
        want = jax_huff.code_lengths(jnp.asarray(freqs[i], jnp.int32), jnp.int32(alphas[i]))
        np.testing.assert_array_equal(got[i], np.asarray(want))


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
    got = huffman.selector_mtf_ranks(torch.from_numpy(sel), torch.from_numpy(n_sel)).numpy()
    freqs, alphas = _freq_rows(rng)
    lengths = huffman.code_lengths(torch.from_numpy(freqs), torch.from_numpy(alphas))
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
