"""bz2tpu_torch BWT (K1 sort, K2 re-rank, the pair-doubling loop) against
the JAX package: lax.sort, the Pallas kernels in interpret mode, and
bz2tpu.ops.bwt.bwt_encode. All comparisons are exact (integer codec).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from bz2tpu.ops.bwt import _head_positions, _tied, bwt_encode as jax_bwt_encode  # noqa: E402
from bz2tpu.ops.bwt_pallas import (  # noqa: E402
    bitonic_sort_pallas,
    bwt_encode_pallas,
    rerank_pallas,
)
from bz2tpu_torch.ops import bwt_cuda  # noqa: E402
from bz2tpu_torch.ops.bwt import bwt_encode, bwt_stage  # noqa: E402

from conftest import CORPUS_KINDS, make_corpus  # noqa: E402


def _lax_sort(*cols):
    outs = lax.sort(tuple(jnp.asarray(c) for c in cols), num_keys=len(cols))
    return [np.asarray(o) for o in outs]


def _unpack(keys, widths):
    """Split packed keys into fields, most significant first."""
    k = keys.numpy().astype(np.int64)
    out = []
    for w in reversed(widths):
        out.append(k & ((1 << w) - 1))
        k = k >> w
    return out[::-1]


@pytest.mark.parametrize("n", [128, 200, 1024, 5000])
def test_sort_pairs_random(rng, n):
    keys = rng.integers(0, 50, n).astype(np.int32)  # many duplicates
    vals = rng.permutation(n).astype(np.int32)
    packed = torch.from_numpy((keys.astype(np.int64) << 13) | vals)
    got = _unpack(bwt_cuda.sort_keys_ref(packed, 0, 19), (6, 13))
    want = _lax_sort(keys, vals)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if n <= 1024:
        pal = bitonic_sort_pallas((jnp.asarray(keys), jnp.asarray(vals)), interpret=True)
        for g, p in zip(got, pal):
            np.testing.assert_array_equal(g, np.asarray(p))


def test_sort_three_operands_stable_tiebreak(rng):
    # The index column is never sorted on: stability is the tie-break.
    n = 2000
    k1 = rng.integers(0, 20, n).astype(np.int32)
    k2 = rng.integers(-1, 20, n).astype(np.int32)  # -1 appears (s1 sentinel)
    val = np.arange(n, dtype=np.int32)
    packed = (k1.astype(np.int64) << 22) | ((k2.astype(np.int64) + 1) << 11) | val
    got = _unpack(bwt_cuda.sort_keys_ref(torch.from_numpy(packed), 11, 27), (5, 11, 11))
    got[1] -= 1
    want = _lax_sort(k1, k2, val)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pal = bitonic_sort_pallas(tuple(jnp.asarray(c) for c in (k1, k2, val)), interpret=True)
    for g, p in zip(got, pal):
        np.testing.assert_array_equal(g, np.asarray(p))


def _xla_rerank(cols):
    """The XLA chain of ops/bwt.py full_round on sorted key columns."""
    neq = None
    for c in cols:
        c = jnp.asarray(c)
        d = c[1:] != c[:-1]
        neq = d if neq is None else (neq | d)
    head = jnp.concatenate([jnp.ones((1,), jnp.bool_), neq])
    return np.asarray(_head_positions(head)), int(jnp.sum(_tied(head).astype(jnp.int32)))


def test_rerank_inverse_permutation(rng):
    # K2 writes rank[order[i]] = pos[i]: the TPU path's third sort.
    n = 900
    group = np.sort(rng.integers(0, 60, n)).astype(np.int64)
    order = rng.permutation(n).astype(np.int32)
    rank, _ = bwt_cuda.rerank_ref(torch.from_numpy((group << 10) | order), 10)
    pos, _ = _xla_rerank((group.astype(np.int32),))
    _, want = bitonic_sort_pallas((jnp.asarray(order), jnp.asarray(pos)), interpret=True)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [256, 777, 4096])
def test_rerank_single_key(rng, n):
    k = np.sort(rng.integers(0, n // 3, n)).astype(np.int32)
    rank, active = bwt_cuda.rerank_ref(torch.from_numpy((k.astype(np.int64) << 13) | np.arange(n)), 13)
    pal_pos, pal_active = rerank_pallas((jnp.asarray(k),), tile=1024, interpret=True)
    want_pos, want_active = _xla_rerank((k,))
    np.testing.assert_array_equal(rank.numpy(), want_pos)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(pal_pos))
    assert int(active) == want_active == int(pal_active)


def test_rerank_two_keys(rng):
    n = 3000
    k1 = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    k2 = rng.integers(-1, 25, n).astype(np.int32)
    order = np.lexsort((k2, k1))
    k1, k2 = k1[order], k2[order]
    packed = (k1.astype(np.int64) << 17) | ((k2.astype(np.int64) + 1) << 12) | np.arange(n)
    rank, active = bwt_cuda.rerank_ref(torch.from_numpy(packed), 12)
    pal_pos, pal_active = rerank_pallas((jnp.asarray(k1), jnp.asarray(k2)), tile=512, interpret=True)
    want_pos, want_active = _xla_rerank((k1, k2))
    np.testing.assert_array_equal(rank.numpy(), want_pos)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(pal_pos))
    assert int(active) == want_active == int(pal_active)


def test_rerank_all_distinct_and_all_equal():
    n = 512
    iota = np.arange(n, dtype=np.int64)
    rank, active = bwt_cuda.rerank_ref(torch.from_numpy((iota << 9) | iota), 9)
    np.testing.assert_array_equal(rank.numpy(), iota)
    assert int(active) == 0
    rank, active = bwt_cuda.rerank_ref(torch.from_numpy(iota), 9)
    np.testing.assert_array_equal(rank.numpy(), np.zeros(n))
    assert int(active) == n


def test_wrappers_take_plain_version_on_cpu_and_check_inputs(rng):
    keys = torch.from_numpy(rng.integers(0, 1 << 40, 3000))
    torch.testing.assert_close(bwt_cuda.sort_keys(keys, 5, 40), bwt_cuda.sort_keys_ref(keys, 5, 40), rtol=0, atol=0)
    with pytest.raises(ValueError):
        bwt_cuda.sort_keys(keys.to(torch.int32), 0, 8)
    with pytest.raises(ValueError):
        bwt_cuda.rerank(keys[::2], 4)


def _bwt_pair(data: bytes, capacity: int, *, pallas: bool = False):
    arr = np.zeros(capacity, np.uint8)
    arr[: len(data)] = np.frombuffer(data, np.uint8)
    got_last, got_ptr = bwt_encode(torch.from_numpy(arr), len(data))
    want = jax_bwt_encode(jnp.asarray(arr), jnp.int32(len(data)))
    np.testing.assert_array_equal(got_last.numpy(), np.asarray(want[0]))
    assert int(got_ptr) == int(want[1])
    if pallas:
        pal = bwt_encode_pallas(jnp.asarray(arr), jnp.int32(len(data)), interpret=True)
        np.testing.assert_array_equal(got_last.numpy(), np.asarray(pal[0]))
        assert int(got_ptr) == int(pal[1])


@pytest.mark.parametrize("kind", CORPUS_KINDS)
def test_bwt_matches_jax_corpus(rng, kind):
    _bwt_pair(make_corpus(rng, kind, 700), 1024, pallas=kind in ("text", "runs"))


def test_bwt_periodic_blocks():
    # Full round count and ties that survive k >= n (identical rotations).
    _bwt_pair(bytes(bytearray(range(1, 8)) * 100), 1024, pallas=True)
    _bwt_pair(b"ab" * 300, 1024)
    _bwt_pair(b"abcabcabd" * 90, 1024)


@pytest.mark.parametrize("data", [b"a", b"ab", b"ba", b"aaa", b"abcd", b"zzzzy"])
def test_bwt_tiny_blocks(data):
    _bwt_pair(data, 256, pallas=len(data) < 4)


def test_bwt_partial_capacity(rng):
    _bwt_pair(make_corpus(rng, "text", 100), 1024, pallas=True)


def test_bwt_stage_batch(rng):
    from bz2tpu.ops.pipeline import bwt_stage as jax_bwt_stage

    cap, B = 512, 3
    blocks = np.zeros((B, cap), np.uint8)
    ns = np.zeros(B, np.int32)
    for i, kind in enumerate(("text", "runs", "alternating")):
        d = np.frombuffer(make_corpus(rng, kind, 300 + 50 * i), np.uint8)
        blocks[i, : d.size] = d
        ns[i] = d.size
    got_last, got_ptr = bwt_stage(torch.from_numpy(blocks), torch.from_numpy(ns))
    want_last, want_ptr = jax_bwt_stage(jnp.asarray(blocks), jnp.asarray(ns))
    np.testing.assert_array_equal(got_last.numpy(), np.asarray(want_last))
    np.testing.assert_array_equal(got_ptr.numpy(), np.asarray(want_ptr))
    assert got_ptr.dtype == torch.int32
