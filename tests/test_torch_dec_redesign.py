"""What the redesigned decode kernels rely on, on the CPU:

  * dec_symbols' first-level tables (ops/dec_cuda.first_level_tables_ref,
    the plain version its first pass is held to on the card), bucket by
    bucket against the whole LUT: the length a decode step takes where a
    bucket's entries all agree on it, 0 where they do not. Random int8
    LUTs over the full range and over 0..22, the build_len_luts rows of
    stdlib streams at levels 1, 2 and 9 (the same rows as bz2tpu's
    build_len_luts on JAX-CPU), and tables whose codes reach 20 bits;
  * mtf_dec's skip of a chunk's trailing zeros, through chunk_perms_ref: a
    step with index 0 leaves the list as it is and emits its front, on
    chunks that end in zeros at every offset 0..128 and chunks of zeros.

Every comparison is exact (integer codec, tolerance 0).
"""

import bz2 as stdlib_bz2

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bz2tpu.ops import huffman_dec as jax_huffman_dec  # noqa: E402
from bz2tpu_torch.ops import dec_cuda, huffman_dec, mtf_dec_cuda  # noqa: E402
from bz2tpu_torch.runtime import device_decode  # noqa: E402

from conftest import make_corpus  # noqa: E402
from dec_kernel_cases import deep_lengths, table_tensors, trailing_zero_rows  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (several worker processes
    share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _buckets_by_hand(lut: np.ndarray, bits: int) -> np.ndarray:
    """Each bucket of 2^(20 - bits) entries, one at a time: the step's
    length (above 20: 21; below 1: 1) where all entries agree, else 0."""
    step = np.where(lut > 20, 21, np.maximum(lut.astype(np.int16), 1))
    out = np.zeros((lut.shape[0], 1 << bits), np.uint8)
    width = 1 << (20 - bits)
    for r in range(lut.shape[0]):
        for k in range(1 << bits):
            bucket = step[r, k * width : (k + 1) * width]
            out[r, k] = bucket[0] if (bucket == bucket[0]).all() else 0
    return out


def _check_first_level(lut: torch.Tensor, bits: int) -> np.ndarray:
    got = dec_cuda.first_level_tables_ref(lut, bits)
    assert got.dtype == torch.uint8 and got.shape == (lut.shape[0], 1 << bits)
    want = _buckets_by_hand(lut.numpy(), bits)
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize("kind", ["full-range", "lengths-0-22", "runs"])
@pytest.mark.parametrize("bits", [10, 12])
def test_first_level_tables_of_random_luts_match_bucket_by_bucket(kind, bits):
    rng = np.random.default_rng(900 + bits)
    if kind == "full-range":
        lut = rng.integers(-128, 128, (2, 1 << 20))
    elif kind == "lengths-0-22":
        lut = rng.integers(0, 23, (2, 1 << 20))
    else:  # runs of one value of random lengths: uniform buckets and mixed ones
        vals = rng.integers(-3, 24, 4000)
        lut = np.repeat(vals, rng.integers(1, 1200, vals.size))[: 2 << 20].reshape(2, -1)
    want = _check_first_level(torch.from_numpy(lut.astype(np.int8)), bits)
    if kind == "runs":
        assert 0 < (want == 0).sum() < want.size  # both kinds of bucket occur


@pytest.mark.parametrize("level", [1, 2, 9])
def test_first_level_tables_of_stream_luts_match_bucket_by_bucket(level):
    rng = np.random.default_rng(910 + level)
    comp = stdlib_bz2.compress(make_corpus(rng, "text", 120_000) + make_corpus(rng, "random", 40_000), level)
    parsed, _ = device_decode.parse_blocks(comp)
    bt = device_decode.batch_tensors(parsed, torch.device("cpu"))
    lut = bt["lut"]
    thr = np.zeros((len(parsed) * 6 + 1, 21), np.int32)
    for r, p in enumerate(parsed):
        rows = huffman_dec.decode_tables_arrays(p["tables"])[3]
        thr[1 + 6 * r : 1 + 6 * r + rows.shape[0]] = rows
    # The LUT rows are bz2tpu's on JAX-CPU for the same thresholds.
    jax_lut = np.asarray(jax_huffman_dec.build_len_luts(jnp.asarray(thr)))
    for row in lut.numpy()[1:]:
        assert any((row == other).all() for other in jax_lut)
    want = _check_first_level(lut, dec_cuda.FIRST_BITS)
    # A real table's lengths rise with the window, so a bucket is marked
    # only where a code longer than FIRST_BITS bits starts in it.
    step = torch.where(lut > 20, 21, lut.clamp(min=1)).view(lut.shape[0], 1 << dec_cuda.FIRST_BITS, -1)
    assert (torch.from_numpy(want == 0) <= (step.amax(2) > dec_cuda.FIRST_BITS)).all()


@pytest.mark.parametrize("max_len", [14, 17, 20])
def test_first_level_tables_of_codes_up_to_20_bits(max_len):
    rng = np.random.default_rng(920 + max_len)
    tables = [deep_lengths(rng, alpha, max_len) for alpha in (max_len + 1, 60, 258)]
    lut = table_tensors(tables, 1, torch.device("cpu"))["lut"]
    assert int(lut[1:].max()) == max_len  # codes of max_len bits, nothing longer
    want = _check_first_level(lut, dec_cuda.FIRST_BITS)
    assert ((want[1:] == 0).sum(1) < 1 << dec_cuda.FIRST_BITS).all()
    # The chain 1, 2, ..., max_len: its codes longer than FIRST_BITS bits all
    # start with FIRST_BITS ones, so the last bucket of its row, and only
    # that, is marked.
    assert (want[1] == 0).sum() == 1 and want[1, -1] == 0


def test_first_level_tables_wrapper_on_the_cpu_and_its_checks():
    lut = torch.from_numpy(np.random.default_rng(930).integers(0, 23, (3, 1 << 20)).astype(np.int8))
    launches = dict(dec_cuda.LAUNCHES)
    np.testing.assert_array_equal(dec_cuda.first_level_tables(lut).numpy(),
                                  dec_cuda.first_level_tables_ref(lut).numpy())
    for bad in (lut.to(torch.uint8), lut[:, :4096].contiguous(), lut[:0], lut.view(-1)):
        with pytest.raises(ValueError):
            dec_cuda.first_level_tables(bad)
    assert dec_cuda.LAUNCHES == launches  # the CPU launches nothing
    with pytest.raises(ValueError, match="unsupported device"):
        dec_cuda.first_level_tables(lut.to("meta"))


def _walk(js_row: np.ndarray, n: int) -> tuple[np.ndarray, list[int]]:
    """The list after the first n moves of one chunk, and their emits."""
    q = list(range(256))
    emits = []
    for j in js_row[:n]:
        e = q.pop(int(j))
        q.insert(0, e)
        emits.append(e)
    return np.array(q, np.uint8), emits


@pytest.mark.parametrize("offsets", [(0, 32), (32, 64), (64, 96), (96, 129)])
def test_zero_steps_leave_the_list_and_emit_its_front(offsets):
    # Chunk c ends in zeros from offset c % 129: its steps after the last
    # nonzero index change nothing and emit the list's front, which is
    # what mtf_dec writes for them without walking them.
    rng = np.random.default_rng(940 + offsets[0])
    js = trailing_zero_rows(rng, 129)
    q, emit = mtf_dec_cuda.chunk_perms_ref(torch.from_numpy(js))
    q, emit = q.numpy()[0], emit.numpy()[0]
    for c in range(*offsets):
        row = js[0, 128 * c : 128 * (c + 1)]
        last = c % 129  # the first zero of the tail
        assert (row[:last] > 0).all() and (row[last:] == 0).all()
        q_walked, emits = _walk(row, last)
        np.testing.assert_array_equal(q[c], q_walked)
        np.testing.assert_array_equal(emit[c, :last], emits)
        assert (emit[c, last:] == q_walked[0]).all()


def test_chunks_of_zeros_give_the_identity_and_zero_emits():
    js = torch.zeros(3, 128 * 5, dtype=torch.uint8)
    js[1, 128 * 2 + 7] = 9  # one move in one chunk of row 1
    q, emit = mtf_dec_cuda.chunk_perms_ref(js)
    ident = torch.arange(256, dtype=torch.uint8)
    for b in range(3):
        for c in range(5):
            if (b, c) == (1, 2):
                continue
            assert torch.equal(q[b, c], ident) and not emit[b, c].any()
    want_q, want_emit = _walk(js[1, 256:384].numpy(), 128)
    np.testing.assert_array_equal(q[1, 2].numpy(), want_q)
    np.testing.assert_array_equal(emit[1, 2].numpy(), want_emit)
    assert (emit[1, 2, 8:] == 9).all()  # after the move, the front is entry 9
