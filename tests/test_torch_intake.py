"""bz2tpu_torch's device intake against the JAX package: crc32_ranges,
rle1_encode, block_cuts and device_intake stage by stage, and
compress_device_intake(device="cpu") byte for byte against
bz2tpu.compress_device_intake on the JAX tests' inputs. Inputs come from
numpy seeds; every comparison is exact (integer codec, tolerance 0).
"""

import bz2 as stdlib_bz2

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bz2tpu.format import constants as C  # noqa: E402
from bz2tpu.format.crc32 import crc32  # noqa: E402
from bz2tpu.ops import crc as jax_crc  # noqa: E402
from bz2tpu.ops import intake as jax_intake  # noqa: E402
from bz2tpu.ops import rle1 as jax_rle1  # noqa: E402
from bz2tpu.runtime.compressor import compress_device_intake as jax_compress_device_intake  # noqa: E402
from bz2tpu_torch.ops import crc, intake, rle1  # noqa: E402
from bz2tpu_torch.runtime.compressor import compress_device_intake  # noqa: E402

from conftest import make_corpus  # noqa: E402


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:  # the port carries 32-bit words in int64
        want = want.astype(np.int64)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1 << 17, 3 * 4096])
def test_crc32_ranges_matches_jax_and_crc32(n):
    rng = np.random.default_rng(31)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    starts = np.array([0, 0, 100, 555, n - 96, n, 0, 17, 4096], dtype=np.int32)
    ends = np.array([n, 1, 2000, 556, n, n, n - 1, 17, n // 2], dtype=np.int32)
    want = [crc32(data[a:b]) for a, b in zip(starts, ends)]
    # The port's default lane count (65,536, or the largest power of two
    # dividing n) against JAX's default of 4,096.
    got = crc.crc32_ranges(torch.from_numpy(data), torch.from_numpy(starts), torch.from_numpy(ends))
    jax_got = jax_crc.crc32_ranges(jnp.asarray(data), jnp.asarray(starts), jnp.asarray(ends))
    assert got.tolist() == want
    _equal(got, jax_got)
    # The same lane count on both sides.
    small = crc.crc32_ranges(torch.from_numpy(data), torch.from_numpy(starts), torch.from_numpy(ends), lanes=64)
    assert small.tolist() == want


@pytest.mark.parametrize("kind", ["text", "runs", "zeros", "random"])
def test_rle1_encode_matches_jax(kind):
    rng = np.random.default_rng(32)
    N = 1 << 16
    for n in (0, 1, 3, 4, 255, 256, 259, 260, 1000, 50_000, N):
        data = np.frombuffer(make_corpus(rng, kind, n), np.uint8) if n else np.zeros(0, np.uint8)
        padded = rng.integers(0, 256, N, dtype=np.uint8)  # bytes past n are ignored
        padded[:n] = data
        got = rle1.rle1_encode(torch.from_numpy(padded), n)
        want = jax_rle1.rle1_encode(jnp.asarray(padded), n)
        assert got.keys() == want.keys()
        for key in got:
            _equal(got[key], want[key])


@pytest.mark.parametrize("kind,max_blocks", [("text", 8), ("runs", 2), ("zeros", 4)])
def test_block_cuts_match_jax(kind, max_blocks):
    rng = np.random.default_rng(33)
    n, N = 250_000, 1 << 18
    padded = np.zeros(N, np.uint8)
    padded[:n] = np.frombuffer(make_corpus(rng, kind, n), np.uint8)
    enc = rle1.rle1_encode(torch.from_numpy(padded), n)
    cap = C.block_capacity(1)
    got = rle1.block_cuts(enc["piece_out_cum"], enc["piece_raw_cum"], enc["n_pieces"], cap=cap, max_blocks=max_blocks)
    jenc = jax_rle1.rle1_encode(jnp.asarray(padded), n)
    want = jax_rle1.block_cuts(
        jenc["piece_out_cum"], jenc["piece_raw_cum"], jenc["n_pieces"], cap=cap, max_blocks=max_blocks
    )
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("kind,n", [("text", 250_000), ("runs", 180_000), ("random", 90_000), ("text", 50)])
def test_device_intake_matches_jax(kind, n):
    rng = np.random.default_rng(34)
    N = intake.chunk_capacity(1, 4)
    assert N == jax_intake.chunk_capacity(1, 4)
    padded = np.zeros(N, np.uint8)
    padded[:n] = np.frombuffer(make_corpus(rng, kind, n), np.uint8)
    got = intake.device_intake(torch.from_numpy(padded), n, level=1, max_blocks=4)
    want = jax_intake.device_intake(jnp.asarray(padded), jnp.int32(n), level=1, max_blocks=4)
    assert got.keys() == want.keys()
    for key in got:
        _equal(got[key], want[key])


def _both(data: bytes, **kw) -> bytes:
    out = compress_device_intake(data, device="cpu", **kw)
    assert out == jax_compress_device_intake(data, **kw)
    assert stdlib_bz2.decompress(out) == data
    return out


@pytest.mark.parametrize("kind,n", [("text", 300_000), ("runs", 200_000), ("zeros", 500_000), ("text", 50)])
def test_compress_device_intake_matches_jax(kind, n):
    _both(make_corpus(np.random.default_rng(112), kind, n), level=1, parallel=2)


@pytest.mark.parametrize("level", [1, 9])
def test_compress_device_intake_empty_matches_jax(level):
    _both(b"", level=level)


def test_compress_device_intake_escalate_then_reset_matches_jax():
    # A zero prefix RLE1s a whole chunk into one under-full block, so the
    # window widens; the random tail then fills a batch and it drops back.
    rng = np.random.default_rng(77)
    data = b"\x00" * 600_000 + rng.integers(0, 256, 700_000, dtype=np.uint8).tobytes()
    _both(data, level=1, parallel=2)


def test_compress_device_intake_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compress_device_intake(b"abc")
