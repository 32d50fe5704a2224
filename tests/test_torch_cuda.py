"""bz2tpu_torch's CUDA kernels on the card: each kernel against its plain
torch version (exact), the stages and the whole stream on the card against
the CPU path, for compress, compress_device_intake and decompress_device.

Every test needs a CUDA card and skips without one. The file imports no
JAX and nothing from conftest, so on a machine with a card and without JAX
it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import bz2 as stdlib_bz2

import numpy as np
import pytest
import torch

import bz2tpu_torch
from bz2tpu_torch.ops import bwt_cuda, dec_cuda, mtf, mtf_cuda
from bz2tpu_torch.ops.bwt import bwt_stage, pair_keys, round0_keys
from bz2tpu_torch.runtime import device_decode

pytestmark = pytest.mark.cuda

WORDS = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps  ", b"over\n", b"lazy ", b"dog. "]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _corpus(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "text":
        words = rng.integers(len(WORDS), size=n // 3 + 1)
        return np.frombuffer(b"".join(WORDS[i] for i in words)[:n], np.uint8)
    if kind == "runs":
        vals = rng.integers(0, 5, n // 50 + 1, dtype=np.uint8)
        return np.repeat(vals, rng.integers(1, 300, vals.size))[:n]
    return rng.integers(0, 256, n, dtype=np.uint8)


def _equal(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["text", "runs", "random"])
def test_bwt_kernels_match_plain(cuda, kind):
    data = torch.from_numpy(_corpus(kind, 60_000, 1).copy()).to(cuda)
    keys, nb, k = round0_keys(data.to(torch.int64))
    sorted0 = bwt_cuda.sort_keys(keys, nb, nb + 24)
    _equal(sorted0, bwt_cuda.sort_keys_ref(keys, nb, nb + 24))
    rank, active = bwt_cuda.rerank(sorted0, nb)
    want_rank, want_active = bwt_cuda.rerank_ref(sorted0, nb)
    _equal(rank, want_rank)
    _equal(active, want_active)
    keys1 = pair_keys(rank, k, nb)
    sorted1 = bwt_cuda.sort_keys(keys1, nb, 3 * nb)
    _equal(sorted1, bwt_cuda.sort_keys_ref(keys1, nb, 3 * nb))
    for got, want in zip(bwt_cuda.rerank(sorted1, nb), bwt_cuda.rerank_ref(sorted1, nb)):
        _equal(got, want)


def test_sort_odd_bit_ranges_and_sizes(cuda):
    rng = np.random.default_rng(2)
    # 1,000,003 keys: 62,720 digit counters, several chunks of the block scan.
    for n, lo, hi in [(1, 0, 8), (4095, 3, 17), (4097, 0, 63), (100_001, 20, 61), (1_000_003, 0, 24)]:
        keys = torch.from_numpy(rng.integers(0, 1 << 62, n)).to(cuda)
        _equal(bwt_cuda.sort_keys(keys, lo, hi), bwt_cuda.sort_keys_ref(keys, lo, hi))


def test_rerank_over_many_scan_chunks(cuda):
    # 2^24 + 5 positions: 8,193 tiles of maxima, more than one chunk of
    # the block scan.
    n, idx_bits = (1 << 24) + 5, 25
    gen = torch.Generator(device=cuda).manual_seed(4)
    groups = torch.sort(torch.randint(0, n // 3, (n,), device=cuda, generator=gen)).values
    keys = (groups << idx_bits) | torch.randperm(n, device=cuda, generator=gen)
    for got, want in zip(bwt_cuda.rerank(keys, idx_bits), bwt_cuda.rerank_ref(keys, idx_bits)):
        _equal(got, want)


def test_bwt_stage_matches_cpu(cuda):
    blocks = np.zeros((3, 30_000), np.uint8)
    for i, kind in enumerate(("text", "runs", "random")):
        blocks[i] = _corpus(kind, 30_000, 3 + i)
    ns = torch.tensor([30_000, 29_000, 3], dtype=torch.int32)
    want = bwt_stage(torch.from_numpy(blocks), ns)
    got = bwt_stage(torch.from_numpy(blocks).to(cuda), ns.to(cuda))
    for g, w in zip(got, want):
        _equal(g.cpu(), w)


def test_mtf_ranks_kernel_matches_plain(cuda):
    blocks = np.zeros((3, 40_000), np.uint8)
    for i, kind in enumerate(("text", "random", "runs")):
        blocks[i] = _corpus(kind, 40_000, 7 + i)
    ns = torch.tensor([40_000, 40_000, 12_345], dtype=torch.int32, device=cuda)
    last, _ = bwt_stage(torch.from_numpy(blocks).to(cuda), ns)
    cseq, _, m, _, n_in_use = mtf.collapse(last, ns)
    for chunk in (2048, 100):
        _equal(mtf_cuda.mtf_ranks(cseq, n_in_use, m, chunk), mtf_cuda.mtf_ranks_ref(cseq, n_in_use, m, chunk))


def test_wrappers_reject_bad_inputs_on_card(cuda):
    keys = torch.arange(10, device=cuda)
    with pytest.raises(ValueError):
        bwt_cuda.sort_keys(keys.to(torch.int32), 0, 8)
    with pytest.raises(ValueError):
        mtf_cuda.mtf_ranks(keys.view(2, 5).to(torch.int32), torch.ones(2, dtype=torch.int32), torch.ones(2, dtype=torch.int32, device=cuda))


def test_dec_chain_kernel_matches_plain(cuda):
    rng = np.random.default_rng(5)
    B, T, nbc, G = 8, 6, 300_000, 2_000
    # Forward jumps of 50..1000 bits clipped at the end, as jump50 maps are.
    jump50 = np.minimum(np.arange(nbc) + rng.integers(50, 1000, (B, T, nbc)), nbc - 1).astype(np.int32)
    tbl = rng.integers(0, T, (B, G)).astype(np.int32)
    n_groups = np.array([G, 1, 0, 1999, 1000, 17, G, 3], np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (jump50, tbl, n_groups)]
    launches = dec_cuda.LAUNCHES["dec_chain"]
    _equal(dec_cuda.group_starts(*args), dec_cuda.group_starts_ref(*args))
    assert dec_cuda.LAUNCHES["dec_chain"] == launches + 1
    with pytest.raises(ValueError):
        dec_cuda.group_starts(args[0], args[1].long(), args[2])


def test_decompress_device_on_card_matches_cpu(cuda):
    data = b"".join(_corpus(kind, 250_000, 21 + i).tobytes() for i, kind in enumerate(("text", "runs", "random")))
    for level in (1, 9):
        comp = stdlib_bz2.compress(data, level)
        dec_cuda.LAUNCHES["dec_chain"] = 0
        assert device_decode._decompress_device_inner(comp, True, cuda) == data  # no host fallback
        assert dec_cuda.LAUNCHES["dec_chain"] > 0
        assert device_decode._decompress_device_inner(comp, True, torch.device("cpu")) == data
        assert bz2tpu_torch.decompress_device(comp) == data
    bad = bytearray(stdlib_bz2.compress(data, 1))
    bad[len(bad) // 2] ^= 0x10
    with pytest.raises(ValueError):
        bz2tpu_torch.decompress_device(bytes(bad))


def test_compress_device_intake_on_card_matches_cpu(cuda):
    data = b"".join(_corpus(kind, 150_000, 31 + i).tobytes() for i, kind in enumerate(("text", "runs", "random")))
    data = bytes(300_000) + data  # escalates the window first
    out = bz2tpu_torch.compress_device_intake(data, level=1, parallel=2)
    assert out == bz2tpu_torch.compress_device_intake(data, level=1, parallel=2, device="cpu")
    assert stdlib_bz2.decompress(out) == data


def test_compress_on_card_matches_cpu_and_counts_launches(cuda):
    data = b"".join(_corpus(kind, 120_000, 11 + i).tobytes() for i, kind in enumerate(("text", "runs", "random")))
    for counts in (bwt_cuda.LAUNCHES, mtf_cuda.LAUNCHES):
        for name in counts:
            counts[name] = 0
    out = bz2tpu_torch.compress(data, level=1)
    assert min(bwt_cuda.LAUNCHES.values()) > 0 and mtf_cuda.LAUNCHES["mtf_ranks"] > 0
    assert out == bz2tpu_torch.compress(data, level=1, device="cpu")
    assert stdlib_bz2.decompress(out) == data
