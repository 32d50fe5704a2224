"""bz2tpu_torch's CUDA kernels on the card: each kernel against its plain
torch version (exact), the stages and the whole stream on the card against
the CPU path, for compress (levels 1 and 5), compress_device_intake (with
its crc_ranges and block_cuts kernels at edge shapes and at an 8 MiB
chunk, once each per intake call of an escalating input),
decompress_device (with its dec_symbols and mtf_dec kernels at the
decode's own shapes, on a good and a corrupt stream; dec_symbols' first
pass, and both on random inputs, on tables whose codes reach 20 bits and
on chunks that end in zeros at every offset; rle1_dec and crc_ranges, the
inverse RLE1 and block CRCs, on every row family of
tests/rle1_dec_cases.py, a decode's rows, rows off alignment and 8 rows at
the output bound, and in a decode that never calls the host's inverse
RLE1), the stream and file layer (compress_file, a
checkpoint resumed, BZ2File), the per-block encode of the block mesh
(encode_blocks, pack_blocks then concat_block_words), the per-block
compress path (BZ2TPU_DEVICE_STITCH=0) and an exported build with kernels
that spares a fresh process nvcc.

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
from bz2tpu_torch.ops import bwt, bwt_cuda, dec_cuda, huffman, huffman_cuda, huffman_dec, mtf, mtf_cuda, mtf_dec
from bz2tpu_torch.ops import crc, crc_cuda, intake, mtf_dec_cuda, rle1, rle1_cuda, rle1_dec, rle1_dec_cuda
from bz2tpu_torch.ops.bwt import bwt_stage
from bz2tpu_torch.format import constants as C
from bz2tpu_torch.format.crc32 import crc32, crc32_serial
from bz2tpu_torch.runtime import compressor, device_decode
from bz2tpu_torch.runtime.compressor import _batch_tensors, split_blocks
from bz2tpu_torch.oracle.decoder import Bz2CrcError
from bz2tpu_torch.utils import profiling
from bz2tpu_torch.utils.corpus import make_mixed_corpus

from dec_kernel_cases import deep_lengths, table_tensors, trailing_zero_rows
from rle1_dec_cases import FAMILIES, as_batch, decode_rows, stdlib_stream, text
from huffman_cases import PLAN_CASES, plan_case

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
    # A batch of three blocks in one sort: round 0 and the first pair round,
    # K1 and the slot-aware K2 against their plain versions.
    ns = [60_000, 41_000, 3]
    blocks = torch.from_numpy(np.stack([_corpus(kind, 60_000, 1 + i) for i in range(3)])).to(cuda)
    nb = max(ns).bit_length()
    lay = bwt.layout([0, 1, 2], ns, cuda)
    offsets = lay.off.to(torch.int32)
    keys, hi = bwt.round0_keys(blocks, lay, nb)
    sorted0 = bwt_cuda.sort_keys(keys, nb, hi)
    _equal(sorted0, bwt_cuda.sort_keys_ref(keys, nb, hi))
    rank, active = bwt_cuda.rerank(sorted0, nb, nb + 24, offsets)
    want_rank, want_active = bwt_cuda.rerank_ref(sorted0, nb, nb + 24, offsets)
    _equal(rank, want_rank)
    _equal(active, want_active)
    k = torch.tensor([3, 3, 1], device=cuda)
    keys1, hi1 = bwt.pair_keys(rank, k, lay, nb)
    sorted1 = bwt_cuda.sort_keys(keys1, nb, hi1)
    _equal(sorted1, bwt_cuda.sort_keys_ref(keys1, nb, hi1))
    for got, want in zip(bwt_cuda.rerank(sorted1, nb, 3 * nb, offsets),
                         bwt_cuda.rerank_ref(sorted1, nb, 3 * nb, offsets)):
        _equal(got, want)


def test_bwt_stage_sorts_once_per_round(cuda):
    blocks = np.zeros((4, 20_000), np.uint8)
    for i, kind in enumerate(("text", "runs", "random", "text")):
        blocks[i] = _corpus(kind, 20_000, 41 + i)
    blocks[3, :10_000] = blocks[3, 10_000:]  # a block that needs more rounds
    ns = torch.tensor([20_000, 19_000, 20_000, 20_000], dtype=torch.int32)
    per_block = []
    for i in range(4):
        bwt_cuda.LAUNCHES["bwt_sort"] = 0
        bwt_stage(torch.from_numpy(blocks[i : i + 1]).to(cuda), ns[i : i + 1])
        per_block.append(bwt_cuda.LAUNCHES["bwt_sort"])
    bwt_cuda.LAUNCHES["bwt_sort"] = 0
    got = bwt_stage(torch.from_numpy(blocks).to(cuda), ns.to(cuda))
    assert bwt_cuda.LAUNCHES["bwt_sort"] == max(per_block) < sum(per_block)
    for g, w in zip(got, bwt_stage(torch.from_numpy(blocks), ns)):
        _equal(g.cpu(), w)


def _plan_inputs(sym, n_sym, n_in_use, device):
    """huffman_plan's inputs on ``device``, seeded as huffman_assign seeds."""
    sym, n_sym, n_in_use = (torch.as_tensor(a).to(device) for a in (sym, n_sym, n_in_use))
    seed = huffman.seed_lengths(huffman.block_histogram(sym), huffman_cuda.table_count(n_sym.long()),
                                n_in_use.long() + 2)
    return sym, n_sym, n_in_use, seed, huffman.max_selectors(sym.shape[1] - 2)


def _plan_twice(args):
    """D2 against its plain version, twice on the same inputs."""
    want = huffman_cuda.huffman_plan_ref(*args)
    launches = huffman_cuda.LAUNCHES["huffman_plan"]
    for _ in range(2):
        for got, w in zip(huffman_cuda.huffman_plan(*args), want):
            _equal(got, w)
    assert huffman_cuda.LAUNCHES["huffman_plan"] == launches + 2
    return want


@pytest.mark.parametrize("case", PLAN_CASES)
def test_huffman_plan_kernel_matches_plain(cuda, case):
    # Blocks stopping at iterations 2-5 and running all 32, one group,
    # alphabets 3, 4, 42, 130, 257 and 258, 2..6 tables, seed costs that
    # tie, a table that needs cap retries and three that need two each.
    sym, n_sym, n_in_use, iters = plan_case(case)
    want = _plan_twice(_plan_inputs(sym, n_sym, n_in_use, cuda))
    if iters is not None:
        assert want[3].tolist() == iters


def test_huffman_plan_on_the_corpus_first_batch(cuda):
    corpus = make_mixed_corpus(8 * 900_000)
    blocks = split_blocks(corpus, 9)[:8]
    blocks_t, ns, _ = _batch_tensors(blocks, cuda)
    last, _ = bwt_stage(blocks_t, ns)
    plan = mtf.mtf_rle2_plan(last, ns)
    width = int(plan["n_sym"].max())
    sym = mtf.rle2_out(plan, width)
    want = _plan_twice(_plan_inputs(sym, plan["n_sym"], plan["n_in_use"], cuda))
    assert int(want[3].min()) >= 2


def test_huffman_assign_leaves_no_host_sync(cuda):
    sym, n_sym, n_in_use, _ = plan_case("table-counts-and-alphabets")
    sym, n_sym, n_in_use = (torch.from_numpy(a).to(cuda) for a in (sym, n_sym, n_in_use))
    maxsel = huffman.max_selectors(sym.shape[1] - 2)
    want = huffman.huffman_assign(sym.cpu(), n_sym.cpu(), n_in_use.cpu(), maxsel)
    huffman_cuda.huffman_plan(*_plan_inputs(sym, n_sym, n_in_use, cuda))  # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = huffman.huffman_assign(sym, n_sym, n_in_use, maxsel)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for key in want:
        _equal(got[key].cpu(), want[key])


def test_sort_odd_bit_ranges_and_sizes(cuda):
    rng = np.random.default_rng(2)
    # 7,200,000 keys over 43 bits: a level-9 pair round of 8 blocks.
    for n, lo, hi in [(1, 0, 8), (4095, 3, 17), (4097, 0, 63), (100_001, 20, 61), (1_000_003, 0, 24),
                      (7_200_000, 20, 63)]:
        keys = torch.from_numpy(rng.integers(0, 1 << 62, n)).to(cuda)
        _equal(bwt_cuda.sort_keys(keys, lo, hi), bwt_cuda.sort_keys_ref(keys, lo, hi))


def _rerank_twice(keys, idx_bits, slot_shift=63, offsets=None):
    """K2 against its plain version, twice on the same inputs: the second
    call finds nothing of the first one's look-back left behind."""
    want = bwt_cuda.rerank_ref(keys, idx_bits, slot_shift, offsets)
    for _ in range(2):
        for got, w in zip(bwt_cuda.rerank(keys, idx_bits, slot_shift, offsets), want):
            _equal(got, w)


def test_rerank_over_many_scan_chunks(cuda):
    # 2^24 + 5 positions: 8,193 tiles, each behind the look-back of the
    # ones before it.
    n, idx_bits = (1 << 24) + 5, 25
    gen = torch.Generator(device=cuda).manual_seed(4)
    groups = torch.sort(torch.randint(0, n // 3, (n,), device=cuda, generator=gen)).values
    keys = (groups << idx_bits) | torch.randperm(n, device=cuda, generator=gen)
    _rerank_twice(keys, idx_bits)


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 6145])
def test_rerank_around_a_tile(cuda, n):
    # One key, and a tile (2,048 keys) less one, exactly, plus one.
    rng = np.random.default_rng(n)
    groups = np.sort(rng.integers(0, n // 3 + 1, n))
    keys = torch.from_numpy((groups << 13) | rng.permutation(n)).to(cuda)
    _rerank_twice(keys, 13)


def test_rerank_of_a_view_off_16_byte_alignment(cuda):
    # keys[1:] starts 8 bytes into its storage: the tile loads fall back
    # from 128-bit to 64-bit.
    rng = np.random.default_rng(3)
    n = 10_000
    groups = np.sort(rng.integers(0, n // 3, n))
    packed = np.concatenate([[0], (groups << 14) | rng.permutation(n)])
    keys = torch.from_numpy(packed).to(cuda)[1:]
    assert keys.data_ptr() % 16 == 8 and keys.is_contiguous()
    _rerank_twice(keys, 14)


@pytest.mark.parametrize("case", ["one-group", "long-group-inside", "all-distinct"])
def test_rerank_group_shapes(cuda, case):
    # A group of equal keys over more than 1,000 tiles: its tiles hold no
    # head and take their rank from far behind them.
    n, idx_bits = 2048 * 1200 + 77, 22
    if case == "one-group":
        groups = torch.zeros(n, dtype=torch.int64, device=cuda)
    elif case == "long-group-inside":
        long = 2048 * 1100 + 5
        groups = torch.cat([torch.arange(3001), torch.full((long,), 3001),
                            3002 + torch.arange(n - long - 3001) // 2]).to(cuda)
    else:
        groups = torch.arange(n, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    keys = (groups << idx_bits) | torch.randperm(n, device=cuda, generator=gen)
    _rerank_twice(keys, idx_bits)


def test_rerank_64_slots(cuda):
    rng = np.random.default_rng(12)
    ns = rng.integers(1, 30_000, 64)
    ns[[0, 17, 63]] = [1, 1, 2]
    nb, parts = 15, []
    for s, n in enumerate(ns):
        groups = np.sort(rng.integers(0, n // 4 + 1, n))
        parts.append((s << 40) | (groups << nb) | rng.permutation(n))
    keys = torch.from_numpy(np.concatenate(parts)).to(cuda)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(ns)[:-1]]).astype(np.int32)).to(cuda)
    _rerank_twice(keys, nb, 40, offsets)


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


def _collapsed(rng, n_sym: int, length: int, skew: bool = False) -> np.ndarray:
    """A sequence over n_sym symbols with adjacent entries distinct."""
    if n_sym == 1:
        return np.zeros(1, np.int32)
    if skew:
        x = np.minimum(rng.zipf(1.3, 3 * length) - 1, n_sym - 1)
        return x[np.r_[True, x[1:] != x[:-1]]][:length].astype(np.int32)
    return (np.cumsum(rng.integers(1, n_sym, length)) % n_sym).astype(np.int32)


@pytest.mark.parametrize("chunk", [32, 256, 2048])
def test_mtf_ranks_rows_of_every_shape(cuda, chunk):
    # Rows of m = cap, m = 1 and m far below cap, alphabets of 1, 2 and 256;
    # twice on the same inputs.
    rng = np.random.default_rng(chunk)
    cap = 70_001
    rows = [(256, cap, False), (2, 1234, False), (1, 1, False), (90, 40_000, True),
            (40, 300, True), (256, 9_000, True), (33, cap, False)]
    seq = np.full((len(rows), cap), -1, np.int32)
    m = np.zeros(len(rows), np.int32)
    for i, (n_sym, length, skew) in enumerate(rows):
        row = _collapsed(rng, n_sym, length, skew)
        seq[i, : row.size] = row
        m[i] = row.size
    assert m[0] == cap and m[2] == 1
    args = [torch.from_numpy(a).to(cuda) for a in (seq, np.array([r[0] for r in rows], np.int32), m)]
    want = mtf_cuda.mtf_ranks_ref(*args, 2048)
    launches = mtf_cuda.LAUNCHES["mtf_ranks"]
    for _ in range(2):
        _equal(mtf_cuda.mtf_ranks(*args, chunk), want)
    assert mtf_cuda.LAUNCHES["mtf_ranks"] == launches + 2


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
    with pytest.raises(ValueError):
        dec_cuda.group_starts(args[0], args[1], args[2][:4])


def _jump_map(gen, B, T, nbc, lo, hi):
    """(B, T, nbc) int32 jumps of lo..hi - 1 bits (per table when lo, hi
    are (B, T) tensors), clipped to [0, nbc - 1] as jump50 maps are."""
    dev = gen.device
    lo, hi = (torch.as_tensor(x, device=dev).expand(B, T)[..., None] for x in (lo, hi))
    step = lo + (torch.rand(B, T, nbc, device=dev, generator=gen) * (hi - lo)).long()
    return (torch.arange(nbc, device=dev) + step).clamp(0, nbc - 1).to(torch.int32)


def _chain_twice(jump50, tbl, n_groups):
    """D1 against its plain loop, twice on the same inputs; returns the
    steps that read the map directly."""
    want = dec_cuda.group_starts_ref(jump50, tbl, n_groups)
    launches = dec_cuda.LAUNCHES["dec_chain"]
    for _ in range(2):
        got, misses = dec_cuda.group_starts(jump50, tbl, n_groups, with_misses=True)
        _equal(got, want)
    assert dec_cuda.LAUNCHES["dec_chain"] == launches + 2
    return misses


@pytest.mark.parametrize("case", ["18002-groups", "18002-groups-widths-by-table", "alternating-tables", "one-table",
                                  "malformed", "nbc-4096"])
def test_dec_chain_group_shapes(cuda, case):
    gen = torch.Generator(device=cuda).manual_seed(17)
    T = 6
    if case.startswith("18002-groups"):
        # The longest chain at the largest bucket (2^23 bits, a 900 KB block
        # at level 9): groups of steady width whatever the table, as in a
        # block of random bytes (200 bits, give or take 20), or of widths
        # that differ by table from 80 to 420 bits, as in text.
        B, nbc, G = 2, 1 << 23, 18_002
        if case == "18002-groups":
            jump50 = _jump_map(gen, B, T, nbc, 180, 221)
        else:
            lo = 80 + 60 * torch.arange(T, device=cuda)
            jump50 = _jump_map(gen, B, T, nbc, lo, lo + 41)
        tbl = torch.randint(0, T, (B, G), device=cuda, generator=gen, dtype=torch.int32)
        n_groups = torch.full((B,), G, dtype=torch.int32, device=cuda)
    elif case in ("alternating-tables", "one-table"):
        B, nbc, G = 4, 1 << 20, 3_000
        T = 2 if case == "alternating-tables" else 1
        jump50 = _jump_map(gen, B, T, nbc, 50, 50 * 17 + 1)
        tbl = (torch.arange(G, device=cuda) % T).to(torch.int32).repeat(B, 1)
        n_groups = torch.tensor([G, 0, 1, 2_999], dtype=torch.int32, device=cuda)
    elif case == "malformed":
        # Jumps backwards, of one bit, or of up to 100 bits a symbol: most
        # steps land outside their window (the chain stays short of the end).
        B, nbc, G = 3, 1 << 23, 2_000
        jump50 = _jump_map(gen, B, T, nbc, -200, 5_000)
        tbl = torch.randint(0, T, (B, G), device=cuda, generator=gen, dtype=torch.int32)
        n_groups = torch.tensor([G, G, 1], dtype=torch.int32, device=cuda)
    else:  # the smallest bucket: the chain reaches the end and stays there
        B, nbc, G = 3, 1 << 12, 200
        jump50 = _jump_map(gen, B, T, nbc, 50, 60)
        tbl = torch.randint(0, T, (B, G), device=cuda, generator=gen, dtype=torch.int32)
        n_groups = torch.tensor([G, 100, 0], dtype=torch.int32, device=cuda)
    misses = _chain_twice(jump50.contiguous(), tbl.contiguous(), n_groups)
    if case == "malformed":
        assert int(misses[0]) > G // 2


def test_decompress_device_on_card_matches_cpu(cuda):
    data = b"".join(_corpus(kind, 250_000, 21 + i).tobytes() for i, kind in enumerate(("text", "runs", "random")))
    for level in (1, 9):
        comp = stdlib_bz2.compress(data, level)
        for counts in (dec_cuda.LAUNCHES, mtf_dec_cuda.LAUNCHES):
            for name in counts:
                counts[name] = 0
        assert device_decode._decompress_device_inner(comp, True, cuda) == data  # no host fallback
        assert min(dec_cuda.LAUNCHES.values()) > 0 and mtf_dec_cuda.LAUNCHES["mtf_dec"] > 0
        assert dec_cuda.LAUNCHES["dec_chain"] == dec_cuda.LAUNCHES["dec_symbols"] == mtf_dec_cuda.LAUNCHES["mtf_dec"]
        assert device_decode._decompress_device_inner(comp, True, torch.device("cpu")) == data
        assert bz2tpu_torch.decompress_device(comp) == data
    bad = bytearray(stdlib_bz2.compress(data, 1))
    bad[len(bad) // 2] ^= 0x10
    with pytest.raises(ValueError):
        bz2tpu_torch.decompress_device(bytes(bad))


def _random_group_inputs(gen, B, T, U, G, n_bytes):
    """Arbitrary inputs of dec_symbols on the card: LUT lengths 0..22 (some
    beyond 20), bases that put some indices out of [0, 258), starts that
    reach past the stream's end."""
    dev = gen.device

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, device=dev, generator=gen, dtype=torch.int64).to(dtype)

    words = huffman_dec.window_words(ints(0, 256, (n_bytes,), torch.uint8))
    return (words, ints(0, 8 * n_bytes + 200, (B, G), torch.int64), ints(0, T, (B, G)),
            ints(0, 23, (U, 1 << 20), torch.int8), ints(0, U, (B, T)), ints(-300, 1 << 18, (B, T, 21)),
            ints(0, 258, (B, T, 258)))


@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 16), (3, 6, 7, 300, 5_000), (8, 6, 49, 18_002, 1 << 20)])
def test_dec_symbols_kernel_matches_plain(cuda, shape):
    B, T, U, G, n_bytes = shape
    gen = torch.Generator(device=cuda).manual_seed(31 + G)
    args = _random_group_inputs(gen, B, T, U, G, n_bytes)
    want = dec_cuda.decode_groups_ref(*args)
    launches = dec_cuda.LAUNCHES["dec_symbols"]
    for _ in range(2):
        got = dec_cuda.decode_groups(*args)
        _equal(got[0], want[0])
        _equal(got[1], want[1])
    assert dec_cuda.LAUNCHES["dec_symbols"] == launches + 2
    assert bool((want[0] == -2).any()) and bool((want[1] == 1).any())
    with pytest.raises(ValueError):
        dec_cuda.decode_groups(args[0], args[1].to(torch.int32), *args[2:])


@pytest.mark.parametrize("n_chunks", [1, 2, 57, 7_032])
def test_mtf_dec_kernel_matches_plain(cuda, n_chunks):
    gen = torch.Generator(device=cuda).manual_seed(41 + n_chunks)
    B = 3 if n_chunks < 1000 else 8
    js = torch.randint(0, 256, (B, 128 * n_chunks), device=cuda, generator=gen).to(torch.uint8)
    js[0, : 64 * n_chunks] = 255
    js[1, 100:] = 0  # padding: the identity
    js[2, ::3] = 0
    want = mtf_dec_cuda.chunk_perms_ref(js)
    launches = mtf_dec_cuda.LAUNCHES["mtf_dec"]
    for _ in range(2):
        got = mtf_dec_cuda.chunk_perms(js)
        _equal(got[0], want[0])
        _equal(got[1], want[1])
    assert mtf_dec_cuda.LAUNCHES["mtf_dec"] == launches + 2
    off = torch.zeros(128 * B + 16, dtype=torch.uint8, device=cuda)[1 : 1 + 128 * B].view(B, 128)
    with pytest.raises(ValueError):
        mtf_dec_cuda.chunk_perms(off)  # off 16-byte alignment


def test_dec_symbols_first_level_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(61)
    rng = np.random.default_rng(61)
    real = table_tensors([deep_lengths(rng, a, m) for a, m in ((21, 20), (258, 17), (40, 14))], 1, cuda)["lut"]
    rand = torch.randint(-128, 128, (5, 1 << 20), device=cuda, generator=gen).to(torch.int8)
    runs = torch.repeat_interleave(torch.randint(-3, 24, (4000,), device=cuda, generator=gen),
                                   torch.randint(1, 1200, (4000,), device=cuda, generator=gen))
    for lut in (real, rand, runs[: 2 << 20].to(torch.int8).view(2, -1), torch.cat([real, rand])):
        want = dec_cuda.first_level_tables_ref(lut)
        _equal(dec_cuda.first_level_tables(lut), want)
    assert bool((want == 0).any()) and bool((dec_cuda.first_level_tables_ref(real) != 0).any())
    with pytest.raises(ValueError):
        dec_cuda.first_level_tables(torch.zeros(2 << 20, dtype=torch.int8, device=cuda)[1:1 + (1 << 20)].view(1, -1))


@pytest.mark.parametrize("T", [1, 6])
@pytest.mark.parametrize("G", [1, 129, 4_999])
def test_dec_symbols_on_real_tables_with_long_codes(cuda, T, G):
    # Complete codes whose longest reach 14 to 20 bits, so windows in the
    # buckets they share with other lengths read the 1 MiB LUT row; a
    # stream of random bytes with runs of 0xff (the all-ones windows are
    # the long codes); each block's groups start at random bits, its last
    # group in the stream's last bytes, where the refills read past the
    # end; group counts that are not a multiple of the CTA tile.
    rng = np.random.default_rng(71 + 10 * T + G)
    B, n_bytes = 3, 40_000
    # Table 0 is the chain 1, 2, ..., max_len: its bucket of twelve ones
    # holds codes of 13 to max_len bits.
    chain = int(rng.integers(14, 21))
    tables = [deep_lengths(rng, chain + 1, chain)]
    tables += [deep_lengths(rng, int(rng.integers(21, 259)), int(rng.integers(14, 21))) for _ in range(T - 1)]
    t = table_tensors(tables, B, cuda)
    raw = rng.integers(0, 256, n_bytes).astype(np.uint8)
    for at in rng.integers(0, n_bytes - 64, 400):
        raw[at : at + int(rng.integers(2, 64))] = 0xFF
    words = huffman_dec.window_words(torch.from_numpy(raw).to(cuda))
    offs = np.sort(rng.integers(0, 8 * n_bytes - 40, (B, G)), axis=1)
    offs[:, -1] = 8 * n_bytes - np.arange(1, B + 1) * 9  # a few bits before the end
    offs = torch.from_numpy(offs).to(cuda)
    tbl = torch.from_numpy(rng.integers(0, T, (B, G)).astype(np.int32)).to(cuda)
    args = (words, offs, tbl, t["lut"], t["lut_idx"], t["base"], t["perm"])
    want = dec_cuda.decode_groups_ref(*args)
    launches = dec_cuda.LAUNCHES["dec_symbols"]
    got = dec_cuda.decode_groups(*args)
    _equal(got[0], want[0])
    _equal(got[1], want[1])
    assert dec_cuda.LAUNCHES["dec_symbols"] == launches + 1
    if G > 1_000:  # windows in marked buckets, and codes longer than the first level
        assert int(want[1].max()) > dec_cuda.FIRST_BITS
        first = dec_cuda.first_level_tables_ref(t["lut"])
        lens = want[1].view(B, G, 50).long()
        pos = offs[:, :, None] + lens.cumsum(2) - lens
        v = dec_cuda.window23(words, pos)
        rows = t["lut_idx"].long().gather(1, tbl.long())[:, :, None]
        assert bool((first.view(-1)[(rows << dec_cuda.FIRST_BITS) + (v >> (23 - dec_cuda.FIRST_BITS))] == 0).any())


def test_mtf_dec_trailing_zeros_at_every_offset_on_one_block(cuda):
    # One block of 7,032 chunks (the one-block batch of the 16 MB stream)
    # whose chunk c ends in zeros from offset c % 129: all-zero chunks,
    # chunks with no zero, and every offset between; then the same with
    # small indices, as real data has them, and rows of zeros.
    rng = np.random.default_rng(81)
    for hi in (256, 9):
        js = torch.from_numpy(trailing_zero_rows(rng, 7_032, hi)).to(cuda)
        want = mtf_dec_cuda.chunk_perms_ref(js)
        got = mtf_dec_cuda.chunk_perms(js)
        _equal(got[0], want[0])
        _equal(got[1], want[1])
    zeros = torch.zeros(3, 128 * 70, dtype=torch.uint8, device=cuda)
    q, emit = mtf_dec_cuda.chunk_perms(zeros)
    _equal(q, torch.arange(256, dtype=torch.uint8, device=cuda).expand(3, 70, 256))
    assert not bool(emit.any())


@pytest.mark.parametrize("corrupt", [False, True])
def test_decode_kernels_on_a_stream_match_plain(cuda, monkeypatch, corrupt):
    # D3 and D4 at the decode's own shapes: every call of a whole decode on
    # the card, held against the plain version on the same inputs. The
    # corrupt stream's last bit of block 0 (inside its EOB code) sends that
    # block's walk past its end.
    data = b"".join(_corpus(kind, 200_000, 51 + i).tobytes() for i, kind in enumerate(("text", "random", "runs")))
    comp = stdlib_bz2.compress(data, 1)
    if corrupt:
        parsed, _ = device_decode.parse_blocks(comp)
        pos = parsed[0]["end_bit"] - 1
        comp = bytearray(comp)
        comp[pos >> 3] ^= 0x80 >> (pos & 7)
        comp = bytes(comp)
    checked = {"dec_symbols": 0, "mtf_dec": 0}
    real_groups, real_perms = huffman_dec.decode_groups, mtf_dec.chunk_perms

    def groups(*args):
        got = real_groups(*args)
        want = dec_cuda.decode_groups_ref(*args)
        _equal(got[0], want[0])
        _equal(got[1], want[1])
        checked["dec_symbols"] += 1
        return got

    def perms(js):
        got = real_perms(js)
        want = mtf_dec_cuda.chunk_perms_ref(js)
        _equal(got[0], want[0])
        _equal(got[1], want[1])
        checked["mtf_dec"] += 1
        return got

    monkeypatch.setattr(huffman_dec, "decode_groups", groups)
    monkeypatch.setattr(mtf_dec, "chunk_perms", perms)
    out = device_decode._decompress_device_inner(comp, True, cuda)
    assert (out is None) if corrupt else (out == data)
    assert checked["dec_symbols"] > 0 and checked["mtf_dec"] > 0


def _rle1_pair(rows, n):
    """D7 and D5 on the card against the plain version on the CPU: the
    batch's bytes, each row's place and its CRC; two D7 launches and one
    D5 launch."""
    before = (rle1_dec_cuda.LAUNCHES["rle1_dec"], crc_cuda.LAUNCHES["crc_ranges"])
    flat, ends, crcs = rle1_dec.inverse_rle1_crc(rows, n)
    torch.cuda.synchronize()
    assert (rle1_dec_cuda.LAUNCHES["rle1_dec"], crc_cuda.LAUNCHES["crc_ranges"]) == (before[0] + 2, before[1] + 1)
    want_flat, want_ends, want_crcs = rle1_dec.inverse_rle1_crc(rows.cpu(), n.cpu())
    assert ends == want_ends
    _equal(flat.cpu(), want_flat)
    _equal(crcs.cpu(), want_crcs)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_rle1_dec_kernel_matches_plain(cuda, family):
    rows = FAMILIES[family]()
    _rle1_pair(*as_batch(rows, cuda))
    for row in rows:
        _rle1_pair(*as_batch([row], cuda))


@pytest.mark.parametrize("level", [1, 9])
def test_rle1_dec_kernel_on_the_rows_of_a_decode(cuda, level):
    seen = decode_rows(stdlib_stream(level), cuda)
    assert seen
    for rows, n in seen:
        _rle1_pair(rows, n)


def test_rle1_dec_kernel_off_16_byte_alignment_with_a_row_stride(cuda):
    rows, n = as_batch(FAMILIES["rle1_of_runs_and_text"]() + FAMILIES["unequal_rows"](), cuda)
    wide = torch.zeros(rows.shape[0], rows.shape[1] + 21, dtype=torch.uint8, device=cuda)
    wide[:, 5 : 5 + rows.shape[1]] = rows
    _rle1_pair(wide[:, 5 : 5 + rows.shape[1]], n)


def test_rle1_dec_kernel_at_the_main_path_shape_and_its_bound(cuda):
    # 8 rows of 900,000 bytes: text, then every fifth byte a count of 255,
    # which writes the bound, 8 x 46,620,000 bytes.
    _rle1_pair(*as_batch([text(900_000, 60 + r) for r in range(8)], cuda))
    rows, n = as_batch([b"qqqq\xff" * 180_000] * 8, cuda)
    flat, ends, crcs = rle1_dec.inverse_rle1_crc(rows, n)
    assert ends == [r * 46_620_000 for r in range(9)] == [r * rle1_dec.out_bound(1, 900_000) for r in range(9)]
    assert bool((flat == ord("q")).all())
    assert crcs.tolist() == [crc32(b"q" * 46_620_000)] * 8


def test_decompress_device_on_card_runs_the_inverse_rle1_there(cuda, monkeypatch):
    def host_rle1(*a):
        raise AssertionError("the decode on the card called the host's inverse RLE1")

    monkeypatch.setattr(device_decode.native, "inverse_rle1", host_rle1)
    one = b"".join(_corpus(kind, 300_000, 71 + i).tobytes() for i, kind in enumerate(("text", "runs", "random")))
    members = [stdlib_bz2.compress(text(60_000, 72 + m), 9) for m in range(5)]
    for stream, data in ((stdlib_bz2.compress(one, 1), one), (stdlib_bz2.compress(one, 9), one),
                         (b"".join(members), b"".join(map(stdlib_bz2.decompress, members)))):
        before = (profiling.counters(), dict(rle1_dec_cuda.LAUNCHES), dict(crc_cuda.LAUNCHES))
        assert device_decode._decompress_device_inner(stream, True, cuda) == data
        after = profiling.counters()
        n_batches = len(device_decode.batches(device_decode.parse_blocks(stream)[0]))
        headers = after["decode_headers"] - before[0]["decode_headers"]
        assert after["decode_rle1_device"] - before[0]["decode_rle1_device"] == headers > 0
        assert rle1_dec_cuda.LAUNCHES["rle1_dec"] - before[1]["rle1_dec"] == 2 * n_batches
        assert crc_cuda.LAUNCHES["crc_ranges"] - before[2]["crc_ranges"] == n_batches
    # A block CRC that does not match: the first member raises, a later one
    # goes to the host decoder.
    bad = bytearray(members[0])
    bad[11] ^= 0x01  # the block CRC of the member's block (bits 80-111)
    with pytest.raises(Bz2CrcError):
        device_decode._decompress_device_inner(bytes(bad), True, cuda)
    assert device_decode._decompress_device_inner(members[0] + bytes(bad), True, cuda) is None


def test_compress_device_intake_on_card_matches_cpu(cuda):
    data = b"".join(_corpus(kind, 150_000, 31 + i).tobytes() for i, kind in enumerate(("text", "runs", "random")))
    data = bytes(300_000) + data  # escalates the window first
    out = bz2tpu_torch.compress_device_intake(data, level=1, parallel=2)
    assert out == bz2tpu_torch.compress_device_intake(data, level=1, parallel=2, device="cpu")
    assert stdlib_bz2.decompress(out) == data


@pytest.mark.parametrize("n", [1, 4097, 3 * 4096 + 1, 1 << 23])
@pytest.mark.parametrize("b", [1, 16])
def test_crc_ranges_kernel_matches_plain(cuda, n, b):
    # Empty ranges, ranges that end at N, single bytes, overlapping and
    # unordered ranges; the 8 MiB chunk is the level-9 intake's.
    rng = np.random.default_rng(1200 + n + b)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    a, c = rng.integers(0, n + 1, b), rng.integers(0, n + 1, b)
    starts, ends = np.minimum(a, c), np.maximum(a, c)
    for i, (s, e) in enumerate([(0, n), (n, n), (n // 2, n // 2 + 1), (n - 1, n), (n // 3, n // 3)][:b]):
        starts[i], ends[i] = s, e
    chunk = torch.from_numpy(data).to(cuda)
    s_t, e_t = torch.from_numpy(starts.astype(np.int32)).to(cuda), torch.from_numpy(ends.astype(np.int32)).to(cuda)
    got = crc_cuda.crc_ranges(chunk, s_t, e_t)
    _equal(got, crc.crc32_ranges_ref(chunk, s_t, e_t))
    _equal(crc.crc32_ranges(chunk, s_t.long(), e_t.long()), got)
    if n < 1 << 20:
        assert got.tolist() == [crc32_serial(data[s:e]) for s, e in zip(starts, ends)]


def test_crc_ranges_kernel_off_16_byte_alignment_and_over_many_ctas(cuda):
    # A chunk that starts one byte past an aligned address (the scalar
    # path) and one of 32 MiB + 4 KiB (a tile more than a power of two, so
    # the look-back crosses many windows; the plain version then takes
    # 4,096 lanes).
    rng = np.random.default_rng(1300)
    base = torch.from_numpy(rng.integers(0, 256, (1 << 16) + 1, dtype=np.uint8)).to(cuda)
    for chunk in (base[1:], torch.from_numpy(rng.integers(0, 256, (1 << 25) + 4096, dtype=np.uint8)).to(cuda)):
        n = chunk.shape[0]
        pts = np.sort(rng.integers(0, n + 1, 16))
        s_t = torch.from_numpy(np.concatenate([pts[:8], [n, 0, pts[3]]])).to(cuda)
        e_t = torch.from_numpy(np.concatenate([pts[8:], [n, n, pts[3]]])).to(cuda)
        _equal(crc_cuda.crc_ranges(chunk, s_t, e_t), crc.crc32_ranges_ref(chunk, s_t, e_t))


def test_crc_ranges_kernel_endpoints_at_every_segment_offset_over_many_tiles(cuda):
    # 3 MiB + 5 bytes: not a multiple of 16, and 97 tiles, more than one
    # warp's look-back window of 32. Ranges start and end at every offset
    # 0-64 of the segment that ends the fifth tile (64 bytes a thread), so
    # every one crosses a tile boundary or ends on one; a start on every
    # offset of the last, short segment; the whole chunk; then 200 random
    # ranges, so that the endpoints outnumber a CTA's threads. The serial
    # CRC (the C core's) is the oracle: the plain version would take one
    # lane here.
    rng = np.random.default_rng(1310)
    n = 3 * (1 << 20) + 5
    data = rng.integers(0, 256, n, dtype=np.uint8)
    seg = 5 * crc_cuda.TILE_BYTES - 64
    offs = np.arange(65)
    tail = n - n % 64
    a, c = rng.integers(0, n + 1, 200), rng.integers(0, n + 1, 200)
    starts = np.concatenate([seg + offs, np.full(65, seg - 1000), tail + np.arange(n % 64 + 1), [0, 0],
                             np.minimum(a, c)])
    ends = np.concatenate([seg + offs + 1500, seg + offs, np.full(n % 64 + 1, n), [n, crc_cuda.TILE_BYTES],
                           np.maximum(a, c)])
    chunk = torch.from_numpy(data).to(cuda)
    for dtype in (torch.int32, torch.int64):
        s_t, e_t = torch.from_numpy(starts).to(cuda, dtype), torch.from_numpy(ends).to(cuda, dtype)
        assert crc_cuda.crc_ranges(chunk, s_t, e_t).tolist() == [crc32(data[s:e]) for s, e in zip(starts, ends)]


def test_crc_ranges_kernel_from_two_threads_on_one_stream(cuda):
    # Host threads call the kernel on the same stream, so they share its
    # workspace; which status array a call takes is counted on the card,
    # so every call of every thread stays exact. The interpreter switches
    # threads every microsecond here, so that calls interleave often.
    import sys
    import threading

    rng = np.random.default_rng(1320)
    n = (1 << 20) + 77
    data = rng.integers(0, 256, n, dtype=np.uint8)
    a, c = rng.integers(0, n + 1, 16), rng.integers(0, n + 1, 16)
    starts, ends = np.minimum(a, c), np.maximum(a, c)
    want = [crc32(data[s:e]) for s, e in zip(starts, ends)]
    chunk = torch.from_numpy(data).to(cuda)
    s_t, e_t = torch.from_numpy(starts).to(cuda), torch.from_numpy(ends).to(cuda)
    stream = torch.cuda.current_stream(cuda)
    got: dict[int, list] = {k: [] for k in range(4)}

    def calls(k: int) -> None:
        with torch.cuda.stream(stream):
            for _ in range(300):
                got[k].append(crc_cuda.crc_ranges(chunk, s_t, e_t))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=calls, args=(k,)) for k in got]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize(cuda)
    assert [len(v) for v in got.values()] == [300] * 4
    bad = sum(crcs.tolist() != want for v in got.values() for crcs in v)
    assert bad == 0, f"{bad} of 1200 calls disagree"


@pytest.mark.parametrize("kind", ["text", "runs", "random", "zeros", "empty"])
@pytest.mark.parametrize("level,max_blocks", [(1, 8), (9, 1), (9, 8)])
def test_block_cuts_kernel_matches_plain(cuda, kind, level, max_blocks):
    n = 0 if kind == "empty" else 3_000_000
    N = 1 << 22
    data = np.zeros(N, np.uint8)
    if kind not in ("zeros", "empty"):
        data[:n] = _corpus(kind, n, 1400)
    enc = rle1.rle1_encode(torch.from_numpy(data).to(cuda), n)
    args = (enc["piece_out_cum"], enc["piece_raw_cum"], enc["n_pieces"])
    cap = C.block_capacity(level)
    got = rle1_cuda.block_cuts(*args, cap=cap, max_blocks=max_blocks)
    want = rle1.block_cuts_ref(*args, cap=cap, max_blocks=max_blocks)
    for g, w in zip(got, want):
        _equal(g, w)
    # Exact-capacity cuts and overshoots on synthetic sums.
    poc = torch.full((1 << 10,), 2**31 - 1, dtype=torch.int32)
    poc[:400] = torch.arange(5, 2001, 5, dtype=torch.int32)
    for cap in (1, 5, 12, 100, 2000, 5000):
        for np_ in (0, 1, 400):
            sums = (poc.to(cuda), poc.to(cuda), torch.tensor(np_, dtype=torch.int32, device=cuda))
            for g, w in zip(rle1_cuda.block_cuts(*sums, cap=cap, max_blocks=8),
                            rle1.block_cuts_ref(*sums, cap=cap, max_blocks=8)):
                _equal(g, w)


def _sums(rng, n: int, kind: str, n_pieces: int) -> tuple[np.ndarray, np.ndarray]:
    """Sorted output and raw sums, INT32_MAX past n_pieces: RLE1's steps of
    1 to 5, steps above 5, duplicates, or steps of 1 with some duplicates
    and long jumps."""
    if kind == "rle1":
        steps = rng.integers(1, 6, n)
    elif kind == "wide":
        steps = rng.integers(6, 60, n)
    elif kind == "duplicates":
        steps = rng.integers(0, 2, n) * rng.integers(1, 6, n)
    else:
        steps = (rng.random(n) >= 0.2).astype(np.int64) + np.where(rng.random(n) < 0.05, rng.integers(6, 5001, n), 0)
    out, raw = np.cumsum(steps), np.cumsum(rng.integers(1, 256, n))
    out[n_pieces:] = raw[n_pieces:] = 2**31 - 1
    return out.astype(np.int32), raw.astype(np.int32)


@pytest.mark.parametrize("max_blocks", [1, 8, 40])
def test_block_cuts_kernel_on_sums_that_leave_their_windows(cuda, max_blocks):
    # Sums the contract admits but RLE1 never makes: a cut whose answer lies
    # outside the window its warp loaded searches the rest (the slow path,
    # counted); n_pieces 0, half and all of N; 40 cuts take two groups.
    rng = np.random.default_rng(1410 + max_blocks)
    n = 1 << 18
    slow = {}
    for kind in ("rle1", "wide", "duplicates", "jumps"):
        slow[kind] = 0
        for n_pieces in (0, n // 2, n):
            out, raw = _sums(rng, n, kind, n_pieces)
            sums = (torch.from_numpy(out).to(cuda), torch.from_numpy(raw).to(cuda),
                    torch.tensor(n_pieces, dtype=torch.int32, device=cuda))
            for cap in (1, 7, 1000, 50_000):
                got = rle1_cuda.block_cuts(*sums, cap=cap, max_blocks=max_blocks, with_slow=True)
                for g, w in zip(got, rle1.block_cuts_ref(*sums, cap=cap, max_blocks=max_blocks)):
                    _equal(g, w)
                slow[kind] += int(got[3])
    assert slow["rle1"] == 0, slow
    if max_blocks > 1:
        assert slow["jumps"] > 0, slow


def test_compress_device_intake_on_card_launches_d5_d6_once_per_window(cuda, monkeypatch):
    # Zeros widen the window twice (every chunk RLE1s into one under-full
    # block), then random bytes fill a batch and it drops back.
    rng = np.random.default_rng(1500)
    data = bytes(1_500_000) + rng.integers(0, 256, 700_000, dtype=np.uint8).tobytes()
    windows = []
    real = compressor.device_intake
    monkeypatch.setattr(compressor, "device_intake",
                        lambda chunk, length, **kw: windows.append(chunk.shape[0]) or real(chunk, length, **kw))
    crc_cuda.LAUNCHES["crc_ranges"] = rle1_cuda.LAUNCHES["block_cuts"] = 0
    out = bz2tpu_torch.compress_device_intake(data, level=1, parallel=2)
    assert crc_cuda.LAUNCHES["crc_ranges"] == rle1_cuda.LAUNCHES["block_cuts"] == len(windows)
    base = intake.chunk_capacity(1, 2)
    assert windows[:4] == [base, 2 * base, 4 * base, 8 * base], windows
    assert out == bz2tpu_torch.compress_device_intake(data, level=1, parallel=2, device="cpu")
    assert stdlib_bz2.decompress(out) == data


def test_compress_on_card_matches_cpu_and_counts_launches(cuda):
    data = b"".join(_corpus(kind, 120_000, 11 + i).tobytes() for i, kind in enumerate(("text", "runs", "random")))
    for counts in (bwt_cuda.LAUNCHES, mtf_cuda.LAUNCHES, huffman_cuda.LAUNCHES):
        for name in counts:
            counts[name] = 0
    out = bz2tpu_torch.compress(data, level=1)
    assert min(bwt_cuda.LAUNCHES.values()) > 0 and mtf_cuda.LAUNCHES["mtf_ranks"] > 0
    assert huffman_cuda.LAUNCHES["huffman_plan"] == 1  # one batch, one launch
    assert out == bz2tpu_torch.compress(data, level=1, device="cpu")
    assert stdlib_bz2.decompress(out) == data


def test_compress_level5_on_card_matches_cpu(cuda):
    # Just over one level-5 block after RLE1 (tests/test_torch_levels.py
    # holds the CPU path equal to bz2tpu at levels 2-8).
    from bz2tpu_torch.format.constants import block_capacity

    rng = np.random.default_rng(755)
    data = rng.integers(0, 32, block_capacity(5) - 30_000, dtype=np.uint8).tobytes()
    data += _corpus("text", 30_777, 756).tobytes()
    out = bz2tpu_torch.compress(data, level=5)
    assert out[:4] == b"BZh5"
    assert out == bz2tpu_torch.compress(data, level=5, device="cpu")
    assert stdlib_bz2.decompress(out) == data


def test_streams_and_files_on_card_match_compress(cuda, tmp_path):
    import io

    from bz2tpu_torch.runtime.stream import StreamCompressor, compress_file

    data = b"".join(_corpus(kind, 120_000, 41 + i).tobytes() for i, kind in enumerate(("text", "runs", "random")))
    want = bz2tpu_torch.compress(data, level=1, parallel=2)
    src = tmp_path / "in.dat"
    src.write_bytes(data)
    compress_file(str(src), str(tmp_path / "out.bz2"), level=1, parallel=2)
    assert (tmp_path / "out.bz2").read_bytes() == want
    # Checkpoint after each 50 kB write, drop at 200 kB, resume on the card.
    sink = io.BytesIO()
    sc = StreamCompressor(sink, level=1, parallel=2, chunk_blocks=1)
    for off in range(0, 200_000, 50_000):
        sc.write(data[off : off + 50_000])
        state = sc.checkpoint()
    resumed = io.BytesIO(sink.getvalue()[: StreamCompressor.state_sink_bytes(state)])
    resumed.seek(0, io.SEEK_END)
    sc2 = StreamCompressor(resumed, parallel=2, chunk_blocks=1, state=state)
    sc2.write(data[sc2.input_offset :])
    sc2.close()
    assert resumed.getvalue() == bz2tpu_torch.compress(data, level=1, device="cpu")
    with bz2tpu_torch.open(tmp_path / "f.bz2", "wb", level=1) as f:
        f.write(data)
    with bz2tpu_torch.open(tmp_path / "f.bz2", "rb") as f:
        assert f.read() == data


def test_pack_blocks_then_concat_equals_fused_pack_on_card(cuda):
    from bz2tpu_torch.ops import emit, pipeline

    corpus = make_mixed_corpus(8 * 900_000)
    blocks_t, ns, crcs = _batch_tensors(split_blocks(corpus, 9)[:8], cuda)
    last, orig_ptr = bwt_stage(blocks_t, ns)
    plan = pipeline.mtf_plan_stage(last, ns)
    width = int(plan["n_sym"].max())
    per = pipeline.emit_huff_pack_stage(plan, orig_ptr, crcs, width=width)
    fused, fused_total, fused_bits = pipeline.emit_huff_pack_concat_stage(plan, orig_ptr, crcs, width=width)
    cat, total = emit.concat_block_words(per["words"], per["total_bits"])
    _equal(per["total_bits"], fused_bits)
    assert int(total) == int(fused_total)
    _equal(cat, fused)


def test_encode_blocks_on_card_matches_cpu(cuda):
    # 16 rows of text, 64 to 2,047 bytes, and one padding row (ns = 1).
    from bz2tpu_torch.ops.pipeline import encode_blocks

    rng = np.random.default_rng(18)
    blocks = np.zeros((17, 2048), np.uint8)
    ns = np.ones(17, np.int32)
    for i in range(16):
        d = _corpus("text", int(rng.integers(64, 2048)), 100 + i)
        blocks[i, : d.size] = d
        ns[i] = d.size
    args = (torch.from_numpy(blocks), torch.from_numpy(ns), torch.from_numpy(rng.integers(0, 1 << 32, 17)))
    want = encode_blocks(*args)
    got = encode_blocks(*(a.to(cuda) for a in args))
    assert set(got) == set(want)
    for key in want:
        _equal(got[key].cpu(), want[key])


def test_per_block_path_on_card_matches_concat_at_level5(cuda, monkeypatch):
    # BZ2TPU_DEVICE_STITCH=0: each block back on its own and stitched on the
    # host, byte-identical to the batch concatenated on the card.
    from bz2tpu_torch.format.constants import block_capacity
    from bz2tpu_torch.runtime import compressor

    rng = np.random.default_rng(757)
    data = rng.integers(0, 32, 2 * block_capacity(5) - 70_000, dtype=np.uint8).tobytes()
    data += _corpus("text", 90_111, 758).tobytes()
    want = bz2tpu_torch.compress(data, level=5, parallel=2)
    monkeypatch.setattr(compressor, "_DEVICE_STITCH", False)
    rows = list(compressor._encode_batches(split_blocks(data, 5), 2, cuda))
    assert len(rows) == 3 and all(r["words"].size == (r["total_bits"] + 31) // 32 for r in rows)
    assert bz2tpu_torch.compress(data, level=5, parallel=2) == want
    assert stdlib_bz2.decompress(want) == data


def test_exported_artifact_with_kernels_spares_nvcc_in_a_fresh_process(cuda, tmp_path):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if not k.startswith("BZ2TPU_TORCH_")}
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    art = tmp_path / "artifact"

    def run(code: str, **extra) -> str:
        proc = subprocess.run([sys.executable, "-c", code], env={**env, **extra}, cwd=tmp_path,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    out = run(f"from bz2tpu_torch.utils.aot import export_artifact\n"
              f"print('N', export_artifact({str(art)!r}, levels=(1,), batch=2))",
              BZ2TPU_TORCH_CACHE_DIR=str(tmp_path / "export_cache"))
    assert "N 2" in out
    manifest = json.loads((art / "bz2tpu_torch_aot_manifest.json").read_text())
    assert manifest["kernels"]["file"].startswith("libbz2tpu_torch_") and manifest["kernels"]["cuda_runtime"]
    data = _corpus("text", 150_000, 759).tobytes()
    (tmp_path / "data.bin").write_bytes(data)
    out = run("import bz2, json\n"
              "import bz2tpu_torch\n"
              "from bz2tpu_torch import _build, native\n"
              "data = open('data.bin', 'rb').read()\n"
              "out = bz2tpu_torch.compress(data, level=1, parallel=2)\n"
              "assert bz2.decompress(out) == data\n"
              "assert out == bz2tpu_torch.compress(data, level=1, parallel=2, device='cpu')\n"
              "print('RUNS', json.dumps([_build.compiler_runs, native.compiler_runs]))",
              BZ2TPU_TORCH_CACHE_DIR=str(tmp_path / "fresh_cache"), BZ2TPU_TORCH_AOT_DIR=str(art))
    assert "RUNS [0, 0]" in out
