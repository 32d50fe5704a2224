"""bz2tpu_torch's CUDA kernels on the card: each kernel against its plain
torch version (exact), the stages and the whole stream on the card against
the CPU path, for compress (levels 1 and 5), compress_device_intake,
decompress_device and the stream and file layer (compress_file, a
checkpoint resumed, BZ2File).

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
from bz2tpu_torch.ops import bwt, bwt_cuda, dec_cuda, huffman, huffman_cuda, mtf, mtf_cuda
from bz2tpu_torch.ops.bwt import bwt_stage
from bz2tpu_torch.runtime import device_decode
from bz2tpu_torch.runtime.compressor import _batch_tensors, split_blocks
from bz2tpu_torch.utils.corpus import make_mixed_corpus

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
