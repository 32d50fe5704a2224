"""bz2tpu_torch.parallel on the CPU, held exact against bz2tpu.parallel on
JAX-CPU (the conftest's 8-device mesh): the per-block pipeline and its
packing, pad_batch, the collective stitch at S = 1 in this process and at
S = 2 and 4 in gloo process groups of worker processes
(tests/torch_parallel_worker.py, which import no JAX), and the
initialisation contract, each case in its own process.
"""

import bz2 as stdlib_bz2
import os
import socket
import subprocess
import sys
import textwrap
import time
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import bz2tpu_torch
from bz2tpu_torch.format import constants as C
from bz2tpu_torch.ops import emit, pipeline
from bz2tpu_torch.parallel import BlockMesh, block_mesh, encode_blocks_sharded, gather_blocks, pad_batch
from bz2tpu_torch.parallel.stitch import stitch_stream_shard, stitch_stream_sharded
from bz2tpu_torch.runtime.compressor import split_blocks

from conftest import make_corpus

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from bz2tpu.ops import emit as jax_emit  # noqa: E402
from bz2tpu.ops.pipeline import encode_blocks as jax_encode_blocks  # noqa: E402
from bz2tpu.ops.pipeline import encode_blocks_staged as jax_encode_staged  # noqa: E402
from bz2tpu.parallel import mesh as jax_mesh  # noqa: E402
from bz2tpu.parallel.stitch import stitch_stream_sharded as jax_stitch  # noqa: E402
from bz2tpu.runtime import compressor as jax_compressor  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
SCALARS = ("orig_ptr", "n_sym", "n_in_use", "n_groups", "n_selectors", "total_bits")
LEVEL = 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs in several
    worker processes, and torch's default of one thread a core in each
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text(seed: int, n: int) -> bytes:
    return make_corpus(np.random.default_rng(seed), "text", n)


@lru_cache(maxsize=None)
def _port_compress(data: bytes) -> bytes:
    return bz2tpu_torch.compress(data, level=LEVEL, device="cpu")


def _batch(data: bytes, level: int, n_rows: int):
    """(n_rows, cap) blocks, ns (padding rows 1), crcs and the live count."""
    blocks = split_blocks(data, level)
    assert len(blocks) <= n_rows
    batch = np.zeros((n_rows, C.block_capacity(level) + 4), np.uint8)
    ns = np.ones(n_rows, np.int32)
    crcs = np.zeros(n_rows, np.uint32)
    for i, blk in enumerate(blocks):
        batch[i, : blk.data.size] = blk.data
        ns[i] = blk.data.size
        crcs[i] = blk.crc
    return batch, ns, crcs, len(blocks)


def _assert_words_equal(port_words, port_bits, jax_words, jax_bits):
    """The first ceil(bits / 32) words of each row equal; past them, both
    are zero (the port's rows are narrower: Wb follows max(n_sym))."""
    port_words, jax_words = np.asarray(port_words), np.asarray(jax_words).astype(np.int64)
    np.testing.assert_array_equal(np.asarray(port_bits), np.asarray(jax_bits))
    for row, bits in enumerate(np.asarray(port_bits)):
        nw = (int(bits) + 31) // 32
        np.testing.assert_array_equal(port_words[row, :nw], jax_words[row, :nw], err_msg=f"row {row}")
        assert not port_words[row, nw:].any() and not jax_words[row, nw:].any(), f"row {row}"


def _assert_encode_equal(port: dict, want: dict) -> None:
    _assert_words_equal(port["words"], port["total_bits"], want["words"], want["total_bits"])
    for key in (*SCALARS, "used"):
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(want[key]), err_msg=key)


# -- (a) the per-block pipeline ---------------------------------------------


def _synthetic_rows():
    """16 rows of text, 64 to 2,047 bytes each (tests/test_parallel.py)."""
    rng = np.random.default_rng(18)
    cap, B = 2048, 16
    blocks = np.zeros((B, cap), np.uint8)
    ns = np.zeros(B, np.int32)
    for i in range(B):
        d = np.frombuffer(make_corpus(rng, "text", int(rng.integers(64, cap))), np.uint8)
        blocks[i, : d.size] = d
        ns[i] = d.size
    return blocks, ns, rng.integers(0, 1 << 32, B).astype(np.uint32)


def _level1_rows():
    """Two real level-1 blocks (one full, one short) and a padding row."""
    batch, ns, crcs, _ = _batch(_text(21, 130_000), LEVEL, 3)
    return batch, ns, crcs


@pytest.mark.parametrize("rows", [_synthetic_rows, _level1_rows], ids=["synthetic16", "level1_padded"])
def test_encode_blocks_matches_jax(rows):
    blocks, ns, crcs = rows()
    port = pipeline.encode_blocks(torch.from_numpy(blocks), torch.from_numpy(ns),
                                  torch.from_numpy(crcs.astype(np.int64)))
    args = (jnp.asarray(blocks), jnp.asarray(ns), jnp.asarray(crcs))
    _assert_encode_equal(port, jax_encode_blocks(*args, mtf_chunk=256))
    staged = jax_encode_staged(*args, mtf_chunk=256)
    np.testing.assert_array_equal(port["meta"].numpy(), np.asarray(staged["meta"]))
    assert port["meta"].dtype == torch.int32 and port["words"].dtype == torch.int64


def test_pack_blocks_then_concat_equals_pack_blocks_concat():
    blocks, ns, crcs = _synthetic_rows()
    blocks, ns, crcs = torch.from_numpy(blocks), torch.from_numpy(ns), torch.from_numpy(crcs.astype(np.int64))
    last, orig_ptr = pipeline.bwt_stage(blocks, ns)
    plan = pipeline.mtf_plan_stage(last, ns)
    width = int(plan["n_sym"].max())
    per = pipeline.emit_huff_pack_stage(plan, orig_ptr, crcs, width=width)
    fused, fused_total, fused_bits = pipeline.emit_huff_pack_concat_stage(plan, orig_ptr, crcs, width=width)
    cat, total = emit.concat_block_words(per["words"], per["total_bits"])
    assert torch.equal(per["total_bits"], fused_bits) and int(total) == int(fused_total)
    assert torch.equal(cat, fused)


# -- (b) concat_block_words, words_to_bytes -----------------------------------


@pytest.mark.parametrize("width", [1, 3, 9])
def test_concat_block_words_matches_jax(width):
    rng = np.random.default_rng(width)
    bits = np.array([0, 1, 31, 32, 33, 32 * width, 5, 32 * width, 64, 0], np.int32)
    bits = np.minimum(bits, 32 * width)
    words = rng.integers(0, 1 << 32, (bits.size, width), dtype=np.uint64).astype(np.uint32)
    for row, b in enumerate(bits):  # zero past each block's bits
        full, rem = divmod(int(b), 32)
        words[row, full + (rem > 0):] = 0
        if rem:
            words[row, full] &= np.uint32((0xFFFFFFFF << (32 - rem)) & 0xFFFFFFFF)
    got, got_total = emit.concat_block_words(torch.from_numpy(words.astype(np.int64)), torch.from_numpy(bits))
    want, want_total = jax_emit.concat_block_words(jnp.asarray(words), jnp.asarray(bits))
    assert int(got_total) == int(want_total) == int(bits.sum())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert emit.words_to_bytes(got, int(got_total)) == jax_emit.words_to_bytes(want, int(want_total))


# -- (c) pad_batch ----------------------------------------------------------


@pytest.mark.parametrize("args", [(1, 8), (8, 8), (9, 8), (3, 8, 2), (16, 1), (3, 4)])
def test_pad_batch_matches_jax(args):
    assert pad_batch(*args) == jax_mesh.pad_batch(*args)


# -- (d) the stitch: S = 1 in process, S = 2 and 4 in gloo groups ---------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(tmp_path: Path, size: int, *args: str, timeout: float = 180) -> list[tuple[int, str]]:
    """Start ``size`` workers on a fresh port; each one's exit code and
    stderr, once all have exited (a worker still running at ``timeout`` is
    killed, and the test fails)."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), port, str(size), str(r), str(tmp_path), *args],
                         env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(size)
    ]
    try:
        deadline = time.monotonic() + timeout
        errs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [(p.returncode, err.decode()) for p, err in zip(procs, errs)]


def _run_ranks(tmp_path: Path, size: int, *args: str, timeout: float = 180) -> None:
    """Start ``size`` workers on a fresh port; all must exit 0 in time."""
    for r, (rc, err) in enumerate(_start_ranks(tmp_path, size, *args, timeout=timeout)):
        assert rc == 0, f"rank {r} exited {rc}: {err[-3000:]}"


def _ranks_agree(tmp_path: Path, case, size: int) -> bytes:
    streams = [(tmp_path / f"stream_{case}.{r}").read_bytes() for r in range(size)]
    assert all(s == streams[0] for s in streams), "the ranks returned different streams"
    return streams[0]


def _jax_stream(words, bits, crcs, n_live, level, size) -> bytes:
    stream, _ = jax_stitch(jnp.asarray(np.asarray(words).astype(np.uint32)),
                           jnp.asarray(np.asarray(bits).astype(np.int32)),
                           jnp.asarray(np.asarray(crcs).astype(np.uint32)),
                           n_live, level, mesh=jax_mesh.block_mesh(size))
    return stream


# (S, bytes of text, seed): 310 kB is 4 level-1 blocks; 250 kB is 3, so at
# S = 4 the last rank holds only its padding row.
DATA_CASES = {"S2": (2, 310_000, 7), "S4": (4, 310_000, 7), "S4_last_shard_padding": (4, 250_000, 8)}


@pytest.mark.parametrize("case", list(DATA_CASES))
def test_multiprocess_stream_matches_jax_and_compress(tmp_path, case):
    size, n, seed = DATA_CASES[case]
    data = _text(seed, n)
    path = tmp_path / "input.bin"
    path.write_bytes(data)
    _run_ranks(tmp_path, size, "data", str(path), str(LEVEL))
    stream = _ranks_agree(tmp_path, "data", size)

    got = dict(np.load(tmp_path / "gathered.npz"))
    batch, ns, crcs, n_live = _batch(data, LEVEL, pad_batch(len(split_blocks(data, LEVEL)), size))
    assert got["words"].shape[0] == batch.shape[0]
    if case == "S4_last_shard_padding":
        assert (batch.shape[0], n_live) == (4, 3)
    bits = got["total_bits"].copy()
    bits[n_live:] = 0
    assert stream == _jax_stream(got["words"], bits, crcs, n_live, LEVEL, size)
    assert stream == _port_compress(data)
    assert stdlib_bz2.decompress(stream) == data
    if size == 2:  # the ordered gather against JAX's sharded encode, every row
        want = jax_mesh.encode_blocks_sharded(jnp.asarray(batch), jnp.asarray(ns), jnp.asarray(crcs),
                                              mesh=jax_mesh.block_mesh(2))
        _assert_encode_equal({k: torch.from_numpy(v) for k, v in got.items()}, want)


@pytest.mark.parametrize("kind", ["text", "runs", "random"])
def test_one_rank_stream_matches_jax_and_compress(kind):
    data = make_corpus(np.random.default_rng(30), kind, 120_000 if kind != "random" else 30_000)
    batch, ns, crcs, n_live = _batch(data, LEVEL, len(split_blocks(data, LEVEL)) + 1)  # + a padding row
    mesh = block_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, torch.device("cpu"))
    out = encode_blocks_sharded(batch, ns, crcs, mesh=mesh)
    assert gather_blocks(out, mesh) is out
    bits = out["total_bits"].clone()
    bits[n_live:] = 0
    steps = {}
    stream, total_bits = stitch_stream_shard(out["words"], bits, torch.from_numpy(crcs.astype(np.int64)),
                                             n_live, LEVEL, mesh=mesh, timings=steps)
    assert total_bits == 32 + int(bits.sum()) + 80
    assert list(steps) == ["concat", "exchange", "segments", "place", "bytes"]
    assert stream == _jax_stream(out["words"], bits, crcs, n_live, LEVEL, 1)
    assert stream == stitch_stream_sharded(out["words"], bits, crcs, n_live, LEVEL, mesh=mesh)[0]
    assert stream == bz2tpu_torch.compress(data, level=LEVEL, device="cpu")
    assert stdlib_bz2.decompress(stream) == data


def _stitch_cases():
    """Per-block words that are not bzip2 blocks, to reach the stitch's
    corners: segments whose bit counts are multiples of 32 (every offset
    then word-aligned), 0/1/31/33-bit blocks, shards of padding only, and
    one-rank streams whose trailer shares the last segment word."""
    rng = np.random.default_rng(44)
    cases = []
    for bits, live, level in (
        ([64, 96, 32, 128, 256, 32, 64, 32], 8, 9),
        ([1, 31, 33, 0, 7, 70, 0, 0], 5, 3),
        ([40, 0, 0, 0, 0, 0, 0, 0], 1, 1),
        ([0, 0, 0, 0, 0, 0, 0, 0], 0, 5),
        ([300, 17, 45, 1, 2, 3, 64, 0], 7, 2),
    ):
        bits = np.array(bits, np.int32)
        words = rng.integers(0, 1 << 32, (bits.size, 12), dtype=np.uint64).astype(np.int64)
        for row, b in enumerate(bits):
            full, rem = divmod(int(b), 32)
            words[row, full + (rem > 0):] = 0
            if rem:
                words[row, full] &= (0xFFFFFFFF << (32 - rem)) & 0xFFFFFFFF
        crcs = rng.integers(0, 1 << 32, bits.size).astype(np.int64)
        cases.append((words, bits, crcs, live, level))
    return cases


@pytest.mark.parametrize("size", [1, 2, 4])
def test_stitch_corner_cases_match_jax(tmp_path, size):
    cases = _stitch_cases()
    if size == 1:
        mesh = block_mesh(device="cpu")
        streams = [stitch_stream_sharded(*case, mesh=mesh)[0] for case in cases]
    else:
        np.savez(tmp_path / "cases.npz", **{
            f"{key}_{i}": np.asarray(v) for i, case in enumerate(cases)
            for key, v in zip(("words", "bits", "crcs", "live", "level"), case)
        })
        _run_ranks(tmp_path, size, "words", str(tmp_path / "cases.npz"))
        streams = [_ranks_agree(tmp_path, i, size) for i in range(len(cases))]
    for i, (stream, case) in enumerate(zip(streams, cases)):
        assert stream == _jax_stream(*case, size), f"case {i}"


def test_mesh_rows_and_one_rank_rules():
    with pytest.raises(ValueError, match="process group"):
        block_mesh(2, device="cpu")
    assert block_mesh(1, device="cpu").rows(3) == slice(0, 3)
    second = BlockMesh(None, 1, 2, torch.device("cpu"))
    assert second.rows(4) == slice(2, 4)
    with pytest.raises(ValueError, match="divisible"):
        second.rows(3)


# -- (e) the mesh inside compress: the public entry point, per-block path ----------


@lru_cache(maxsize=None)
def _mesh_data() -> bytes:
    """9 level-1 blocks of text: a batch of 8, then one block and padding."""
    data = _text(41, 850_000)
    assert len(split_blocks(data, LEVEL)) == 9
    return data


@lru_cache(maxsize=None)
def _jax_per_block_stream(data: bytes) -> bytes:
    """bz2tpu.compress with its _DEVICE_STITCH off at parallel=8: its batch
    of 8 divides the conftest's 8 CPU devices, so it takes its own mesh."""
    assert jax.device_count() == 8
    saved = jax_compressor._DEVICE_STITCH
    jax_compressor._DEVICE_STITCH = False
    try:
        return jax_compressor.compress(data, level=LEVEL, parallel=8)
    finally:
        jax_compressor._DEVICE_STITCH = saved


# case -> (ranks, parallel, API, whether the mesh runs). At parallel=8 the
# ranks divide the batch; at S = 4 and parallel=2 they do not, and the
# call takes the single-device path on every rank, as bz2tpu's does.
COMPRESS_CASES = {"S2": (2, 8, "compress", True), "S4": (4, 8, "compress", True),
                  "S2_stream": (2, 8, "stream", True), "S4_parallel2": (4, 2, "compress", False)}


@pytest.mark.parametrize("case", list(COMPRESS_CASES))
def test_compress_reaches_the_mesh_through_the_entry_point(tmp_path, case):
    size, parallel, api, meshed = COMPRESS_CASES[case]
    data = _mesh_data()
    path = tmp_path / "input.bin"
    path.write_bytes(data)
    _run_ranks(tmp_path, size, "compress", str(path), str(LEVEL), str(parallel), api)
    stream = _ranks_agree(tmp_path, "compress", size)
    calls = [int((tmp_path / f"mesh_calls.{r}").read_text()) for r in range(size)]
    # compress: one sharded encode a batch (8 blocks, then 1); the stream's
    # rounds hold back their last block: batches of 7, then 2.
    assert calls == [2] * size if meshed else calls == [0] * size
    assert stream == _port_compress(data)
    assert stream == _jax_per_block_stream(data)
    assert stdlib_bz2.decompress(stream) == data


def test_a_failing_rank_fails_the_others_instead_of_hanging(tmp_path):
    path = tmp_path / "input.bin"
    path.write_bytes(_text(7, 310_000))
    t0 = time.monotonic()
    (rc0, err0), (rc1, err1) = _start_ranks(tmp_path, 2, "compress", str(path), str(LEVEL), "2", "fail",
                                            timeout=150)
    assert rc1 == 1 and "rank 1 fails before compress" in err1, err1[-3000:]
    # Rank 0 raised out of its collective (a kill at the timeout is -9),
    # within the group's 60 s timeout and the processes' start.
    assert rc0 == 1, (rc0, err0[-3000:])
    assert time.monotonic() - t0 < 60 + 60
    assert not (tmp_path / "stream_compress.0").exists()


def test_a_group_of_one_takes_the_single_device_path(tmp_path):
    data = _text(7, 310_000)
    path, out = tmp_path / "input.bin", tmp_path / "out.bz2"
    path.write_bytes(data)
    _in_subprocess(f"""
        from pathlib import Path
        import torch.distributed as dist
        from bz2tpu_torch.parallel import mesh
        from bz2tpu_torch.parallel.distributed import initialize
        from bz2tpu_torch.runtime import compressor
        initialize(backend="gloo", timeout_s=30)
        assert dist.is_initialized() and dist.get_world_size() == 1
        calls = []
        real = mesh.encode_blocks_sharded
        mesh.encode_blocks_sharded = lambda *a, **k: calls.append(1) or real(*a, **k)
        compressor._DEVICE_STITCH = False
        stream = compressor.compress(Path({str(path)!r}).read_bytes(), level={LEVEL}, parallel=2, device="cpu")
        assert calls == [], calls
        Path({str(out)!r}).write_bytes(stream)
        dist.destroy_process_group()
        print("CASE-OK")
    """, {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "1", "RANK": "0"})
    assert out.read_bytes() == _port_compress(data)


# -- (f) initialize: each case in its own process ---------------------------------


def _in_subprocess(code: str, env_extra: dict | None = None, timeout: float = 120):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env, cwd=ROOT,
                       capture_output=True, timeout=timeout)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    assert b"CASE-OK" in r.stdout, r.stdout.decode()[-2000:]


def test_initialize_one_process_is_silent():
    _in_subprocess("""
        import sys, warnings
        import torch.distributed as dist
        from bz2tpu_torch.parallel.distributed import initialize
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            initialize(num_processes=1)
        assert not dist.is_initialized()
        assert "jax" not in sys.modules and "bz2tpu" not in sys.modules
        print("CASE-OK")
    """)


def test_initialize_without_environment_warns_single_process():
    _in_subprocess("""
        import warnings
        import torch.distributed as dist
        from bz2tpu_torch.parallel.distributed import initialize
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            initialize()
        hits = [x for x in w if x.category is RuntimeWarning and "SINGLE-PROCESS" in str(x.message)]
        assert hits, [str(x.message) for x in w]
        assert not dist.is_initialized()
        print("CASE-OK")
    """)


def test_initialize_unreachable_coordinator_raises_within_timeout():
    _in_subprocess(f"""
        import time
        from bz2tpu_torch.parallel.distributed import initialize
        t0 = time.monotonic()
        try:
            initialize(coordinator_address="127.0.0.1:{_free_port()}", num_processes=2, process_id=1,
                       backend="gloo", timeout_s=3)
        except RuntimeError as e:
            took = time.monotonic() - t0
            assert took < 3 + 10, took  # timeout_s, and room for a loaded machine
            print("CASE-OK", type(e).__name__, round(took, 1))
        else:
            raise AssertionError("initialize did not raise")
    """)


def test_initialize_from_environment():
    _in_subprocess("""
        import torch.distributed as dist
        from bz2tpu_torch.parallel import block_mesh
        from bz2tpu_torch.parallel.distributed import initialize, is_primary
        initialize(backend="gloo", timeout_s=30)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        mesh = block_mesh(device="cpu")
        assert (mesh.rank, mesh.size) == (0, 1) and mesh.group is not None and is_primary()
        dist.destroy_process_group()
        print("CASE-OK")
    """, {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "1", "RANK": "0"})


def test_is_primary_without_a_group():
    _in_subprocess("""
        import torch.distributed as dist
        from bz2tpu_torch.parallel.distributed import is_primary
        assert not dist.is_initialized() and is_primary()
        print("CASE-OK")
    """)


def test_block_mesh_default_device_raises_without_cuda():
    _in_subprocess("""
        import torch
        from bz2tpu_torch.parallel import block_mesh
        assert not torch.cuda.is_available()
        try:
            block_mesh()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e), e
            print("CASE-OK")
        else:
            raise AssertionError("block_mesh() did not raise without CUDA")
    """)
