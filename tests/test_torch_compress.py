"""bz2tpu_torch.compress end to end: byte-identical to bz2tpu.compress (JAX)
and to the NumPy oracle, decoded by stdlib bz2; the split of batch i + 1
on a worker thread while batch i encodes (its errors, counters and seam);
the import and device rules; the command line.
"""

import bz2 as stdlib_bz2
import dataclasses
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import bz2tpu_torch
from bz2tpu.oracle import compress as oracle_compress
from bz2tpu_torch.runtime import compressor
from bz2tpu_torch.utils import profiling

from conftest import CORPUS_KINDS, make_corpus

pytest.importorskip("jax")
from bz2tpu.runtime.compressor import compress as jax_compress  # noqa: E402


def _three_way(data: bytes, level: int, **kw) -> bytes:
    out = bz2tpu_torch.compress(data, level=level, device="cpu", **kw)
    assert out == jax_compress(data, level=level, **kw)
    assert out == oracle_compress(data, level=level)
    assert stdlib_bz2.decompress(out) == data
    return out


@pytest.mark.parametrize("kind", CORPUS_KINDS)
def test_matches_jax_and_oracle(rng, kind):
    _three_way(make_corpus(rng, kind, 5000), 1)


def test_multi_block_multi_batch(rng):
    # 350 kB of text at level 1 -> 4 blocks, 2 batches of 2.
    data = make_corpus(rng, "text", 350_000)
    out = bz2tpu_torch.compress(data, level=1, parallel=2, device="cpu")
    assert out == jax_compress(data, level=1, parallel=2)
    assert stdlib_bz2.decompress(out) == data
    assert bz2tpu_torch.decompress(out) == data


@pytest.mark.parametrize("data,level", [(b"", 9), (b"x", 1)], ids=["empty", "single-byte"])
def test_edge_inputs(data, level):
    _three_way(data, level)


def test_small_level9_block(rng):
    _three_way(make_corpus(rng, "runs", 20_000) + make_corpus(rng, "text", 20_000), 9)


def test_timings_cover_every_stage(rng):
    timings = {}
    data = make_corpus(rng, "text", 3000)
    out = bz2tpu_torch.compress(data, level=1, device="cpu", timings=timings)
    assert stdlib_bz2.decompress(out) == data
    assert set(timings) == {"bwt", "mtf", "rle2_out", "huffman", "pack"}


# The names the benchmark wraps or replaces in the compress driver: each
# must be called through the module, so a patch set there is reached.
SEAMS = ("split_blocks", "_batch_tensors", "encode_batch", "_finish")


@pytest.mark.parametrize("seam", SEAMS)
def test_compress_calls_its_seams_through_the_module(rng, seam, monkeypatch):
    data = make_corpus(rng, "text", 250_000)  # 3 level-1 blocks: batches of 2, then 1
    want = bz2tpu_torch.compress(data, level=1, parallel=2, device="cpu")
    calls = []
    real = getattr(compressor, seam)
    monkeypatch.setattr(compressor, seam, lambda *a, **k: calls.append(1) or real(*a, **k))
    assert bz2tpu_torch.compress(data, level=1, parallel=2, device="cpu") == want
    # A split a batch: the first on the calling thread, the second ahead.
    assert len(calls) == {"split_blocks": 2, "_batch_tensors": 2, "encode_batch": 2, "_finish": 1}[seam]


@pytest.mark.parametrize("parallel", [None, 1, 3, 8])
def test_mesh_batch_cuts_the_default_batches(parallel, monkeypatch):
    """compress cuts a stream of 0 to 17 blocks into bz2tpu's batches,
    those of _mesh_batch(n, parallel), and hands encode_parts that batch,
    which it knows from the first batch alone."""
    from bz2tpu_torch.oracle.encoder import Rle1Block

    seen = []
    monkeypatch.setattr(compressor, "encode_parts",
                        lambda batches, batch, dev, timings: seen.append((list(batches), batch)) or [])
    monkeypatch.setattr(compressor, "_finish", lambda parts, crcs: crcs)
    for n in range(18):
        # Block k is input byte k, its CRC k.
        blocks = [Rle1Block(np.zeros(1, np.uint8), 1, k) for k in range(n)]
        monkeypatch.setattr(compressor, "split_blocks",
                            lambda r, level: blocks[r.start : r.start + r.max_blocks])
        assert compressor.compress(np.zeros(n, np.uint8), 1, parallel=parallel, device="cpu") == list(range(n))
        batch = compressor._mesh_batch(n, parallel)
        got, got_batch = seen.pop()
        assert got == [blocks[b : b + batch] for b in range(0, n, batch)], n
        assert got_batch == batch, n


def _level1_batches(kind: str) -> bytes:
    """At level 1 and parallel=2, text of 4 batches, or runs whose every
    block holds many times its capacity of input (2 batches)."""
    rng = np.random.default_rng(2301)
    if kind == "text":
        return make_corpus(rng, "text", 760_000)  # 8 blocks
    return make_corpus(rng, "runs", 8_000_000)  # 3 blocks, about 3.4 MB of input a full one


@pytest.mark.parametrize("kind", ["text", "runs"])
def test_split_ahead_matches_jax_oracle_and_stdlib(kind):
    data = _level1_batches(kind)
    blocks = compressor.split_blocks(data, 1)
    assert len(blocks) == {"text": 8, "runs": 3}[kind]
    if kind == "runs":
        assert all(b.raw_length > 10 * 100_000 for b in blocks)
    before = profiling.counters()
    out = _three_way(data, 1, parallel=2)
    moved = {k: profiling.counters()[k] - before[k] for k in ("split_ahead", "split_waits", "batches")}
    assert moved["batches"] == math.ceil(len(blocks) / 2)
    assert moved["split_ahead"] + moved["split_waits"] == moved["batches"] - 1
    assert bz2tpu_torch.decompress(out) == data


def test_one_batch_starts_no_split_worker(monkeypatch):
    data = make_corpus(np.random.default_rng(2302), "text", 250_000)  # 3 blocks, one batch
    monkeypatch.setattr(compressor, "ThreadPoolExecutor", None)  # any worker would raise
    before = profiling.counters()
    out = bz2tpu_torch.compress(data, level=1, device="cpu")
    assert stdlib_bz2.decompress(out) == data
    after = profiling.counters()
    assert after["split_ahead"] == before["split_ahead"] and after["split_waits"] == before["split_waits"]
    assert after["batches"] == before["batches"] + 1


def test_split_error_surfaces_and_joins_the_worker(monkeypatch):
    data = make_corpus(np.random.default_rng(2303), "text", 250_000)  # 3 blocks: batches of 2, then 1
    real = compressor.split_blocks
    threads = []

    def fail_second(r, level):
        threads.append(threading.current_thread())
        if len(threads) == 2:
            raise RuntimeError("split failed")
        return real(r, level)

    monkeypatch.setattr(compressor, "split_blocks", fail_second)
    with pytest.raises(RuntimeError, match="split failed"):
        bz2tpu_torch.compress(data, level=1, parallel=2, device="cpu")
    first, worker = threads
    assert first is threading.current_thread() and worker is not first
    worker.join(timeout=10)
    assert not worker.is_alive()


def test_control_patch_reaches_every_block(monkeypatch):
    """The benchmark's control replaces split_blocks with a two-argument
    wrapper that zeroes each block's CRC: every block of the stream,
    the worker's included, then carries CRC 0."""
    from bz2tpu_torch import native

    data = make_corpus(np.random.default_rng(2304), "text", 560_000)  # 6 blocks, 3 batches
    split = compressor.split_blocks

    def no_crc(data, level):
        return [dataclasses.replace(blk, crc=0) for blk in split(data, level)]

    monkeypatch.setattr(compressor, "split_blocks", no_crc)
    out = bz2tpu_torch.compress(data, level=1, parallel=2, device="cpu")
    heads, _ = native.scan_blocks(out)
    assert len(heads) == 6
    assert [native.parse_block_header(out, h)[0] for h in heads] == [0] * 6


def test_concurrent_calls_under_fast_switching():
    """More compress calls at once than the process has cores, each
    splitting ahead on its own worker, thread switches every microsecond:
    every stream equals its serial one."""
    rng = np.random.default_rng(2305)
    inputs = [make_corpus(rng, "text", 100_200) for _ in range(2)]  # 2 blocks, 2 batches each
    serial = [bz2tpu_torch.compress(d, level=1, parallel=1, device="cpu") for d in inputs]
    n = len(os.sched_getaffinity(0)) + 1
    results: list = [None] * n
    torch_threads = torch.get_num_threads()
    switch = sys.getswitchinterval()

    def call(i):
        results[i] = bz2tpu_torch.compress(inputs[i % 2], level=1, parallel=1, device="cpu")

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    try:
        torch.set_num_threads(1)
        sys.setswitchinterval(1e-6)
        for t in threads:
            t.start()
        deadline = time.monotonic() + 300
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        sys.setswitchinterval(switch)
        torch.set_num_threads(torch_threads)
    assert not any(t.is_alive() for t in threads)
    assert results == [serial[i % 2] for i in range(n)]


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bz2tpu_torch.compress(b"abc")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bz2tpu_torch.compress(b"abc", device="cuda")


def test_import_and_help_load_no_jax():
    code = (
        "import sys, runpy\n"
        "import bz2tpu_torch\n"
        "bz2tpu_torch.decompress_device, bz2tpu_torch.compress_device_intake\n"
        "assert 'jax' not in sys.modules, 'import loaded jax'\n"
        "sys.argv = ['bz2tpu_torch', '--backend', 'device', '--help']\n"
        "try:\n"
        "    runpy.run_module('bz2tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert 'jax' not in sys.modules, '--help loaded jax'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage" in proc.stdout and "--backend" in proc.stdout


def test_cli_round_trip(rng, tmp_path):
    _cli_round_trip(rng, tmp_path, "gpu")


def test_cli_round_trip_device_backend(rng, tmp_path):
    _cli_round_trip(rng, tmp_path, "device")


def _cli_round_trip(rng, tmp_path, backend):
    from bz2tpu_torch.cli import main

    # The command line runs on the card by default; --device cpu takes the
    # plain torch path (the gpu backend's file compress is compress_file).
    cpu = ["--device", "cpu"]
    data = make_corpus(rng, "text", 4000)
    src = tmp_path / "in.txt"
    src.write_bytes(data)
    assert main([str(src), "--size", "1", "--backend", backend, *cpu]) == 0
    packed = (tmp_path / "in.txt.bz2").read_bytes()
    assert packed == oracle_compress(data, level=1)
    out = tmp_path / "back.txt"
    assert main([str(tmp_path / "in.txt.bz2"), "--dec", "-o", str(out), "--backend", backend, *cpu]) == 0
    assert out.read_bytes() == data
    assert main([str(tmp_path / "in.txt.bz2"), "--check", "--backend", backend, *cpu]) == 0
    assert main([str(tmp_path / "missing"), "--backend", backend, *cpu]) == 2
