"""bz2tpu_torch.compress end to end: byte-identical to bz2tpu.compress (JAX)
and to the NumPy oracle, decoded by stdlib bz2; the import and device
rules; the command line.
"""

import bz2 as stdlib_bz2
import subprocess
import sys

import numpy as np
import pytest
import torch

import bz2tpu_torch
from bz2tpu.oracle import compress as oracle_compress
from bz2tpu_torch.runtime import compressor

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
    assert len(calls) == {"split_blocks": 1, "_batch_tensors": 2, "encode_batch": 2, "_finish": 1}[seam]


@pytest.mark.parametrize("parallel", [None, 1, 3, 8])
def test_mesh_batch_cuts_the_default_batches(parallel, monkeypatch):
    """encode_parts at compress's batch, _mesh_batch(n, parallel), yields
    the same batches as at parallel or DEFAULT_BATCH, for 0 to 17 blocks."""
    monkeypatch.setattr(compressor, "_batch_tensors", lambda chunk, device, n_rows=None: (list(chunk),))
    monkeypatch.setattr(compressor, "_encode", lambda chunk, timings=None: (chunk, len(chunk)))
    for n in range(18):
        blocks = list(range(n))
        got = list(compressor.encode_parts(blocks, compressor._mesh_batch(n, parallel), "cpu"))
        want = list(compressor.encode_parts(blocks, parallel or compressor.DEFAULT_BATCH, "cpu"))
        assert got == want, n
        assert [b for chunk, _ in got for b in chunk] == blocks, n


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
