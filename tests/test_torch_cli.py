"""The port's command line (python -m bz2tpu_torch) against bz2tpu's, run
in subprocesses with ``--device cpu``: outputs byte-identical to bz2tpu's
functions on the same inputs (compress_file on JAX-CPU for the default
backend, the NumPy oracle for the others, recover), the same exit codes
as bz2tpu's command line, stdin/stdout, several files a call, --rm,
--recover, --metrics, --banner, --trace, --version, and no fallback to
the CPU where the card is missing.

Each test draws its data from its own seeded generator.
"""

import bz2 as stdlib_bz2
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bz2tpu.oracle import compress as oracle_compress
from bz2tpu.runtime import decompressor as jax_decompressor

from conftest import make_corpus

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs in several
    worker processes, and torch's default of one thread a core in each
    oversubscribes the machine and slows every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cli(args, input_bytes=None, module="bz2tpu_torch"):
    # One intra-op thread in the child too (see _one_torch_thread).
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        input=input_bytes, capture_output=True, cwd=ROOT, env=env, timeout=300,
    )


def _metrics(stderr: bytes) -> dict:
    lines = [ln for ln in stderr.decode().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, stderr
    return json.loads(lines[0])


@pytest.mark.parametrize("backend", ["gpu", "oracle", "device"])
def test_compress_decompress_check(tmp_path, backend, capsys):
    rng = np.random.default_rng(700)
    data = make_corpus(rng, "text", 60_000)
    src = tmp_path / "input.dat"
    src.write_bytes(data)
    r = run_cli([str(src), "--backend", backend, "--size", "1", "-v", "--metrics", *CPU])
    assert r.returncode == 0, r.stderr
    assert src.exists()  # kept by default
    packed = (tmp_path / "input.dat.bz2").read_bytes()
    assert packed == oracle_compress(data, level=1)
    m = _metrics(r.stderr)
    assert (m["op"], m["input_bytes"], m["output_bytes"], m["level"]) == ("compress", len(data), len(packed), 1)
    if backend == "gpu":  # compress_file: StreamCompressor's stages and counts
        assert set(m["stages"]) == {"rle1_split", "device_encode", "stitch"}
        assert (m["blocks"], m["batches"]) == (1, 1)
    assert b"MB/s" in r.stderr

    # The decode side in-process (a subprocess pays torch's import again).
    from bz2tpu_torch.cli import main

    assert main([str(src) + ".bz2", "--check", "--backend", backend, *CPU]) == 0
    assert "Integrity check passed!" in capsys.readouterr().out
    assert main([str(src) + ".bz2", "--dec", "--backend", backend, "-o", str(tmp_path / "out.dat"), *CPU]) == 0
    assert (tmp_path / "out.dat").read_bytes() == data


def test_default_backend_matches_jax_compress_file(tmp_path):
    # Three level-1 blocks in batches of two through compress_file.
    from bz2tpu.runtime.stream import compress_file as jax_compress_file

    rng = np.random.default_rng(701)
    data = make_corpus(rng, "text", 250_000)
    src = tmp_path / "in.dat"
    src.write_bytes(data)
    r = run_cli([str(src), "--size", "1", "--parallel", "2", "-o", str(tmp_path / "port.bz2"), *CPU])
    assert r.returncode == 0, r.stderr
    jax_compress_file(str(src), str(tmp_path / "jax.bz2"), level=1, parallel=2)
    assert (tmp_path / "port.bz2").read_bytes() == (tmp_path / "jax.bz2").read_bytes()


@pytest.mark.parametrize("backend", ["gpu", "oracle", "device"])
def test_stdio(backend):
    rng = np.random.default_rng(702)
    data = make_corpus(rng, "runs", 10_000)
    r = run_cli(["-", "--backend", backend, "--size", "1", *CPU], input_bytes=data)
    assert r.returncode == 0, r.stderr
    assert r.stdout == oracle_compress(data, level=1)
    r2 = run_cli(["-", "--dec", "--backend", backend, *CPU], input_bytes=r.stdout)
    assert r2.returncode == 0 and r2.stdout == data


def test_multi_file_worst_status(tmp_path):
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(f"hello world {i} ".encode() * 200)
        paths.append(p)
    args = [str(paths[0]), str(tmp_path / "missing"), str(paths[1]), str(paths[2]), "--size", "1"]
    r = run_cli(args + CPU)
    assert r.returncode == 2, r.stderr  # the missing file's status, the others done
    for p in paths:
        assert (p.parent / (p.name + ".bz2")).read_bytes() == oracle_compress(p.read_bytes(), level=1)
    assert run_cli(args + ["--backend", "oracle"], module="bz2tpu.cli").returncode == 2


def test_rm_flag(tmp_path):
    rng = np.random.default_rng(703)
    data = make_corpus(rng, "text", 5_000)
    src = tmp_path / "input.dat"
    src.write_bytes(data)
    r = run_cli([str(src), "--size", "1", "--rm", *CPU])
    assert r.returncode == 0, r.stderr
    assert not src.exists()
    from bz2tpu_torch.cli import main

    assert main([str(src) + ".bz2", "--dec", "--rm", *CPU]) == 0
    assert src.read_bytes() == data and not (tmp_path / "input.dat.bz2").exists()


def test_recover(tmp_path):
    rng = np.random.default_rng(704)
    data = make_corpus(rng, "text", 350_000)
    comp = bytearray(stdlib_bz2.compress(data, 1))
    comp[len(comp) // 3] ^= 0xFF  # inside the second of four blocks
    src = tmp_path / "damaged.bz2"
    src.write_bytes(bytes(comp))
    r = run_cli([str(src), "--recover", "--metrics"])
    assert r.returncode == 0, r.stderr
    want, ok, total = jax_decompressor.recover(bytes(comp))
    assert ok == total - 1
    assert f"recovered {ok}/{total} blocks".encode() in r.stderr
    assert (tmp_path / "damaged").read_bytes() == want
    assert _metrics(r.stderr)["op"] == "recover"
    r = run_cli(["-", "--recover"], input_bytes=b"BZh1 nothing to salvage")
    assert r.returncode == 1 and b"recovered 0/0 blocks" in r.stderr and r.stdout == b""


_ERRORS = {
    "missing-file": ["missing.file"],
    "size-0": ["{x}", "--size", "0"],
    "bad-check": ["{bad}", "--check"],
    "bad-dec": ["{bad}", "--dec", "-o", "{out}"],
    "multi-with-output": ["{x}", "{x}", "-o", "{out}"],
    "stdio-mixed": ["{x}", "-"],
    "no-files": [],
}


@pytest.mark.parametrize("case", list(_ERRORS))
@pytest.mark.parametrize("backend", ["gpu", "oracle"])
def test_error_exits_match_bz2tpu(tmp_path, case, backend, capsys):
    # In-process: argument and input errors stop before any encode.
    from bz2tpu.cli import main as jax_main
    from bz2tpu_torch.cli import main

    (tmp_path / "x").write_bytes(b"abc")
    (tmp_path / "bad.bz2").write_bytes(b"BZh1garbagegarbage")
    args = [a.format(x=tmp_path / "x", bad=tmp_path / "bad.bz2", out=tmp_path / "o") for a in _ERRORS[case]]
    got = main([*args, "--backend", backend, *CPU])
    want = jax_main([*args, "--backend", "tpu" if backend == "gpu" else backend])
    assert got == want != 0, capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_cuda_without_card_exits_1(tmp_path, monkeypatch, capsys):
    from bz2tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.dat"
    src.write_bytes(b"no card here " * 100)
    packed = tmp_path / "in.dat.bz2"
    packed.write_bytes(stdlib_bz2.compress(src.read_bytes(), 1))
    for args in ([str(src)], [str(src), "--device", "cuda"], [str(src), "--backend", "device"],
                 [str(packed), "--dec", "--backend", "device", "-o", str(tmp_path / "out")]):
        assert main(args) == 1
        assert "CUDA is not available" in capsys.readouterr().err
    assert packed.read_bytes() == stdlib_bz2.compress(src.read_bytes(), 1)  # not overwritten
    assert not (tmp_path / "out").exists()
    # The host decode takes no device.
    assert main([str(packed), "--dec", "-o", str(tmp_path / "out")]) == 0
    assert (tmp_path / "out").read_bytes() == src.read_bytes()


def test_version_and_help(capsys):
    from bz2tpu_torch import __version__
    from bz2tpu_torch.cli import main

    for flag in ("--version", "--help"):
        with pytest.raises(SystemExit) as e:
            main([flag])
        assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith(f"bz2tpu_torch {__version__}\n")
    assert "nvcc" in out and "--prime" in out and "--device" in out


def test_banner_and_trace(tmp_path):
    src = tmp_path / "in.dat"
    src.write_bytes(b"traced " * 500)
    trace = tmp_path / "trace"
    r = run_cli([str(src), "--size", "1", "--banner", "--trace", str(trace), *CPU])
    assert r.returncode == 0, r.stderr
    assert b"bz2tpu_torch: 0 device(s)" in r.stderr  # no card on a CPU run
    [written] = trace.iterdir()
    assert written.suffix == ".json" and "traceEvents" in json.loads(written.read_text())
    # The port's spans are in it: a batch's encode, its stages and copies.
    names = {e.get("name") for e in json.loads(written.read_text())["traceEvents"]}
    assert {"bz2.upload", "bz2.encode", "bz2.bwt", "bz2.pack", "bz2.fetch"} <= names
    assert stdlib_bz2.decompress((tmp_path / "in.dat.bz2").read_bytes()) == src.read_bytes()


# --- the utils the command line uses, as tests/test_utils.py ------------


def test_run_metrics_json():
    import time

    from bz2tpu_torch.utils.metrics import Clock, RunMetrics

    m = RunMetrics(op="compress", level=9)
    m.input_bytes, m.output_bytes = 1000, 100
    c = Clock()
    with m.stage("bwt"):
        time.sleep(0.01)
    assert c.elapsed() >= 0.01
    m.seconds = 0.5
    d = json.loads(m.to_json())
    assert (d["ratio"], d["mb_per_s"]) == (0.1, 0.002)
    assert d["stages"]["bwt"] >= 0.01


def test_device_info_and_banner(monkeypatch):
    import io

    from bz2tpu_torch.utils import device

    infos = device.device_info()
    assert len(infos) == (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    assert all(i["platform"] == "gpu" for i in infos)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card {i}")
    monkeypatch.setattr(device, "gpu_name_and_power_limit", lambda: "card 0, 700.00 W")
    assert device.device_info() == [{"id": i, "platform": "gpu", "kind": f"card {i}", "process": 0} for i in (0, 1)]
    buf = io.StringIO()
    device.print_device_banner(file=buf)
    assert buf.getvalue().splitlines() == [
        "bz2tpu_torch: 2 device(s)", "  [0] card 0 (gpu, process 0)", "  [1] card 1 (gpu, process 0)",
        "  nvidia-smi: card 0, 700.00 W"]


def test_device_trace_noop_and_fence(tmp_path):
    from bz2tpu_torch.utils.profiling import device_trace

    with device_trace(None):
        torch.ones(8) * 2
    assert list(tmp_path.iterdir()) == []
