"""Shippable builds and the prime pass (bz2tpu_torch/utils/aot.py,
utils/buildenv.py), the counterparts of tests/test_aot.py: an artifact
exported in one process, then a fresh process with an empty build cache
that installs it and runs no compiler; mismatched and unreadable artifacts
warn once and build from source; installing twice skips; and the command
line's --prime and --export-aot. On the CPU an artifact holds the host C
library only (the kernel library needs nvcc and a card:
tests/test_torch_cuda.py).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bz2tpu_torch import native
from bz2tpu_torch.cli import main
from bz2tpu_torch.utils import aot

from conftest import make_corpus

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = "bz2tpu_torch_aot_manifest.json"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs in several
    worker processes, and torch's default of one thread a core in each
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(args: list[str], cache: Path, aot_dir: Path | None = None, timeout: float = 300):
    """A fresh interpreter with the build cache at ``cache`` (and the
    artifact at ``aot_dir``), warnings always shown."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BZ2TPU_TORCH_")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               BZ2TPU_TORCH_CACHE_DIR=str(cache))
    if aot_dir is not None:
        env["BZ2TPU_TORCH_AOT_DIR"] = str(aot_dir)
    proc = subprocess.run([sys.executable, "-W", "always", *args], cwd=cache.parent, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def cpu_artifact(tmp_path_factory) -> Path:
    """An artifact exported by the command line in its own process, whose
    build cache starts empty."""
    base = tmp_path_factory.mktemp("export")
    art = base / "artifact"
    proc = _run(["-m", "bz2tpu_torch", "--export-aot", str(art), "--size", "1", "--parallel", "2",
                 "--device", "cpu"], base / "cache")
    assert f"exported 1 libraries to {art}" in proc.stderr
    assert "primed level 1 on cpu" in proc.stdout
    return art


_USE = """
import bz2, json, sys
import bz2tpu_torch
from bz2tpu_torch import _build, native
from bz2tpu_torch.utils import aot
data = open(sys.argv[1], "rb").read()
out = bz2tpu_torch.compress(data, level=1, parallel=2, device="cpu")
assert bz2.decompress(out) == data, "round trip failed"
aot.install(sys.argv[2], _build.BUILD_DIR)  # again: handled once a process
print("REPORT", json.dumps({"cc": native.compiler_runs, "nvcc": _build.compiler_runs,
                            "have_native": native.HAVE_NATIVE, "stats": aot.stats,
                            "cache": str(_build.BUILD_DIR)}))
"""


def _use(tmp_path: Path, art: Path) -> tuple[dict, str]:
    """A fresh process, an empty build cache, the artifact at ``art``:
    compress(device="cpu") round-trips through stdlib bz2. Its report and
    its stderr."""
    data = tmp_path / "data.bin"
    data.write_bytes(make_corpus(np.random.default_rng(70), "text", 150_000))
    cache = tmp_path / "fresh_cache"
    proc = _run(["-c", _USE, str(data), str(art)], cache, art)
    report = json.loads(proc.stdout.split("REPORT", 1)[1])
    assert report["cache"] == str(cache.resolve()) and report["have_native"]
    return report, proc.stderr


def test_cpu_artifact_fresh_process_runs_no_compiler(tmp_path, cpu_artifact):
    manifest = json.loads((cpu_artifact / MANIFEST).read_text())
    assert manifest["kernels"] is None and manifest["levels"] == [1]
    assert manifest["host"]["file"] == native.library_path().name
    assert sorted(p.name for p in cpu_artifact.iterdir()) == sorted([MANIFEST, manifest["host"]["file"]])
    report, err = _use(tmp_path, cpu_artifact)
    assert (report["cc"], report["nvcc"]) == (0, 0), err[-3000:]
    assert report["stats"] == {"installed_files": 1, "skipped_files": 0}
    assert "BZ2TPU_TORCH_AOT_DIR" not in err
    assert (tmp_path / "fresh_cache" / manifest["host"]["file"]).exists()


def _spoil(manifest: dict, how: str) -> dict:
    if how == "digest":  # as if the sources had been edited since the export
        manifest["host"]["digest"] = "0" * 16
    elif how == "version":
        manifest["version"] += 1
    elif how == "machine":
        manifest["machine"] = "not-" + manifest["machine"]
    return manifest


@pytest.mark.parametrize("how", ["digest", "version", "machine", "unreadable"])
def test_bad_artifact_warns_once_and_builds(tmp_path, cpu_artifact, how):
    art = tmp_path / "artifact"
    shutil.copytree(cpu_artifact, art)
    if how == "unreadable":
        (art / MANIFEST).write_text("{not json")
    else:
        (art / MANIFEST).write_text(json.dumps(_spoil(json.loads((art / MANIFEST).read_text()), how)))
    report, err = _use(tmp_path, art)
    words = "unreadable" if how == "unreadable" else "does not match this build"
    assert err.count(f"BZ2TPU_TORCH_AOT_DIR artifact at {art} {words}") == 1, err[-3000:]
    assert err.count("BZ2TPU_TORCH_AOT_DIR") == 1, err[-3000:]
    assert report["cc"] == 1  # built from source, into the empty cache
    assert report["stats"] == {"installed_files": 0, "skipped_files": 0}


def test_install_twice_skips(tmp_path, cpu_artifact, monkeypatch):
    monkeypatch.setattr(aot, "_installed", {})
    monkeypatch.setattr(aot, "stats", {"installed_files": 0, "skipped_files": 0})
    cache = tmp_path / "cache"
    assert aot.install(str(cpu_artifact), cache)
    assert aot.stats == {"installed_files": 1, "skipped_files": 0}
    assert aot.install(str(cpu_artifact), cache)  # handled in this process: nothing to do
    assert aot.stats == {"installed_files": 1, "skipped_files": 0}
    aot._installed.clear()  # as a second process would
    assert aot.install(str(cpu_artifact), cache)
    assert aot.stats == {"installed_files": 1, "skipped_files": 1}
    name = json.loads((cpu_artifact / MANIFEST).read_text())["host"]["file"]
    assert (cache / name).read_bytes() == (cpu_artifact / name).read_bytes()


def test_install_of_a_missing_artifact_warns(tmp_path, monkeypatch):
    monkeypatch.setattr(aot, "_installed", {})
    with pytest.warns(UserWarning, match="unreadable"):
        assert not aot.install(str(tmp_path / "missing"), tmp_path / "cache")
    assert not (tmp_path / "cache").exists()


def test_cli_prime_on_cpu(capsys):
    assert main(["-", "--prime", "--size", "1", "--parallel", "2", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "note: --prime builds and exits; listed files ignored" in err
    assert "kernel library not needed on the CPU" in out and "primed level 1 on cpu" in out


def test_cli_prime_and_export_are_exclusive(tmp_path, capsys):
    assert main(["--prime", "--export-aot", str(tmp_path / "art")]) == 2
    assert "exclusive" in capsys.readouterr().err
    assert not (tmp_path / "art").exists()


def test_cli_export_without_a_card_exits_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--export-aot", str(tmp_path / "art"), "--size", "1"]) == 1
    assert "error: CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "art").exists()  # nothing written, not even the directory


def test_setup_build_cache_path_repoints_the_cache(tmp_path, monkeypatch):
    from bz2tpu_torch import _build
    from bz2tpu_torch.utils import buildenv

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("BZ2TPU_TORCH_AOT_DIR", raising=False)
    assert buildenv.setup_build_cache(tmp_path / "c") == (tmp_path / "c").resolve() == _build.BUILD_DIR
    assert native.library_path().parent == (tmp_path / "c").resolve()
    assert buildenv.setup_build_cache() == _build.BUILD_DIR  # without a path: already set up
