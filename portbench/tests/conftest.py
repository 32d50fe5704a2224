"""Shared set-up of the benchmark's CPU tests: a small copy of the
benchmark (the same cells, configurations and mixes, each object cut to a
small size) and the port's plain kernels counted as launches, so that the
harness's check that calls ran on the card can be driven on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("portbench_small")
    (root / "portbench" / "traffic").mkdir(parents=True)
    shutil.copytree(REPO / "portbench" / "configs", root / "portbench" / "configs")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (REPO / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["objects"] = mix["objects"][:3]
        for obj in mix["objects"]:
            obj["bytes"] = 120_000
        (root / "portbench" / "traffic" / path.name).write_text(json.dumps(mix))
    return root


@pytest.fixture
def counted_launches(monkeypatch):
    """The plain versions of K1 and D1 add to the launch counters, as the
    kernels do on the card."""
    from bz2tpu_torch.ops import bwt_cuda, dec_cuda

    for mod, ref, key in ((bwt_cuda, "sort_keys_ref", "bwt_sort"), (dec_cuda, "group_starts_ref", "dec_chain")):
        fn = getattr(mod, ref)

        def counting(*a, _fn=fn, _mod=mod, _key=key, **k):
            _mod.LAUNCHES[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, ref, counting)
