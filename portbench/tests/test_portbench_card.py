"""The harness on the card at a small size: a sound run is correct, the
control and each fault are not. Marked ``cuda``; each test skips itself
where there is no card."""

import pytest

from portbench import run
from portbench.faults import FAULTS

CELLS = [w["name"] for w in run.load_bench()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.use_cache_dirs()


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, *FAULTS])
@pytest.mark.parametrize("workload", CELLS)
def test_on_the_card(card, small_root, workload, fault):
    bench = run.load_bench(small_root)
    r = run.run_cell(bench, workload, 2**31 + 21, 0.5, False, root=small_root, fault=fault)
    assert r["device"]["platform"] == "gpu"
    assert r["correct"] is (fault is None), (fault, r["checks"])
