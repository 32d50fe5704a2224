"""The harness end to end on the CPU at a small size: the contract's
last line, and the control and every planted fault coming out as not
correct."""

import json
import subprocess
import sys

import pytest

from portbench import run
from portbench.faults import FAULTS

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = [w["name"] for w in run.load_bench()["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run(small_root, counted_launches, workload, trace):
    bench = run.load_bench(small_root)
    r = run.run_cell(bench, workload, 2**31 + 3, 0.5, trace, device="cpu", threads=2, root=small_root)
    want = KEYS[:5] + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == want
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    e2e = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    if trace:
        laps = {m["name"] for m in bench["per_layer"] if workload in m.get("workloads", [workload])
                and m["source"] == "program_span"}
        assert laps <= set(r["metrics"])  # device numbers need the card
    else:
        assert set(r["metrics"]) == e2e
        assert all(v["value"] > 0 for v in r["metrics"].values())
    json.dumps(r)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(small_root, counted_launches, workload, fault):
    bench = run.load_bench(small_root)
    r = run.run_cell(bench, workload, 2**31 + 4, 0.2, False, device="cpu", threads=2, root=small_root, fault=fault)
    assert r["correct"] is False, (fault, r["checks"])
    assert r["failed"] >= 1


def test_without_a_card_there_is_no_result(tmp_path):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1"], cwd=run.ROOT, capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "TMPDIR": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("bad", [0, 1, 2])
def test_every_object_is_read_back(monkeypatch, bad):
    """A stream broken the same way on every call of one object fails the
    run, whichever objects the NumPy reference's sample draws."""
    import bz2
    from types import SimpleNamespace

    monkeypatch.setattr(run, "REFERENCE_BYTES", 1)
    raw = [bytes(range(256)) * (40 + 7 * k) for k in range(3)]
    streams = [bz2.compress(r, 9) for r in raw]
    b = bytearray(streams[bad])
    b[len(b) // 2] ^= 0x21
    streams[bad] = bytes(b)
    cell = SimpleNamespace(op="compress", names=["a", "b", "c"], raw=raw)
    record = [(k, streams[k], True) for k in (0, 1, 2, 0, 1, 2)]
    checks, failed = run.judge(cell, record, 2**31 + 5)
    assert checks["bz2_bad_streams"]["value"] == 1 and checks["bz2_bad_streams"]["which"] == [cell.names[bad]]
    assert checks["differing_repeats"]["value"] == 0 and checks["bad_streams"]["of"] == 1
    assert not run.correct_of(checks) and failed == 2


@pytest.mark.parametrize("key,value", [("block_bytes", 800_000), ("device", "cpu")])
def test_a_configuration_is_held_to_what_it_states(small_root, tmp_path, key, value):
    import shutil

    root = tmp_path / "root"
    shutil.copytree(small_root, root)
    path = root / "portbench" / "configs" / "bzip2-l9.json"
    config = json.loads(path.read_text())
    config[key] = value
    path.write_text(json.dumps(config))
    with pytest.raises(SystemExit, match=key):
        run.cell_spec(run.load_bench(root), "l9-silesia-compress", root)
