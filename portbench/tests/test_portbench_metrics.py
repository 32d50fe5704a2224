"""Every per-layer metric reader on a canned traced record."""

import json

import pytest

from portbench import run

BENCH = run.load_bench()

COMPRESS = {"op": "compress", "peak_bytes": 3 * 2**30,
            "clocked": {"calls": 4, "wall_s": 2.0, "MB": 100.0,
                        "laps": {"bwt": 0.5, "mtf": 0.1, "rle2_out": 0.1, "huffman": 0.1, "pack": 0.2}},
            "profiled": {"calls": 4, "wall_s": 2.0, "MB": 50.0, "busy_s": 0.5, "window_s": 2.0}}
DECOMPRESS = {"op": "decompress", "peak_bytes": 2**30,
              "clocked": {"calls": 4, "wall_s": 2.0, "MB": 50.0,
                          "laps": {"parse": 0.6, "tables": 0.1, "huffman": 0.2, "mtf": 0.2, "ibwt": 0.1,
                                   "rle1_crc": 0.3}},
              "profiled": {"calls": 4, "wall_s": 1.0, "MB": 25.0, "busy_s": 0.2, "window_s": 1.0}}
WANT = {
    "driver_ms_per_MB.compress": 10.0, "bwt_ms_per_MB.compress": 5.0, "entropy_ms_per_MB.compress": 5.0,
    "device_ms_per_MB.compress": 10.0, "device_idle.compress": 75.0, "device_peak_MiB.compress": 3072.0,
    "decode_host_ms_per_MB.decompress": 20.0, "huffman_dec_ms_per_MB.decompress": 4.0,
    "mtf_ibwt_ms_per_MB.decompress": 6.0, "device_ms_per_MB.decompress": 8.0,
    "device_idle.decompress": 80.0, "device_peak_MiB.decompress": 1024.0,
}


def reader_case(metric: str, directory=run.BENCH_DIR / "metrics"):
    """(reader, its op's record, the value it reads there, the other ops'
    records): from WANT and the canned records above, or, for a reader
    that WANT does not know, from its own ``EXAMPLE = (record, value)``."""
    mod = run.metric_module(metric, directory)
    if metric in WANT:
        own, other = (COMPRESS, DECOMPRESS) if metric.endswith(".compress") else (DECOMPRESS, COMPRESS)
        return mod.read, own, WANT[metric], [other]
    if not hasattr(mod, "EXAMPLE"):
        raise LookupError(f"{metric}: no entry in WANT and no EXAMPLE = (record, value) in its reader")
    record, value = mod.EXAMPLE
    assert isinstance(value, (int, float)), f"{metric}: EXAMPLE's value {value!r} is not a number"
    return mod.read, record, value, [r for r in (COMPRESS, DECOMPRESS) if r["op"] != record["op"]]


def check_reader(metric: str, directory=run.BENCH_DIR / "metrics") -> None:
    read, own, want, others = reader_case(metric, directory)
    assert read(json.loads(json.dumps(own))) == pytest.approx(want)
    for other in others:
        assert read(json.loads(json.dumps(other))) is None


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_reads_its_op_and_only_it(metric):
    check_reader(metric)


def test_device_readers_stay_silent_without_a_trace():
    rec = json.loads(json.dumps(COMPRESS))
    rec["profiled"] = {"calls": 4, "wall_s": 2.0, "MB": 50.0}
    rec["peak_bytes"] = None
    for name in ("device_ms_per_MB.compress", "device_idle.compress", "device_peak_MiB.compress"):
        assert run.metric_reader(name)(rec) is None


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    files = {p.name[:-3] for p in (run.BENCH_DIR / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


PARSE = """
EXAMPLE = ({"op": "decompress", "clocked": {"calls": 4, "wall_s": 2.0, "MB": 50.0, "laps": {"parse": 0.5}}},
           %s)


def read(rec):
    c = rec["clocked"]
    if %s:
        return None
    return 1e3 * c["laps"].get("parse", 0.0) / c["MB"]
"""
OWN_OP = 'rec["op"] != "decompress" or "parse" not in c["laps"]'
NEW_READERS = {
    "its_own_case": (PARSE % ("10.0", OWN_OP), None),
    "a_wrong_value": (PARSE % ("12.0", OWN_OP), AssertionError),
    "reads_the_other_op": (PARSE % ("10.0", "not c['laps']"), AssertionError),
    "no_case_at_all": ("def read(rec):\n    return None\n", LookupError),
}


@pytest.mark.parametrize("kind", NEW_READERS)
def test_a_new_metric_is_one_new_file(tmp_path, kind):
    """A per-layer metric added as its reader's file and its entry in
    BENCHMARK.json, no other file edited, is checked on its own case; one
    with neither a WANT entry nor an EXAMPLE fails."""
    import shutil

    source, fails = NEW_READERS[kind]
    metrics = tmp_path / "metrics"
    shutil.copytree(run.BENCH_DIR / "metrics", metrics)
    (metrics / "parse_ms_per_MB.decompress.py").write_text(source)
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "parse_ms_per_MB.decompress", "unit": "ms/MB", "better": "lower",
                               "source": "program_span", "layer": "decode driver: runtime/device_decode.py",
                               "moves": "decompress_MBps", "workloads": ["l9-enwik-decompress"]})
    assert {p.name[:-3] for p in metrics.glob("*.py")} == {m["name"] for m in bench["per_layer"]}
    for m in bench["per_layer"][:-1]:
        check_reader(m["name"], metrics)
    if fails is None:
        check_reader("parse_ms_per_MB.decompress", metrics)
    else:
        with pytest.raises(fails):
            check_reader("parse_ms_per_MB.decompress", metrics)
