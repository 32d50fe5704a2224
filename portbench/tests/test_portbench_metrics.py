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


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_reads_its_op_and_only_it(metric):
    read = run.metric_reader(metric)
    own, other = (COMPRESS, DECOMPRESS) if metric.endswith(".compress") else (DECOMPRESS, COMPRESS)
    assert read(json.loads(json.dumps(own))) == pytest.approx(WANT[metric])
    assert read(json.loads(json.dumps(other))) is None


def test_device_readers_stay_silent_without_a_trace():
    rec = json.loads(json.dumps(COMPRESS))
    rec["profiled"] = {"calls": 4, "wall_s": 2.0, "MB": 50.0}
    rec["peak_bytes"] = None
    for name in ("device_ms_per_MB.compress", "device_idle.compress", "device_peak_MiB.compress"):
        assert run.metric_reader(name)(rec) is None


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    files = {p.name[:-3] for p in (run.BENCH_DIR / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}
