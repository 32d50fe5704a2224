"""The benchmark of bz2tpu_torch, one cell a process.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The cell
names a configuration (``portbench/configs/<name>.json``: level, batch,
the guarantees) and a traffic mix (``portbench/traffic/<name>.json``, made
by ``portbench/gen.py`` from the seed). Set-up builds or loads the port's
libraries from ``build/portbench/`` in the checkout, makes the objects
(for a decompress mix, stock streams by the standard library's bz2: one
an object, or one a member where the configuration states ``members``,
see ``split_members``) and warms up; the window then calls ``bz2tpu_torch.compress`` or
``decompress_device`` on one object after another, in the mix's order,
until ``--seconds`` have passed. With ``--trace 1`` the window's last
``PROFILED_S`` seconds (half of it where shorter) run under torch.profiler
and the rest is clocked (the port's stage laps), and the per-layer metrics (``portbench/metrics/<name>.py``)
are read from that record. Then every output is judged (see ``judge``),
and the last line of standard output is the result.

Importing this module starts nothing and imports neither torch nor the
port.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from portbench import gen
from portbench.reference import bzip2_ref

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
CACHE = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "bz2tpu")
# Compressed objects the reference decodes a run, drawn from the seed until
# their input reaches this many bytes (at least one object).
REFERENCE_BYTES = 24_000_000
# The profiled part of a traced window, at most: reading the profiler's
# events takes longer than the calls they record.
PROFILED_S = 10.0


def process_start() -> float:
    """perf_counter() at this process's start (its start time in /proc,
    against the clock's now), so that set-up counts the interpreter too."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = process_start()


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf_entry["file"]).read_text())
    if config["block_bytes"] != int(config["level"]) * 100_000:
        raise SystemExit(f"{conf_entry['file']}: block_bytes {config['block_bytes']} is not level x 100,000")
    if config["device"] != "cuda":
        raise SystemExit(f"{conf_entry['file']}: device {config['device']!r}; the port is measured on cuda")
    mix = gen.load_mix(cell["traffic"], root / "portbench" / "traffic")
    if "members" in config:
        if mix["op"] != "decompress":
            raise SystemExit(f"{conf_entry['file']}: members on a {mix['op']} mix; only a decode's input is "
                             "written by the benchmark")
        if not members_well_formed(config["members"]):
            raise SystemExit(f"{conf_entry['file']}: members {config['members']!r} is neither "
                             '{"records": K, "after": "<text>"} nor {"bytes": N}, K and N at least 1, text not empty')
    return cell, config, mix


def members_well_formed(members) -> bool:
    def count(v) -> bool:
        return isinstance(v, int) and not isinstance(v, bool) and v >= 1

    if not isinstance(members, dict):
        return False
    if set(members) == {"records", "after"}:
        return count(members["records"]) and isinstance(members["after"], str) and members["after"] != ""
    return set(members) == {"bytes"} and count(members["bytes"])


def split_members(data: bytes, members: dict | None) -> list[memoryview]:
    """The pieces of one object that are written as bzip2 streams of their
    own, in order. None: the object whole. ``{"records": K, "after": t}``:
    a cut after every K-th occurrence of t (counted without overlap), so
    that each piece but the last ends with t; what follows the last cut, if
    anything, is the last piece. ``{"bytes": N}``: a cut every N bytes."""
    view = memoryview(data)
    if members is None or not data:
        return [view]
    if "bytes" in members:
        n = members["bytes"]
        return [view[i : i + n] for i in range(0, len(data), n)]
    sep, k = members["after"].encode("utf-8"), members["records"]
    ends = [m.end() for m in re.finditer(re.escape(sep), data)][k - 1 :: k]
    starts = [0] + ends
    if ends and ends[-1] == len(data):
        starts.pop()
    return [view[a:b] for a, b in zip(starts, ends + [len(data)])]


def write_inputs(raw: list[bytes], level: int, members: dict | None, threads: int = 8) -> tuple[list[bytes], list[int]]:
    """A decode's inputs, as users read them: each object's pieces
    (``split_members``) compressed by the standard library's bz2 at
    ``level`` and concatenated in order, so one stream an object where
    ``members`` is None. Also the pieces an object. The pieces of all
    objects share the threads (bz2 releases the GIL)."""
    import bz2
    from concurrent.futures import ThreadPoolExecutor

    pieces = [split_members(d, members) for d in raw]
    flat = [p for ps in pieces for p in ps]
    with ThreadPoolExecutor(threads) as ex:
        # The largest first, so that no thread starts one last.
        order = sorted(range(len(flat)), key=lambda j: -len(flat[j]))
        written = dict(zip(order, ex.map(lambda j: bz2.compress(flat[j], level), order)))
    inputs, j = [], 0
    for ps in pieces:
        inputs.append(b"".join(written[j + i] for i in range(len(ps))))
        j += len(ps)
    return inputs, [len(ps) for ps in pieces]


def metric_module(name: str, directory: Path = BENCH_DIR / "metrics"):
    """The reader of per-layer metric ``name``, ``<directory>/<name>.py``:
    its ``read(record)`` gives the value or None, and a reader that no test
    table knows carries its own case, ``EXAMPLE = (record, value)``."""
    path = Path(directory) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return metric_module(name).read


def use_cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    os.environ["BZ2TPU_TORCH_CACHE_DIR"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ.pop("BZ2TPU_TORCH_AOT_DIR", None)


def host_sample() -> tuple[float, float, float]:
    """(this process's CPU seconds, seconds this thread waited to run,
    seconds the machine's CPUs were stolen by its host): read around the
    window's calls, to tell a call that ran slower from one that did not
    get a CPU."""
    wait = steal = 0.0
    try:
        with open("/proc/thread-self/schedstat") as f:
            wait = int(f.read().split()[1]) / 1e9
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return time.process_time(), wait, steal


# --------------------------------------------------------------------------
# the system under test


class Port:
    """The port's entry points and launch counters, as the window drives
    them."""

    def __init__(self, config: dict, device: str):
        import bz2tpu_torch
        from bz2tpu_torch.ops import bwt_cuda, dec_cuda

        self.mod = bz2tpu_torch
        self.level = int(config["level"])
        self.parallel = int(config["parallel"])
        self.device = device
        self.bwt_launches = bwt_cuda.LAUNCHES
        self.dec_launches = dec_cuda.LAUNCHES
        self.host_fallbacks = 0  # calls that reached the host decoder inside decompress_device

    def compress(self, data: bytes, timings: dict | None = None) -> bytes:
        return self.mod.compress(data, self.level, parallel=self.parallel, device=self.device, timings=timings)

    def decompress(self, stream: bytes, timings: dict | None = None) -> bytes:
        return self.mod.decompress_device(stream, device=self.device, timings=timings)

    def marks(self, op: str) -> tuple[int, int]:
        """K1 launches (compress) or D1 launches (decompress) so far, and
        the host decoder's calls from the device decode so far."""
        launches = self.bwt_launches["bwt_sort"] if op == "compress" else self.dec_launches["dec_chain"]
        return launches, self.host_fallbacks

    @staticmethod
    def on_card(before: tuple[int, int], after: tuple[int, int]) -> bool:
        """A call ran on the card if it launched K1 / D1 and handed nothing
        to the host decoder (decompress_device does so after D1 where a
        batch fails validation or the stream CRC does not check)."""
        return after[0] > before[0] and after[1] == before[1]

    @contextmanager
    def counting_fallbacks(self):
        """Count the calls that reach the host decoder from the device
        decode (runtime/device_decode's ``host_decompress``)."""
        from bz2tpu_torch.runtime import device_decode

        real = device_decode.host_decompress

        def counted(*a, **k):
            self.host_fallbacks += 1
            return real(*a, **k)

        device_decode.host_decompress = counted
        try:
            yield
        finally:
            device_decode.host_decompress = real


class Cell:
    """One cell's objects, set-up and window."""

    def __init__(self, config: dict, mix: dict, seed: int, port: Port, threads: int = 8):
        self.op = mix["op"]
        self.port = port
        made = gen.make_objects(mix, seed, threads=threads)
        self.names = [n for n, _ in made]
        self.raw = [d for _, d in made]
        if self.op == "decompress":
            self.inputs, self.members = write_inputs(self.raw, int(config["level"]), config.get("members"), threads)
        else:
            self.inputs, self.members = self.raw, []
        self.call_s: list[float] = []  # each window call's seconds, in order
        self.host: list[tuple[float, float, float]] = []  # host_sample() before the first call and after each

    def call(self, i: int, timings: dict | None = None) -> bytes:
        data = self.inputs[i]
        return self.port.compress(data, timings) if self.op == "compress" else self.port.decompress(data, timings)

    def warm_up(self) -> None:
        """One call on the shapes the window uses: a whole batch of full
        blocks (compress), or the first object's stream (decompress)."""
        if self.op == "compress":
            full = self.port.parallel * self.port.level * 100_000
            big = max(range(len(self.raw)), key=lambda i: len(self.raw[i]))
            self.port.compress(self.raw[big][:full])
        else:
            self.port.decompress(self.inputs[0])

    def window(self, seconds: float, record: list, timings: dict | None = None, start_at: int = 0,
               wrap=None) -> tuple[float, int]:
        """Calls until ``seconds`` have passed, from object ``start_at`` on in
        the mix's order; each call's (object, output or exception, whether
        it ran on the card) goes to ``record``. Returns the window's wall
        seconds, first call's start to last call's end, and the next
        object."""
        i = start_at
        t0 = t1 = time.perf_counter()
        self.host.append(host_sample())
        while True:
            k = i % len(self.inputs)
            before = self.port.marks(self.op)
            try:
                out = wrap(lambda: self.call(k, timings)) if wrap else self.call(k, timings)
            except Exception as e:  # a failed call is counted, and the run goes on
                out = e
            record.append((k, out, self.port.on_card(before, self.port.marks(self.op))))
            t2 = time.perf_counter()
            self.call_s.append(t2 - t1)
            self.host.append(host_sample())
            t1 = t2
            i += 1
            if t2 - t0 >= seconds:
                return t2 - t0, i

    def payload(self, k: int) -> int:
        """Bytes a call on object k counts: input for compress, output for
        decompress."""
        return len(self.raw[k])


# --------------------------------------------------------------------------
# judging


def judge(cell: Cell, record: list, seed: int, pool=None) -> tuple[dict, int]:
    """The numbers compared, each with its limit, and the failed calls.

    Compress: every call of one object returns the same bytes; every
    object's stream is read by the standard library's bz2 (libbz2, the
    bzip2 1.0.8 that the configuration names as its reader) and must give
    its input back; the objects drawn from the seed (REFERENCE_BYTES) are
    also decoded by the plain NumPy reference (portbench/reference), block
    CRCs and stream CRC included. Decompress: every output equals the
    bytes the benchmark made. Both: no call raises, and every call runs on
    the card: it launched K1 / D1 and handed nothing to the host decoder.
    """
    errors = sum(isinstance(out, Exception) for _, out, _ in record)
    off_card = sum(not on for _, out, on in record if not isinstance(out, Exception))
    failed = set()
    for j, (k, out, on) in enumerate(record):
        if isinstance(out, Exception) or not on:
            failed.add(j)
    checks = {}
    if cell.op == "compress":
        first: dict[int, bytes] = {}
        differing = 0
        for j, (k, out, _) in enumerate(record):
            if isinstance(out, Exception):
                continue
            if k not in first:
                first[k] = out
            elif out != first[k]:
                differing += 1
                failed.add(j)
        unreadable = [cell.names[k] for k, ok in zip(first, stdlib_reads(first, cell.raw)) if not ok]
        for k in first:
            if cell.names[k] in unreadable:
                failed.update(j for j, (kk, out, _) in enumerate(record) if kk == k)
        checks["bz2_bad_streams"] = {"value": len(unreadable), "limit": 0, "of": len(first)}
        if unreadable:
            checks["bz2_bad_streams"]["which"] = unreadable[:4]
        order = np.random.default_rng([seed & ((1 << 64) - 1), 1 << 20]).permutation(sorted(first)).tolist()
        sample, total = [], 0
        for k in order:
            if total >= REFERENCE_BYTES:
                break
            sample.append(k)
            total += len(cell.raw[k])
        bad = []
        for k in sample:
            why = bzip2_ref.check_stream(first[k], cell.raw[k], pool)
            if why is not None:
                bad.append(f"{cell.names[k]}: {why}")
                failed.update(j for j, (kk, out, _) in enumerate(record) if kk == k)
        checks["bad_streams"] = {"value": len(bad), "limit": 0, "of": len(sample)}
        if bad:
            checks["bad_streams"]["why"] = bad[:4]
        checks["differing_repeats"] = {"value": differing, "limit": 0}
    else:
        bad = 0
        for j, (k, out, _) in enumerate(record):
            if not isinstance(out, Exception) and out != cell.raw[k]:
                bad += 1
                failed.add(j)
        checks["bad_outputs"] = {"value": bad, "limit": 0, "of": len(record)}
    checks["off_card_calls"] = {"value": off_card, "limit": 0}
    checks["errors"] = {"value": errors, "limit": 0}
    if errors:
        checks["errors"]["first"] = next(repr(out)[:300] for _, out, _ in record if isinstance(out, Exception))
    return checks, len(failed)


def stdlib_reads(streams: dict[int, bytes], raw: list[bytes], threads: int = 8) -> list[bool]:
    """Whether bz2.decompress gives each object's input back, in the order
    of ``streams`` (object -> stream); on threads, as bz2 releases the GIL."""
    import bz2
    from concurrent.futures import ThreadPoolExecutor

    def reads(k: int) -> bool:
        try:
            return bz2.decompress(streams[k]) == raw[k]
        except (OSError, ValueError, EOFError):
            return False

    with ThreadPoolExecutor(threads) as ex:
        # The largest first, so that no thread starts one last.
        order = sorted(streams, key=lambda k: -len(raw[k]))
        got = dict(zip(order, ex.map(reads, order)))
    return [got[k] for k in streams]


def correct_of(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


# --------------------------------------------------------------------------
# the traced run


class Spans:
    """record_function spans around the port's layers, put in place for the
    profiled part of a traced run and taken out after it."""

    def __init__(self, op: str):
        import bz2tpu_torch.native as native
        from bz2tpu_torch.runtime import compressor, device_decode

        if op == "compress":
            self.targets = [(compressor, "split_blocks", "host: split"),
                            (compressor, "_batch_tensors", "host: batch to device"),
                            (compressor, "encode_batch", "encode batch"),
                            (compressor, "_finish", "host: stitch")]
        else:
            self.targets = [(device_decode, "parse_blocks", "host: parse"),
                            (device_decode, "stream_words", "stream to device"),
                            (device_decode, "batch_tensors", "host: tables"),
                            (device_decode, "decode_symbol_data", "huffman decode"),
                            (device_decode, "mtf_rle2_decode", "inverse mtf"),
                            (device_decode, "ibwt", "inverse bwt"),
                            (native, "inverse_rle1", "host: inverse rle1")]
        self.saved = []

    def __enter__(self):
        from torch.profiler import record_function

        for mod, name, label in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _label=label, **k):
                with record_function(_label):
                    return _fn(*a, **k)

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def device_record(prof, labels: set[str]) -> dict:
    """From a profiler run over calls spanned "call": the device's busy
    seconds (union of its intervals), its time by op name, the window
    (first call's start to last call's end), and the idle gaps inside it
    by the innermost span the host was in."""
    from torch.autograd import DeviceType

    dev, calls, spans = [], [], []
    ops: dict[str, float] = {}
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        # The spans show on the device's timeline too, as annotations.
        if e.device_type == DeviceType.CUDA and e.name != "call" and e.name not in labels:
            if t1 > t0:
                dev.append((t0, t1))
                ops[e.name] = ops.get(e.name, 0.0) + (t1 - t0) / 1e6
        elif e.name == "call":
            calls.append((t0, t1))
        elif e.name in labels:
            spans.append((t0, t1, e.name))
    if not dev or not calls:
        return {}
    w0, w1 = min(c[0] for c in calls), max(c[1] for c in calls)
    dev.sort()
    merged = []
    for a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    spans.sort()
    starts = np.array([s[0] for s in spans]) if spans else np.zeros(0)
    longest = max((s[1] - s[0] for s in spans), default=0.0)
    by_label: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = "host: outside the port's spans"
        # The innermost span around the gap's middle: the latest-starting one.
        for j in range(int(np.searchsorted(starts, mid, side="right")) - 1, -1, -1):
            if spans[j][1] >= mid:
                label = spans[j][2]
                break
            if mid - spans[j][0] > longest:  # no earlier span reaches the gap
                break
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e6
    return {"busy_s": busy, "window_s": (w1 - w0) / 1e6, "ops": ops, "gaps": by_label}


def traced(cell: Cell, seconds: float, record: list) -> dict:
    """The per-layer record: clocked calls for the window less its profiled
    part (the port's stage laps), then unclocked calls under torch.profiler
    for the profiled part, PROFILED_S or half the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    laps: dict[str, float] = {}
    n0 = len(record)
    profiled_s = min(seconds / 2, PROFILED_S)
    wall, nxt = cell.window(seconds - profiled_s, record, timings=laps)
    clocked = {"calls": len(record) - n0, "wall_s": wall, "laps": laps,
               "MB": sum(cell.payload(k) for k, _, _ in record[n0:]) / 1e6}

    def in_span(fn):
        with record_function("call"):
            return fn()

    spans = Spans(cell.op)
    n1 = len(record)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with spans, profile(activities=activities) as prof:
        wall2, _ = cell.window(profiled_s, record, start_at=nxt, wrap=in_span)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    dev = device_record(prof, {label for _, _, label in spans.targets})
    profiled = {"calls": len(record) - n1, "wall_s": wall2,
                "MB": sum(cell.payload(k) for k, _, _ in record[n1:]) / 1e6, **dev}
    return {"op": cell.op, "clocked": clocked, "profiled": profiled}


# --------------------------------------------------------------------------
# one run


def card() -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = smi.stdout.strip().split(",")[-1].strip() if smi.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unknown"
    return info


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device: str | None = None,
             threads: int = 8, root: Path = ROOT, pool=None, fault: str | None = None) -> dict:
    """One run of one cell; the result's line as a dict (its "checks" key
    last). The configuration names the device; ``device`` in its place is
    for the CPU tests, which drive the rest of a run; ``fault`` plants one
    of portbench/faults.py under the window's calls."""
    import contextlib

    import torch

    from portbench.faults import planted

    _, config, mix = cell_spec(bench, workload, root)
    if mix["op"] not in ("compress", "decompress"):
        raise ValueError(f"unknown op {mix['op']!r}")
    device = device or config["device"]
    marks = [("torch", time.perf_counter())]
    port = Port(config, device)
    marks.append(("port", time.perf_counter()))
    on_card = device == "cuda"
    if on_card:
        from bz2tpu_torch import _build

        _build.lib()
        marks.append(("kernels", time.perf_counter()))
    cell = Cell(config, mix, seed, port, threads)
    marks.append(("data", time.perf_counter()))
    cell.warm_up()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - T_START
    prev = T_START
    for name, t in marks:
        print(f"portbench: set-up {name} {t - prev:.3f} s", file=sys.stderr)
        prev = t
    if cell.members:
        print(f"portbench: set-up input {sum(cell.members)} members ({min(cell.members)}-{max(cell.members)} an "
              f"object of {len(cell.members)}), {sum(map(len, cell.inputs))} bytes", file=sys.stderr)
    info = card() if on_card else {"platform": device, "kind": device, "count": 1}
    with port.counting_fallbacks(), planted(fault, cell.op, port) if fault else contextlib.nullcontext():
        metrics, rec = measure(bench, workload, cell, seconds, trace, setup_s)
    if trace:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = rec["profiled"]
        if "busy_s" in prof:
            info["busy_s"], info["window_s"] = prof["busy_s"], prof["window_s"]
        breakdown = {
            "device_ops": sorted(([k[:120], v] for k, v in prof.get("ops", {}).items()), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in prof.get("gaps", {}).items()), key=lambda kv: -kv[1])[:10],
        }
    record = rec["record"]
    info["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    # The window's state goes before the reference runs.
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if pool is None and cell.op == "compress":
        with bzip2_ref.BlockPool() as own:
            checks, failed = judge(cell, record, seed, own)
    else:
        checks, failed = judge(cell, record, seed, pool)
    result = {"correct": correct_of(checks), "attempted": len(record), "failed": failed,
              "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(f"portbench: {len(record)} calls, reference {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return result


def measure(bench: dict, workload: str, cell: Cell, seconds: float, trace: bool, setup_s: float) -> tuple[dict, dict]:
    """The window: its end-to-end metrics (trace off), or the per-layer
    record (trace on); the calls are in the record's "record"."""
    record: list = []
    metrics: dict = {}
    if trace:
        rec = traced(cell, seconds, record)
        rec["record"] = record
        return metrics, rec
    wall, _ = cell.window(seconds, record)
    mb = sum(cell.payload(k) for k, _, _ in record) / 1e6
    n = len(cell.inputs)
    for j in range(0, len(record), n):
        # A pass of the mix: its rate, and its CPU, run-queue wait and steal
        # seconds over its wall seconds.
        wall_j = sum(cell.call_s[j : j + n])
        used = [b - a for a, b in zip(cell.host[j], cell.host[min(j + n, len(record))])]
        mbps = sum(cell.payload(k) for k, _, _ in record[j : j + n]) / 1e6 / wall_j
        print(f"portbench: pass {j // n} {mbps:.3f} MB/s, cpu {used[0] / wall_j:.3f}, "
              f"run-queue wait {used[1] / wall_j:.4f}, steal {used[2] / wall_j:.4f} of {wall_j:.3f} s",
              file=sys.stderr)
    if cell.op == "compress":
        metrics["compress_MBps"] = {"value": mb / wall, "unit": "MB/s"}
        # Each object once: every call of one object returns the same bytes
        # (the check holds them to it), so the ratio is the mix's.
        outs = {k: len(out) for k, out, _ in record if isinstance(out, bytes)}
        raw = sum(len(cell.raw[k]) for k in outs)
        metrics["ratio"] = {"value": sum(outs.values()) / raw if raw else 1.0, "unit": "out/in"}
    else:
        metrics["decompress_MBps"] = {"value": mb / wall, "unit": "MB/s"}
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    return metrics, {"record": record}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell_e, _, _ = cell_spec(bench, args.workload)
    use_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell_e["chips"]):
        print(f"portbench: needs {cell_e['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: {', '.join(loaded)} loaded in the measuring process", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
