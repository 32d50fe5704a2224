"""Timing + structured run metrics.

Parity: the reference has an (unused) Clock wall timer (reference
include/utilities.hpp:54-62) and a console device banner
(include/opencl.hpp:87-107); observability beyond that is absent. Here
every run can report structured metrics: throughput, ratio, blocks,
per-stage seconds — the SURVEY section 5 "metrics" subsystem. The port's
copy of bz2tpu/utils/metrics.py, verbatim.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


class Clock:
    """Wall-clock timer (reference utilities.hpp Clock analog)."""

    def __init__(self) -> None:
        self.start()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


@dataclass
class RunMetrics:
    """Per-run compression/decompression metrics."""

    op: str = "compress"
    input_bytes: int = 0
    output_bytes: int = 0
    blocks: int = 0
    batches: int = 0
    level: int = 0
    seconds: float = 0.0
    stage_seconds: dict = field(default_factory=dict)

    @property
    def ratio(self) -> float:
        return self.output_bytes / self.input_bytes if self.input_bytes else 0.0

    @property
    def mb_per_s(self) -> float:
        return self.input_bytes / self.seconds / 1e6 if self.seconds else 0.0

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] = (
                self.stage_seconds.get(name, 0.0) + time.perf_counter() - t0
            )

    def to_dict(self) -> dict:
        return {
            "op": self.op,
            "input_bytes": self.input_bytes,
            "output_bytes": self.output_bytes,
            "ratio": round(self.ratio, 4),
            "blocks": self.blocks,
            "batches": self.batches,
            "level": self.level,
            "seconds": round(self.seconds, 3),
            "mb_per_s": round(self.mb_per_s, 3),
            "stages": {k: round(v, 3) for k, v in self.stage_seconds.items()},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


def scaling_efficiency(throughputs: dict) -> dict:
    """Weak-scaling efficiency table: eff(n) = T_n / (n * T_1).

    `throughputs` maps device count -> aggregate throughput. This is the
    BASELINE scaling metric (>=80% on a real multi-host slice); bench.py
    emits it for the virtual CPU mesh as plumbing validation.
    """
    if 1 not in throughputs or not throughputs[1]:
        return {}
    base = throughputs[1]
    return {n: t / (n * base) for n, t in sorted(throughputs.items())}
