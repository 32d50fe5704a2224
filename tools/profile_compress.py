"""Where the card's time goes in one bz2tpu_torch.compress.

    python3 tools/profile_compress.py

Compresses 16 MB of the mixed corpus (bench.make_mixed_corpus) at level 9,
the cell chip_smoke.py times, on the CUDA card: once to warm up, twice
unprofiled (their walls), and once under torch.profiler recording device
activity only. It sums the device time of every kernel and copy the
profiler saw and prints one JSON object: the unprofiled and profiled
walls, the number of device events, the device busy time and its share of
the faster unprofiled wall, and the device time and launch count of the 25
costliest kernel names. The launch count of K1's `exclusive_scan` is the
number of radix-sort passes. Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
LEVEL = 9
CORPUS_BYTES = 16_000_000


def wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_compress: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import bench
    import bz2tpu_torch
    from bz2tpu_torch.utils.device import gpu_name_and_power_limit

    corpus = bench.make_mixed_corpus(CORPUS_BYTES)
    run = lambda: bz2tpu_torch.compress(corpus, level=LEVEL)  # noqa: E731
    run()  # warm-up: kernel build and lazy CUDA initialisation
    walls = [wall(run), wall(run)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = wall(run)

    per_name: dict[str, list] = {}
    for avg in prof.key_averages():
        if avg.device_type != DeviceType.CUDA:
            continue
        us = avg.self_device_time_total
        if us <= 0:
            continue
        entry = per_name.setdefault(avg.key, [0.0, 0])
        entry[0] += us / 1e6
        entry[1] += avg.count
    busy = sum(s for s, _ in per_name.values())
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:25]
    result = {
        "card": gpu_name_and_power_limit(),
        "bytes": len(corpus),
        "level": LEVEL,
        "unprofiled_walls_s": walls,
        "profiled_wall_s": profiled,
        "device_events": sum(c for _, c in per_name.values()),
        "device_busy_s": busy,
        "busy_share_of_min_unprofiled_wall": busy / min(walls),
        "top": [{"name": k[:100], "s": s, "launches": c} for k, (s, c) in top],
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
