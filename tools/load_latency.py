"""The latency of one dependent load from the card's memory, measured by a
pointer chase.

    python3 tools/load_latency.py

One thread follows a random cycle of int32 indices, each load's address
the value the one before returned, so the time per hop is one load's
latency. The loads are cached in L2 only (".cg"), not in L1. A 1 MiB
buffer read whole before the chase ("warm") gives L2's latency; a 256
MiB buffer evicted from L2 first ("cold") gives device memory's. Timed
with CUDA events at two hop counts, the difference over the extra hops,
so the launch drops out; the median of five pairs. chip_smoke.py
multiplies the warm latency by the block cuts' least count of dependent
loads for D6's latency bound. Prints one JSON object with the card's
name and power limit. Needs a CUDA card and triton.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import triton
import triton.language as tl

HOPS = (1024, 9216)
WARM_BYTES, COLD_BYTES = 1 << 20, 256 << 20
FLUSH_BYTES = 128 << 20  # written before a cold chase: more than L2 holds


@triton.jit(do_not_specialize=["first", "hops"])
def _chase(nxt_ptr, out_ptr, first, hops):
    p = tl.load(nxt_ptr + first)
    for _ in range(hops):
        p = tl.load(nxt_ptr + p, cache_modifier=".cg")
    tl.store(out_ptr, p)


def dependent_load_ns(nbytes: int, warm: bool) -> float:
    """Nanoseconds a hop of a chase over a random cycle of nbytes // 4
    int32 entries: read whole before each chase where ``warm``, else
    evicted from L2 by a larger write. Each chase starts at its own random
    entry, so a cold one seldom meets a line an earlier one brought in."""
    n = nbytes // 4
    gen = torch.Generator().manual_seed(0)
    order = torch.randperm(n, generator=gen)
    nxt = torch.empty(n, dtype=torch.int32)
    nxt[order] = order.roll(-1).to(torch.int32)
    nxt = nxt.to("cuda")
    firsts = torch.randint(0, n, (10,), generator=gen).tolist()
    flush = None if warm else torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _chase[(1,)](nxt, out, 0, 1, num_warps=1)  # the build

    def ms(first: int, hops: int) -> float:
        if warm:
            nxt.sum()
        else:
            flush.fill_(1)
        torch.cuda.synchronize()
        start.record()
        _chase[(1,)](nxt, out, first, hops, num_warps=1)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    runs = [(ms(firsts[2 * r + 1], HOPS[1]) - ms(firsts[2 * r], HOPS[0])) * 1e6 / (HOPS[1] - HOPS[0])
            for r in range(5)]
    return sorted(runs)[len(runs) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("load_latency: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bz2tpu_torch.utils.device import gpu_name_and_power_limit

    print(json.dumps({
        "card": gpu_name_and_power_limit(),
        f"warm_{WARM_BYTES >> 20}MiB_ns": dependent_load_ns(WARM_BYTES, warm=True),
        f"cold_{COLD_BYTES >> 20}MiB_ns": dependent_load_ns(COLD_BYTES, warm=False),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
