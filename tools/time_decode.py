"""The device decode (decompress_device) of the port's 16 MB stream, timed
on the card for one checkout of bz2tpu_torch.

    python3 tools/time_decode.py [--root DIR] [--reps N]

Imports bz2tpu_torch from --root (default: this checkout), so the same
script times another checkout's decode on the same stream: run it on two
checkouts in turns in one call (A, B, B, A) to compare them within the
noise of one card. It builds the 16 MB mixed corpus at level 9
(bz2tpu_torch.utils.corpus) and the port's stream of it, then decodes the
stream on the card: one warm-up, N unclocked runs (each must give the
corpus back with no host fallback), one clocked run (the per-stage seconds,
and the steps inside "huffman" and "mtf" where the checkout splits them),
and one run under torch.profiler with device activity only (device events,
kernels among them, busy seconds, the costliest ops; chip_smoke.py's
device_profile of this checkout), with the device seconds and launches of
each decode kernel by name. The host C decoder
and stdlib bz2 decode the same stream in the same run. It prints one JSON
object: the card's name and power limit, the root, the stream's CRC-32,
the walls, MB/s, the split, the trace and each decode kernel's launches
per decode where the checkout counts them. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bz2 as stdlib_bz2
import inspect
import json
import sys
import time
import zlib
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
LEVEL = 9
# The decode's kernels as the trace names them (dec_symbols' first pass is
# lut_first_level since its redesign).
DECODE_KERNEL_NAMES = ("dec_chain", "dec_symbols", "lut_first_level", "mtf_dec")
CORPUS_BYTES = 16_000_000


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose bz2tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_decode: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_profile  # this checkout's, whatever --root says

    sys.path.insert(0, str(Path(args.root).resolve()))
    import bz2tpu_torch
    from bz2tpu_torch.ops import dec_cuda
    from bz2tpu_torch.runtime import device_decode
    from bz2tpu_torch.utils.corpus import make_mixed_corpus
    from bz2tpu_torch.utils.device import gpu_name_and_power_limit

    counts = [dec_cuda.LAUNCHES]
    try:
        from bz2tpu_torch.ops import mtf_dec_cuda
        counts.append(mtf_dec_cuda.LAUNCHES)
    except ImportError:  # a checkout without the mtf_dec kernel
        pass
    dev = torch.device("cuda")
    corpus = make_mixed_corpus(CORPUS_BYTES)
    stream = bz2tpu_torch.compress(corpus, level=LEVEL)
    mb = len(corpus) / 1e6
    decode = lambda *extra: device_decode._decompress_device_inner(stream, True, dev, *extra)  # noqa: E731
    if decode() != corpus:  # warm-up
        raise AssertionError("the device decode does not give the corpus back")
    for c in counts:
        for name in c:
            c[name] = 0
    walls = []
    for _ in range(args.reps):
        out, s = wall(decode)
        if out != corpus:
            raise AssertionError("the device decode does not give the corpus back")
        walls.append(s)
    launches = {name: n // args.reps for c in counts for name, n in c.items()}
    timings: dict[str, float] = {}
    split: dict[str, float] = {}
    has_split = "split" in inspect.signature(device_decode._decompress_device_inner).parameters
    clocked, clocked_s = wall(lambda: decode(timings, split) if has_split else decode(timings))
    if clocked != corpus:
        raise AssertionError("the clocked device decode does not give the corpus back")
    trace = device_profile(decode, top=None)
    if trace["result"] != corpus:
        raise AssertionError("the traced device decode does not give the corpus back")
    _, host_s = wall(lambda: bz2tpu_torch.decompress(stream))
    _, stdlib_s = wall(lambda: stdlib_bz2.decompress(stream))
    print(json.dumps({
        "card": gpu_name_and_power_limit(),
        "root": str(Path(args.root).resolve()),
        "stream_crc32": zlib.crc32(stream),
        "stream_bytes": len(stream),
        "unclocked_walls_s": walls,
        "decode_mb_s": mb / min(walls),
        "host_c_decoder_mb_s": mb / host_s,
        "stdlib_mb_s": mb / stdlib_s,
        "launches_per_decode": launches,
        "clocked_s": clocked_s,
        "stages_s": timings,
        "steps_s": split,
        "profiled_wall_s": trace["wall_s"],
        "device_events": trace["device_events"],
        "kernel_events": trace["kernel_events"],
        "device_busy_s": trace["busy_s"],
        "busy_share_of_min_unprofiled_wall": trace["busy_s"] / min(walls),
        "top": trace["top"][:15],
        "decode_kernels": {name: {"s": sum(op["s"] for op in trace["top"] if name in op["name"]),
                                  "launches": sum(op["launches"] for op in trace["top"] if name in op["name"])}
                           for name in DECODE_KERNEL_NAMES},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
