"""The device-intake compress (compress_device_intake) of the 16 MB corpus,
timed on the card for one checkout of bz2tpu_torch.

    python3 tools/time_intake.py [--root DIR] [--reps N]

Imports bz2tpu_torch from --root (default: this checkout), so the same
script times another checkout's intake on the same input: run it on two
checkouts in turns in one call (A, B, B, A) to compare them within the
noise of one card. It builds the 16 MB mixed corpus at level 9
(bz2tpu_torch.utils.corpus) and compresses it on the card: one warm-up,
then N unclocked runs each of compress_device_intake and of compress (the
host-split path, the same blocks through the same encode kernels) in
turns, every stream decoded by stdlib bz2. It records the chunk windows
the intake formed (each device_intake call: window and bytes), splits the
first chunk's intake into its steps (chip_smoke.py's intake_split:
rle1_encode, block_cuts, the rows gather and crc32_ranges, lapped inside
device_intake by a stage clock; null for a checkout whose device_intake
takes no lap), counts that chunk's host-issued aten ops and device events,
and traces one warm intake compress under torch.profiler with device
activity only (device events, kernels among them, busy seconds, the
costliest ops; chip_smoke.py's device_profile). It prints one JSON object:
the card's name and power limit, the root, the stream's CRC-32, the walls,
MB/s, the windows, the split, the counts, the trace, and the intake
kernels' launches per compress where the checkout has them. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import bz2 as stdlib_bz2
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
LEVEL = 9
CORPUS_BYTES = 16_000_000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT), help="checkout whose bz2tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_intake: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_profile, host_op_count, intake_split, timed  # this checkout's

    sys.path.insert(0, str(Path(args.root).resolve()))
    import bz2tpu_torch
    from bz2tpu_torch.ops.intake import chunk_capacity
    from bz2tpu_torch.runtime import compressor
    from bz2tpu_torch.utils.corpus import make_mixed_corpus
    from bz2tpu_torch.utils.device import gpu_name_and_power_limit

    try:
        from bz2tpu_torch.ops import crc_cuda, rle1_cuda

        tables = (crc_cuda.LAUNCHES, rle1_cuda.LAUNCHES)
    except ImportError:  # a checkout without the intake kernels
        tables = ()
    dev = torch.device("cuda")
    corpus = make_mixed_corpus(CORPUS_BYTES)
    mb = len(corpus) / 1e6
    windows: list[list[int]] = []
    real_intake = compressor.device_intake
    compressor.device_intake = lambda chunk, length, **kw: (
        windows.append([chunk.shape[0], length]) or real_intake(chunk, length, **kw))
    intake = lambda: bz2tpu_torch.compress_device_intake(corpus, level=LEVEL)  # noqa: E731
    stream = intake()  # warm-up
    bz2tpu_torch.compress(corpus, level=LEVEL)
    if stdlib_bz2.decompress(stream) != corpus:
        raise AssertionError("stdlib bz2 does not decode the intake's stream")
    for table in tables:
        for name in table:
            table[name] = 0
    intake_walls, compress_walls = [], []
    for _ in range(args.reps):
        windows.clear()
        out, s = timed(intake)
        chunks = list(windows)
        if out != stream:
            raise AssertionError("an unclocked intake compress differs from the warm-up's")
        intake_walls.append(s)
        out, s = timed(lambda: bz2tpu_torch.compress(corpus, level=LEVEL))
        if stdlib_bz2.decompress(out) != corpus:
            raise AssertionError("stdlib bz2 does not decode compress's stream")
        compress_walls.append(s)
    counts = {name: n // args.reps for table in tables for name, n in table.items()}
    chunk_n = chunk_capacity(LEVEL, compressor.DEFAULT_BATCH)
    take = min(chunk_n, len(corpus))
    padded = np.zeros(chunk_n, np.uint8)
    padded[:take] = np.frombuffer(corpus, np.uint8)[:take]
    chunk = torch.from_numpy(padded).to(dev)
    split = intake_split(chunk, take, LEVEL, compressor.DEFAULT_BATCH)
    one = lambda: real_intake(chunk, take, level=LEVEL, max_blocks=compressor.DEFAULT_BATCH)  # noqa: E731
    ops = host_op_count(one)
    chunk_trace = device_profile(one)
    trace = device_profile(intake, top=15)
    if trace["result"] != stream:
        raise AssertionError("the traced intake compress differs from the unclocked one")
    print(json.dumps({
        "card": gpu_name_and_power_limit(),
        "root": str(Path(args.root).resolve()),
        "stream_crc32": zlib.crc32(stream),
        "stream_bytes": len(stream),
        "windows": chunks,
        "intake_walls_s": intake_walls,
        "compress_walls_s": compress_walls,
        "intake_mb_s": mb / min(intake_walls),
        "compress_mb_s": mb / min(compress_walls),
        "gap_s": min(intake_walls) - min(compress_walls),
        "launches_per_compress": counts,
        "first_chunk_steps_s": split,
        "first_chunk_host_aten_ops": ops,
        "first_chunk_device_events": chunk_trace["device_events"],
        "first_chunk_kernel_events": chunk_trace["kernel_events"],
        "profiled_wall_s": trace["wall_s"],
        "device_events": trace["device_events"],
        "kernel_events": trace["kernel_events"],
        "device_busy_s": trace["busy_s"],
        "busy_share_of_min_unprofiled_wall": trace["busy_s"] / min(intake_walls),
        "top": trace["top"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
