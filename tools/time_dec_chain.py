"""D1, the Huffman group chain (csrc/dec_chain.cu), timed on the chains a
decode hands it, for one checkout of bz2tpu_torch.

    python3 tools/time_dec_chain.py [--root DIR] [--reps N]

Imports bz2tpu_torch from --root (default: this checkout), so the same
script times another checkout's kernel on the same inputs: run it on two
checkouts in turns in one call (A, B, B, A) to compare their kernels within
the noise of one card. It builds the 16 MB mixed corpus at level 9
(bz2tpu_torch.utils.corpus), the port's stream of it and stdlib bz2's, and
for every device batch of each stream (device_decode.batches) the jump maps
the decode hands the kernel; then two synthetic chains of the longest shape
(8 blocks of 18,002 groups at 2^23 bits): groups of steady width (180-220
bits whatever the table, as in random bytes) and of widths set by the table
(80-420 bits, as in text). Each chain is checked against group_starts_ref
(exact) and timed with CUDA events. It prints one JSON object: the card, the
root, the streams' CRC-32s, and per chain its shape, the kernel's ms, its
ns per group of the longest chain, and the steps that read the map directly
(where the checkout's wrapper counts them, else null). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bz2 as stdlib_bz2
import inspect
import json
import sys
import zlib
from pathlib import Path

import torch

LEVEL = 9
CORPUS_BYTES = 16_000_000


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose bz2tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_dec_chain: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import bz2tpu_torch
    from bz2tpu_torch.ops import dec_cuda, huffman_dec
    from bz2tpu_torch.runtime import device_decode
    from bz2tpu_torch.utils.corpus import make_mixed_corpus
    from bz2tpu_torch.utils.device import gpu_name_and_power_limit

    dev = torch.device("cuda")
    counts_misses = "with_misses" in inspect.signature(dec_cuda.group_starts).parameters
    rows = []

    def measure(label: str, jump50, tbl, n_groups) -> None:
        want = dec_cuda.group_starts_ref(jump50, tbl, n_groups)
        got = dec_cuda.group_starts(jump50, tbl, n_groups)
        if not torch.equal(got, want):
            raise AssertionError(f"dec_chain disagrees with its plain loop on {label}")
        misses = None
        if counts_misses:
            misses = dec_cuda.group_starts(jump50, tbl, n_groups, with_misses=True)[1].tolist()
        ms = cuda_ms(lambda: dec_cuda.group_starts(jump50, tbl, n_groups), args.reps)
        longest = int(n_groups.max())
        rows.append({"chain": label, "jump50": list(jump50.shape), "n_groups": n_groups.tolist(),
                     "ms": ms, "ns_per_group": ms * 1e6 / max(longest, 1), "misses": misses})

    corpus = make_mixed_corpus(CORPUS_BYTES)
    bz2tpu_torch.compress(corpus[:2_000_000], level=LEVEL)  # warm-up: kernel build
    streams = {"port": bz2tpu_torch.compress(corpus, level=LEVEL), "stdlib": stdlib_bz2.compress(corpus, LEVEL)}
    for name, stream in streams.items():
        parsed, _ = device_decode.parse_blocks(stream)
        words = device_decode.stream_words(stream, dev)
        for k, (nbc, group) in enumerate(device_decode.batches(parsed)):
            bt = device_decode.batch_tensors([parsed[i] for i in group], dev)
            jump50 = huffman_dec.jump50_maps(words, bt["start_bit"], bt["lut"], bt["lut_idx"], nbc)
            measure(f"{name} batch {k}", jump50, bt["selectors"], bt["n_groups"])
            del bt, jump50
        del words

    gen = torch.Generator(device=dev).manual_seed(5)
    B, T, nbc, G = 8, 6, 1 << 23, 18_002
    tbl = torch.randint(0, T, (B, G), device=dev, generator=gen, dtype=torch.int32)
    n_groups = torch.full((B,), G, dtype=torch.int32, device=dev)
    pos = torch.arange(nbc, device=dev)
    for label, lo, span in (("steady widths 180-220", torch.full((T,), 180, device=dev), 41),
                            ("widths by table 80-420", 80 + 60 * torch.arange(T, device=dev), 41)):
        step = lo[None, :, None] + (torch.rand(B, T, nbc, device=dev, generator=gen) * span).long()
        jump50 = (pos + step).clamp(0, nbc - 1).to(torch.int32)
        del step
        measure(label, jump50, tbl, n_groups)
        del jump50

    print(json.dumps({"card": gpu_name_and_power_limit(), "root": str(Path(args.root).resolve()),
                      "streams_crc32": {k: zlib.crc32(v) for k, v in streams.items()}, "chains": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
