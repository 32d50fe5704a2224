"""Smoke run of bz2tpu_torch on one CUDA card: build, kernels, main path.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. environment: card name and power limit, torch/CUDA versions, nvcc,
     the native host library, and the kernel build time;
  2. each CUDA kernel against its plain torch version on the card, at the
     main path's shapes (a 900 kB level-9 block for the BWT sort and
     re-rank, a batch of 8 such blocks for the MTF ranks): results must be
     exactly equal (integer codec, tolerance 0), both timed with CUDA events;
  3. the main path: bz2tpu_torch.compress(level=9) on a 16 MB mixed corpus,
     decoded by stdlib bz2 and by bz2tpu_torch.decompress, with every kernel
     launched; its first 2 MB byte-identical to the port's plain torch path
     on the CPU (which tests/test_torch_compress.py holds byte-identical to
     the JAX package and its NumPy oracle); prints MB/s of an unclocked run
     against stdlib bz2 on the same bytes, then the per-stage split of a
     second, clocked run.
The script imports nothing of JAX or of the JAX package: the port and the
host layers it shares are reached through bz2tpu_torch. The line before
the last is the kernel table as JSON; the last line is {"ok": true,
"device": {...}}. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import bz2 as stdlib_bz2
import json
import sys
import time

import torch

LEVEL = 9
CORPUS_BYTES = 16_000_000
CHECK_BYTES = 2_000_000


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype mismatch {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def compare(name, fn, ref, reps) -> dict:
    """Kernel call fn() against its plain version ref() on the same inputs:
    exact agreement, then both timed."""
    got, want = fn(), ref()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ms, plain_ms = cuda_ms(fn, reps), cuda_ms(ref, reps)
    print(f"kernel {name}: max_abs_err={err} (tolerance 0)  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version (max_abs_err {err})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "bwt_sort": ("bz2tpu_torch/csrc/bwt_sort.cu", "bz2tpu/ops/bwt_pallas.py:118"),
    "bwt_rerank": ("bz2tpu_torch/csrc/bwt_rerank.cu", "bz2tpu/ops/bwt_pallas.py:243"),
    "mtf_ranks": ("bz2tpu_torch/csrc/mtf_ranks.cu", "bz2tpu/ops/mtf_pallas.py:72"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    import numpy as np

    import bench
    import bz2tpu_torch
    from bz2tpu_torch import _build
    from bz2tpu_torch.ops import bwt, bwt_cuda, mtf, mtf_cuda
    from bz2tpu_torch.runtime.compressor import HAVE_NATIVE, split_blocks
    from bz2tpu_torch.utils.device import gpu_name_and_power_limit

    dev = torch.device("cuda")
    # -- 1. environment ---------------------------------------------------
    card = gpu_name_and_power_limit()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} ({torch.cuda.get_device_name(0)})")
    print(f"nvcc {_build.nvcc_path()}  native host library {HAVE_NATIVE}")
    t0 = time.perf_counter()
    _build.lib()
    print(f"kernel library ready in {time.perf_counter() - t0:.3f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")

    corpus = bench.make_mixed_corpus(CORPUS_BYTES)
    # -- 2. kernels against their plain versions at main-path shapes -------
    blocks = split_blocks(corpus, LEVEL)
    batch = blocks[:8]
    buf = np.zeros((len(batch), max(b.data.size for b in batch)), np.uint8)
    for i, b in enumerate(batch):
        buf[i, : b.data.size] = b.data
    ns = torch.tensor([b.data.size for b in batch], dtype=torch.int32, device=dev)
    blocks_t = torch.from_numpy(buf).to(dev)
    n0 = int(ns[0])
    print(f"kernel shapes: BWT block n={n0}; MTF batch {tuple(blocks_t.shape)}")

    # The table reports each kernel at its most frequent main-path use: the
    # pair-round sort and re-rank, and the MTF ranks of one batch.
    stats: dict[str, dict] = {}
    keys0, nb, k0 = bwt.round0_keys(blocks_t[0, :n0].to(torch.int64))
    sorted0 = bwt_cuda.sort_keys_ref(keys0, nb, nb + 24)
    compare("bwt_sort_round0", lambda: bwt_cuda.sort_keys(keys0, nb, nb + 24),
            lambda: bwt_cuda.sort_keys_ref(keys0, nb, nb + 24), 10)
    rank0, _ = bwt_cuda.rerank_ref(sorted0, nb)
    keys1 = bwt.pair_keys(rank0, k0, nb)
    sorted1 = bwt_cuda.sort_keys_ref(keys1, nb, 3 * nb)
    stats["bwt_sort"] = compare("bwt_sort", lambda: bwt_cuda.sort_keys(keys1, nb, 3 * nb),
                                lambda: bwt_cuda.sort_keys_ref(keys1, nb, 3 * nb), 10)
    compare("bwt_rerank_round0", lambda: bwt_cuda.rerank(sorted0, nb),
            lambda: bwt_cuda.rerank_ref(sorted0, nb), 10)
    stats["bwt_rerank"] = compare("bwt_rerank", lambda: bwt_cuda.rerank(sorted1, nb),
                                  lambda: bwt_cuda.rerank_ref(sorted1, nb), 10)
    last, _ = bwt.bwt_stage(blocks_t, ns)
    cseq, _, m, _, n_in_use = mtf.collapse(last, ns)
    print(f"MTF collapsed lengths m={m.tolist()}")
    stats["mtf_ranks"] = compare("mtf_ranks", lambda: mtf_cuda.mtf_ranks(cseq, n_in_use, m),
                                 lambda: mtf_cuda.mtf_ranks_ref(cseq, n_in_use, m), 3)

    # -- 3. the main path ---------------------------------------------------
    head = corpus[:CHECK_BYTES]
    t0 = time.perf_counter()
    out_head = bz2tpu_torch.compress(head, level=LEVEL)  # also the warm-up
    print(f"warm-up compress of {len(head)} B on the card: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    want_head = bz2tpu_torch.compress(head, level=LEVEL, device="cpu")
    print(f"plain torch compress of {len(head)} B on the CPU: {time.perf_counter() - t0:.3f} s")
    if out_head != want_head:
        raise AssertionError("the card's stream differs from the CPU path's on the first 2 MB")
    print("first 2 MB byte-identical to the plain torch path on the CPU: True")

    for counts in (bwt_cuda.LAUNCHES, mtf_cuda.LAUNCHES):
        for name in counts:
            counts[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bz2tpu_torch.compress(corpus, level=LEVEL)
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t0
    launches = {**bwt_cuda.LAUNCHES, **mtf_cuda.LAUNCHES}
    print(f"main-path kernel launches: {launches}")
    for name in KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    t0 = time.perf_counter()
    stock = stdlib_bz2.compress(corpus, LEVEL)
    stock_s = time.perf_counter() - t0
    if stdlib_bz2.decompress(out) != corpus:
        raise AssertionError("stdlib bz2 does not decode the port's stream to the input")
    if bz2tpu_torch.decompress(out) != corpus:
        raise AssertionError("bz2tpu_torch.decompress does not decode the port's stream to the input")
    print("16 MB stream decoded by stdlib bz2 and by bz2tpu_torch.decompress: True")

    timings: dict[str, float] = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clocked = bz2tpu_torch.compress(corpus, level=LEVEL, timings=timings)
    clocked_s = time.perf_counter() - t0
    if clocked != out:
        raise AssertionError("the clocked run's stream differs from the unclocked run's")

    mb = len(corpus) / 1e6
    print(f"level {LEVEL}, {len(corpus)} B in {len(blocks)} blocks:")
    print(f"  port   {mb / port_s:.3f} MB/s ({port_s:.3f} s, unclocked)  ratio {len(out) / len(corpus):.6f}")
    print(f"  stdlib {mb / stock_s:.3f} MB/s ({stock_s:.3f} s)  ratio {len(stock) / len(corpus):.6f}")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
    host = clocked_s - sum(timings.values())
    print(f"  clocked run {clocked_s:.3f} s, per stage (synchronised): {stages}, "
          f"host split+stitch {host:.3f} s")
    print(f"  card: {card}")

    table = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **stats[name]}
        for name, (source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
