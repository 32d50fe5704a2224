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
     second, clocked run;
  4. the fully-device path on the same corpus at level 9: (a) the dec_chain
     kernel against its plain loop at the shapes of the stream's batch
     with the most Huffman groups (exact); (b) decompress_device of
     phase 3's stream and of stdlib's, each equal to the corpus and
     decoded on the card with no host fallback, timed against the host C
     decoder and stdlib bz2; (c) compress_device_intake of the corpus,
     decoded by stdlib bz2, byte-identical to the CPU path on its first
     2 MB, MB/s against stdlib; then the peak device memory.
Each phase's main path runs with every launch count set to 0 just before
it, and fails if a kernel of that path was not launched.
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


def zero(*counts) -> None:
    for c in counts:
        for name in c:
            c[name] = 0


def timed(fn):
    """(result, seconds) of fn(), synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# name -> (source, the TPU kernel it replaces). dec_chain replaces no
# pl.pallas_call: it is the device lax.fori_loop of the Huffman group chain.
KERNELS = {
    "bwt_sort": ("bz2tpu_torch/csrc/bwt_sort.cu", "bz2tpu/ops/bwt_pallas.py:118"),
    "bwt_rerank": ("bz2tpu_torch/csrc/bwt_rerank.cu", "bz2tpu/ops/bwt_pallas.py:243"),
    "mtf_ranks": ("bz2tpu_torch/csrc/mtf_ranks.cu", "bz2tpu/ops/mtf_pallas.py:72"),
    "dec_chain": ("bz2tpu_torch/csrc/dec_chain.cu", "bz2tpu/ops/huffman_dec.py:237"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    import numpy as np

    import bench
    import bz2tpu_torch
    from bz2tpu_torch import _build
    from bz2tpu_torch.ops import bwt, bwt_cuda, dec_cuda, huffman_dec, mtf, mtf_cuda
    from bz2tpu_torch.runtime import device_decode
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

    all_counts = (bwt_cuda.LAUNCHES, mtf_cuda.LAUNCHES, dec_cuda.LAUNCHES)
    encode_kernels = ("bwt_sort", "bwt_rerank", "mtf_ranks")
    zero(*all_counts)
    out, port_s = timed(lambda: bz2tpu_torch.compress(corpus, level=LEVEL))
    launches = {**bwt_cuda.LAUNCHES, **mtf_cuda.LAUNCHES}
    print(f"main-path kernel launches: {launches}")
    for name in encode_kernels:
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

    # -- 4. the fully-device path -------------------------------------------
    # (a) dec_chain at the shapes of the port stream's batch with the most
    # Huffman groups (the longest chain of the main path).
    parsed, _ = device_decode.parse_blocks(out)
    nbc, group = max(device_decode.batches(parsed),
                     key=lambda b: max(parsed[i]["selectors"].size for i in b[1]))
    bt = device_decode.batch_tensors([parsed[i] for i in group], dev)
    words = device_decode.stream_words(out, dev)
    jump50 = huffman_dec.jump50_maps(words, bt["start_bit"], bt["lut"], bt["lut_idx"], nbc)
    tbl, n_groups = bt["selectors"], bt["n_groups"]
    print(f"dec_chain shapes: jump50 {tuple(jump50.shape)}, groups {tuple(tbl.shape)}, "
          f"n_groups {n_groups.tolist()}")
    stats["dec_chain"] = compare("dec_chain", lambda: dec_cuda.group_starts(jump50, tbl, n_groups),
                                 lambda: dec_cuda.group_starts_ref(jump50, tbl, n_groups), 3)
    del bt, words, jump50, tbl, n_groups

    # (b) decode on the card: the port's stream and stdlib's, no host fallback.
    device_decode.decompress_device(stdlib_bz2.compress(head, LEVEL))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    zero(*all_counts)
    dec_port, dec_port_s = timed(lambda: device_decode._decompress_device_inner(out, True, dev))
    dec_stock, dec_stock_s = timed(lambda: device_decode._decompress_device_inner(stock, True, dev))
    dec_launches = dec_cuda.LAUNCHES["dec_chain"]
    print(f"decode-path kernel launches: {dict(dec_cuda.LAUNCHES)}")
    if dec_launches <= 0:
        raise AssertionError("kernel dec_chain was not launched on the device decode path")
    decode_peak = torch.cuda.max_memory_allocated()
    if dec_port is None or dec_stock is None:
        raise AssertionError("the device decode left a 16 MB stream to the host decoder")
    if dec_port != corpus or dec_stock != corpus:
        raise AssertionError("decompress_device does not decode the 16 MB streams to the input")
    if bz2tpu_torch.decompress_device(out) != corpus:
        raise AssertionError("bz2tpu_torch.decompress_device does not decode the port's stream")
    _, host_s = timed(lambda: bz2tpu_torch.decompress(out))
    _, stdlib_dec_s = timed(lambda: stdlib_bz2.decompress(out))
    print("16 MB streams (port's, stdlib's) decoded on the card with no host fallback: True")
    print(f"  decompress_device {mb / dec_port_s:.3f} MB/s ({dec_port_s:.3f} s, port's stream), "
          f"{mb / dec_stock_s:.3f} MB/s ({dec_stock_s:.3f} s, stdlib's stream)")
    print(f"  host C decoder (bz2tpu_torch.decompress) {mb / host_s:.3f} MB/s ({host_s:.3f} s); "
          f"stdlib bz2.decompress {mb / stdlib_dec_s:.3f} MB/s ({stdlib_dec_s:.3f} s)")
    print(f"  peak device memory of the two decodes: {decode_peak} B ({decode_peak / 2**30:.3f} GiB)")
    dec_timings: dict[str, float] = {}
    clocked_dec, clocked_dec_s = timed(
        lambda: device_decode._decompress_device_inner(out, True, dev, dec_timings))
    if clocked_dec != corpus:
        raise AssertionError("the clocked device decode differs from the input")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in dec_timings.items())
    print(f"  clocked decode of the port's stream {clocked_dec_s:.3f} s, per stage (synchronised): {stages}")

    # (c) compress with the intake on the card.
    t0 = time.perf_counter()
    intake_head = bz2tpu_torch.compress_device_intake(head, level=LEVEL)  # also the warm-up
    print(f"warm-up compress_device_intake of {len(head)} B: {time.perf_counter() - t0:.3f} s")
    if intake_head != bz2tpu_torch.compress_device_intake(head, level=LEVEL, device="cpu"):
        raise AssertionError("compress_device_intake on the card differs from the CPU path on 2 MB")
    print("compress_device_intake: first 2 MB byte-identical to the CPU path: True")
    torch.cuda.reset_peak_memory_stats()
    zero(*all_counts)
    intake_out, intake_s = timed(lambda: bz2tpu_torch.compress_device_intake(corpus, level=LEVEL))
    intake_launches = {**bwt_cuda.LAUNCHES, **mtf_cuda.LAUNCHES}
    print(f"intake-path kernel launches: {intake_launches}")
    for name in encode_kernels:
        if intake_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the device-intake path")
    if stdlib_bz2.decompress(intake_out) != corpus:
        raise AssertionError("stdlib bz2 does not decode the device-intake stream to the input")
    print(f"  compress_device_intake {mb / intake_s:.3f} MB/s ({intake_s:.3f} s) ratio "
          f"{len(intake_out) / len(corpus):.6f}; stdlib {mb / stock_s:.3f} MB/s (phase 3)")
    print(f"  peak device memory of the intake compress: {torch.cuda.max_memory_allocated()} B")
    print(f"  card: {card}")
    launches["dec_chain"] = dec_launches

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
