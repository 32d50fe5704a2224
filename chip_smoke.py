"""Smoke run of bz2tpu_torch on one CUDA card: build, kernels, main path.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. environment: card name and power limit, torch/CUDA versions, nvcc,
     the native host library, and the kernel build time;
  2. each CUDA kernel against its plain torch version on the card, at the
     main path's shapes: the corpus's first batch of 8 level-9 blocks for
     the BWT sort (all blocks in one sort, against a stable torch.sort of
     the same bit field too) and the slot-aware re-rank (round 0 and the
     pair round, with the time of a bare scatter to the same destinations
     beside it), the MTF ranks of that batch (at the default chunk length
     and at 2,048, then timed over a sweep of chunk lengths), and its
     whole Huffman refinement (selectors, their MTF ranks and code
     lengths; each block's iteration count printed): results must be
     exactly equal (integer codec, tolerance 0), all timed with CUDA
     events;
  3. the main path: bz2tpu_torch.compress(level=9) on a 16 MB mixed corpus
     (bz2tpu_torch.utils.corpus; the run says how much of its real-text
     part came from installed files and how much from the Markov fallback),
     decoded by stdlib bz2 and by bz2tpu_torch.decompress, with every kernel
     launched, the BWT sort once per doubling round of each batch (the
     count each batch's slowest block needs alone), not once per block and
     round, and the Huffman refinement once per batch; its first 2 MB
     byte-identical to the port's plain torch path on the CPU (which tests/test_torch_compress.py holds byte-identical to
     the JAX package and its NumPy oracle); prints MB/s of an unclocked run
     against stdlib bz2 on the same bytes, then the per-stage split of a
     second, clocked run;
  4. the fully-device path on the same corpus at level 9: (a) the decode
     kernels against their plain loops (exact): dec_chain at the shapes of
     the stream's batch with the most Huffman groups, with its ns per
     group of the longest chain; dec_symbols and mtf_dec on the inputs a
     decode of the batch with the most symbols hands them (dec_symbols'
     first-level tables against their plain version and the symbols whose
     window reads a 1 MiB LUT row; mtf_dec's steps that are trailing
     padding and those the kernel skips; for both, the kernels' device time
     by torch.profiler and their time as a multiple of the bound); rle1_dec
     (both launches) on the rows a level-9 decode of 8 x 900 kB of the
     benchmark's enwik mix hands it, with its output bound, crc_ranges over
     its output, the decode's whole step and the C core's inverse_rle1 over
     the same rows on the host; and on every
     batch of the port's and stdlib's 16 MB streams dec_chain's share of
     steps whose window missed (tools/time_dec_chain.py times the kernel
     of two checkouts on those batches); the intake kernels against their
     plain versions (exact) at the shapes of the intake's first 8 MiB
     chunk of the corpus: block_cuts on its pieces' sums (with its latency
     bound: one 256-ary search's dependent loads and a window's at L2's
     latency, which tools/load_latency.py's pointer chase measures; none
     of its cuts may search past its window) and on synthetic sums whose
     cuts do (steps above 5, duplicates: the slow path, counted),
     crc_ranges on its blocks' ranges (beside the host C
     splitter's time over the same bytes, a yardstick), on 16 ranges some
     of them empty, and on a widened 32 MiB chunk; each with its device
     time by torch.profiler;
     (b) decompress_device of phase 3's stream and of stdlib's, each equal to the corpus and
     decoded on the card with no host fallback, with dec_chain,
     dec_symbols and mtf_dec launched on each, timed against the host C
     decoder and stdlib bz2; a clocked decode with the steps of its
     "huffman" and "mtf" stages apart; one torch.profiler trace of a warm
     decode of the port's stream (device events, busy share, top ops); (c) compress_device_intake of the corpus,
     decoded by stdlib bz2, byte-identical to the CPU path on its first
     2 MB, MB/s against phase 3's compress and stdlib, with every encode
     kernel launched and crc_ranges and block_cuts once per device_intake
     call (each chunk window tried); the steps of the first chunk's
     intake (rle1_encode, block_cuts, the rows gather, crc32_ranges,
     each lapped inside device_intake by a stage clock), its
     host-issued aten ops and device events; one torch.profiler trace of a
     warm intake compress; then 24 MB of zeros, whose window widens from
     8 to 16 to 32 MiB: byte-identical to the CPU path, decoded by stdlib
     bz2, the two intake kernels launched once per window; then the peak
     device memory;
  5. files and streams on the card, in a temporary directory: (a) the
     command line's default path, bz2tpu_torch.cli.main([file, "--size",
     "9", "--metrics"]) in this process, which is compress_file through
     StreamCompressor: its .bz2 byte-identical to phase 3's stream and
     decoded by stdlib bz2, then --dec (decompress_file) back to the
     corpus and --check; its MB/s beside phase 3's compress and phase
     4b's decompress, its metrics line (rle1_split / device_encode /
     stitch) and peak device memory beside phase 3's; K1 = K2 once per
     doubling round of each batch the stream formed and D2 once per
     such batch; (b) StreamCompressor fed 1 MB writes with a checkpoint
     after each, dropped at 9 MB, resumed from the truncated sink in a
     fresh instance: byte-identical to (a); (c) bz2tpu_torch.open(...,
     "wb") on the card, read back with a seek and read1; (d) --backend
     device byte-identical to phase 4c's stream, its --dec with
     dec_chain, dec_symbols and mtf_dec launched, and --recover on a
     copy with one block's bytes flipped salvaging every other block;
  6. the block mesh (bz2tpu_torch.parallel) on the same corpus at level 9,
     split into one batch padded to a multiple of the rank count, encoded
     with encode_blocks_sharded and stitched with stitch_stream_shard:
     (a) one rank in this process, no process group, on cuda:0: its
     stream byte-identical to phase 3's, K3 and D2 launched once for the
     one 16-block batch, K1 = K2 once per doubling round of each group of
     8 blocks that bwt_stage sorts together (ops/bwt.slot_limit); (b) two
     ranks on the one card, each a process running this script with
     --mesh-rank (--mesh-mode stitch), in a gloo group (NCCL refuses two ranks on one card):
     each encodes its 8 rows and both stitch the whole stream by
     collectives; rank 0's stream byte-identical to phase 3's, each rank's
     launches those of its own rows. A rank that fails, or that has not
     finished within MESH_TIMEOUT_S, fails the run with its stderr's tail;
     (c) the per-block path (compressor._DEVICE_STITCH off, what
     BZ2TPU_DEVICE_STITCH=0 selects) in this process: compress and
     compress_file of the corpus, each byte-identical to phase 3's stream,
     K1 = K2 once per doubling round of each batch and K3 and D2 once per
     batch, MB/s beside phase 3's compress; (d) two ranks on the one card in
     a gloo group (--mesh-mode compress), each calling bz2tpu_torch.compress
     itself with the per-block path on, which reaches the block mesh: both
     streams byte-identical to phase 3's, each rank's launches those of its
     rows of each batch, the seconds and bytes of the all-gather; (e) the
     mesh's NCCL branch: a child process (this script with --mesh-mode nccl)
     initialises a one-rank NCCL group from env:// through
     parallel.initialize and runs block_mesh, encode_blocks_sharded,
     gather_blocks and stitch_stream_shard (gather_ints then all-gathers a
     CUDA tensor) and compress with the group up: each stream
     byte-identical to phase 3's, the backend printed;
  7. cold start: three fresh processes (this script with --cold-start),
     each with an empty BZ2TPU_TORCH_CACHE_DIR in a temporary directory,
     each compressing the corpus's first 2 MB into a stream that must equal
     phase 3's and decode with stdlib bz2: (a) no artifact, so nvcc and cc
     build both libraries; (b) export_artifact into a temporary directory;
     (c) that artifact through BZ2TPU_TORCH_AOT_DIR, with no nvcc and no cc
     run. For (a) and (c) the wall from the process's start to the stream
     returned, and the child's own split (import, kernel library, first
     compress). A child that fails or outlives COLD_TIMEOUT_S fails the run.
Each phase's main path runs with every launch count set to 0 just before
it, and fails if a kernel of that path was not launched.
The script imports nothing of JAX or of the JAX package. The line before
the last is the kernel table as JSON: per kernel its launches on the 16 MB
compress (dec_chain, dec_symbols, mtf_dec, rle1_dec: on the decode of the
port's stream; crc_ranges, block_cuts: on its intake compress), its time
and its plain version's at the shapes above (dec_symbols, mtf_dec,
crc_ranges, block_cuts and rle1_dec also their device time, device_ms, and the
same calls queued behind a sleep on the device, queued_ms), the
library call's where one
computes the same function, and its bound: the bytes it must move (inputs
read once, outputs written once) over 3.35 TB/s, or its operations over
67 T/s where those take longer. The last line is {"ok": true, "device":
{...}}. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import bz2 as stdlib_bz2
import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
LEVEL = 9
CORPUS_BYTES = 16_000_000
CHECK_BYTES = 2_000_000
WRITE_BYTES, CHECKPOINT_CUT = 1_000_000, 9_000_000  # phase 5b: write size, where the compressor drops
MESH_RANKS, MESH_TIMEOUT_S = 2, 300  # phases 6b and 6d: processes on the one card, their wall-clock limit
COLD_TIMEOUT_S = 300  # phase 7: each fresh process's wall-clock limit
ZEROS_BYTES = 24_000_000  # phase 4c: an input whose window widens twice


QUEUE_CYCLES_PER_CALL = 200_000  # queued_ms: the sleep a call, ~0.1 ms at the card's clock


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


def device_events(fn, reps: int) -> dict:
    """fn() once, then reps calls under torch.profiler (device activity):
    per device op name, its mean milliseconds a launch over the events
    the profiler saw, the events it saw, and its launches a call (those
    events over reps, at least 1). Means over the events seen, not over
    reps, so that events the profiler drops do not read as a faster
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.elapsed_us() > 0:
            entry = seen.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    if not seen:
        raise AssertionError("the profiler recorded no device time")
    return {name: {"ms": total / count, "events": count, "per_call": max(1, round(count / reps))}
            for name, (total, count) in seen.items()}


def call_ms(ops: dict) -> float:
    """Device milliseconds a call from device_events: each op's mean a
    launch times its launches a call."""
    return sum(op["ms"] * op["per_call"] for op in ops.values())


def device_ms(fn, reps: int) -> float:
    """Milliseconds of device time per fn() over reps runs after one
    warm-up, by torch.profiler (device_events), without the gaps the host
    leaves between launches (which cuda_ms counts)."""
    return call_ms(device_events(fn, reps))


def queued_ms(fn, reps: int) -> tuple[float, bool]:
    """Milliseconds per fn() by CUDA events, with the reps calls queued
    behind a kernel that sleeps longer than the host takes to issue them:
    the device runs them back to back, so the time leaves out the host's
    issue time and keeps the device's own gaps between launches (a bound
    from above on the kernels' time); and whether the sleep did outlast
    the issue (if not, host time is in)."""
    fn()
    torch.cuda.synchronize()
    before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t0 = time.perf_counter()
    before.record()
    torch.cuda._sleep(int(reps * QUEUE_CYCLES_PER_CALL))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, before.elapsed_time(start) > issue_ms


def max_abs_err(got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype mismatch {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
CORE_OPS_PER_S = 67e12  # H100 SXM outside the tensor cores (float32 rate)


def compare(name, fn, ref, reps, *, nbytes: int, ops: int = 0, library=None, device: bool = False) -> dict:
    """Kernel call fn() against its plain version ref() on the same inputs:
    exact agreement, then both timed, with the library call where there is
    one, and the kernel's bound from the bytes and operations given; with
    ``device``, also the kernels' device time alone (device_ms), held
    against the same launches queued on the device (queued_ms)."""
    got, want = fn(), ref()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version (max_abs_err {err})")
    ms, plain_ms = cuda_ms(fn, reps), cuda_ms(ref, reps)
    library_ms = None if library is None else cuda_ms(library, reps)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / CORE_OPS_PER_S * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
    print(f"kernel {name}: max_abs_err={err} (tolerance 0)  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
          f"{lib}  bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {ops} ops)")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    if device:
        ops = device_events(fn, 10 * reps)
        row["device_ms"], events = call_ms(ops), sum(op["events"] for op in ops.values())
        row["queued_ms"], queued = queued_ms(fn, 10 * reps)
        print(f"kernel {name}: device {row['device_ms']:.4f} ms a call ({10 * reps} calls, torch.profiler, "
              f"{events} device events seen); queued {row['queued_ms']:.4f} ms a call (CUDA events, the calls "
              f"queued behind a sleep{'' if queued else ' that did NOT outlast their issue, host time in'}); "
              f"{ms / bound_ms:.2f} x its bound by events, {row['device_ms'] / bound_ms:.2f} x by device time")
    return row


def device_profile(fn, top: int | None = 12) -> dict:
    """fn() once under torch.profiler with device activity only: its
    result and wall, the device events the profiler saw (kernels apart
    from copies and sets), the device busy seconds, and the ``top`` op
    names by device time with their launches (all of them for None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result, wall = timed(fn)
    per_name: dict[str, list] = {}
    for avg in prof.key_averages():
        if avg.device_type == DeviceType.CUDA and avg.self_device_time_total > 0:
            entry = per_name.setdefault(avg.key, [0.0, 0])
            entry[0] += avg.self_device_time_total / 1e6
            entry[1] += avg.count
    busy = sum(s for s, _ in per_name.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    return {
        "result": result, "wall_s": wall, "busy_s": busy,
        "device_events": sum(c for _, c in per_name.values()),
        "kernel_events": sum(c for k, (_, c) in per_name.items() if not k.startswith(("Memcpy", "Memset"))),
        "top": [{"name": k[:80], "s": sec, "launches": c} for k, (sec, c) in ranked[:top]],
    }


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


# name -> (source, the TPU kernel it replaces). dec_chain, dec_symbols,
# mtf_dec, crc_ranges, block_cuts and huffman_plan replace no
# pl.pallas_call: they are the device loops of the Huffman group chain,
# the group-symbol decode, the inverse MTF's chunk permutations, the
# intake's range CRCs and its block cuts (each a lax.fori_loop) and of the
# Huffman refinement (lax.while_loop around the code-length tree scan).
KERNELS = {
    "bwt_sort": ("bz2tpu_torch/csrc/bwt_sort.cu", "bz2tpu/ops/bwt_pallas.py:118"),
    "bwt_rerank": ("bz2tpu_torch/csrc/bwt_rerank.cu", "bz2tpu/ops/bwt_pallas.py:243"),
    "mtf_ranks": ("bz2tpu_torch/csrc/mtf_ranks.cu", "bz2tpu/ops/mtf_pallas.py:72"),
    "huffman_plan": ("bz2tpu_torch/csrc/huffman_plan.cu", "bz2tpu/ops/huffman.py:278"),
    "dec_chain": ("bz2tpu_torch/csrc/dec_chain.cu", "bz2tpu/ops/huffman_dec.py:237"),
    "dec_symbols": ("bz2tpu_torch/csrc/dec_symbols.cu", "bz2tpu/ops/huffman_dec.py:265"),
    "mtf_dec": ("bz2tpu_torch/csrc/mtf_dec.cu", "bz2tpu/ops/mtf_dec.py:110"),
    "crc_ranges": ("bz2tpu_torch/csrc/crc_ranges.cu", "bz2tpu/ops/crc.py:166"),
    "block_cuts": ("bz2tpu_torch/csrc/block_cuts.cu", "bz2tpu/ops/rle1.py:162"),
    "rle1_dec": ("bz2tpu_torch/csrc/rle1_dec.cu", "none: bz2tpu/runtime/device_decode.py:285 inverts RLE1 on the host"),
}
DECODE_KERNELS = ("dec_chain", "dec_symbols", "mtf_dec", "rle1_dec")
INTAKE_KERNELS = ("crc_ranges", "block_cuts")
ENWIK_SEED = 2**31 + 2020  # the enwik rows of rle1_dec_phase


def decode_kernel_inputs(stream: bytes, dev) -> dict:
    """The arguments a decode of the stream's batch with the most symbols
    hands dec_symbols ("dec_symbols") and mtf_dec ("mtf_dec"), captured by
    wrapping huffman_dec.decode_groups and mtf_dec.chunk_perms."""
    from bz2tpu_torch.format import constants as C
    from bz2tpu_torch.ops import huffman_dec, mtf_dec
    from bz2tpu_torch.runtime import device_decode

    parsed, _ = device_decode.parse_blocks(stream)
    nbc, group = max(device_decode.batches(parsed),
                     key=lambda b: len(b[1]) * max(parsed[i]["selectors"].size for i in b[1]))
    captured = {}
    real_groups, real_perms = huffman_dec.decode_groups, mtf_dec.chunk_perms

    def capture(name, real):
        def wrapped(*args):
            captured[name] = args
            return real(*args)
        return wrapped

    huffman_dec.decode_groups = capture("dec_symbols", real_groups)
    mtf_dec.chunk_perms = capture("mtf_dec", real_perms)
    try:
        out_cap = device_decode._pow2_at_least((stream[3] - ord("0")) * C.BLOCK_SIZE_BASE)
        words = device_decode.stream_words(stream, dev)
        if device_decode._decode_batch(words, [parsed[i] for i in group], nbc, out_cap, dev, None) is None:
            raise AssertionError("the largest batch of the stream fails its decode")
    finally:
        huffman_dec.decode_groups, mtf_dec.chunk_perms = real_groups, real_perms
    return captured


def enwik_rows(dev, blocks: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows and lengths a level-9 decode of the benchmark's enwik mix
    hands its inverse RLE1 (rle1_dec): the batch of ``blocks`` blocks of
    900 kB, captured by wrapping device_decode.inverse_rle1_crc."""
    from portbench import gen

    from bz2tpu_torch.runtime import device_decode

    mix = gen.load_mix("enwik")
    mix["objects"] = [dict(mix["objects"][0], bytes=(blocks + 1) * 900_000)]
    raw = gen.make_objects(mix, ENWIK_SEED)[0][1]
    stream = stdlib_bz2.compress(raw, 9)
    seen = []
    real = device_decode.inverse_rle1_crc

    def capture(rows, n):
        seen.append((rows.clone(), n.clone()))
        return real(rows, n)

    device_decode.inverse_rle1_crc = capture
    try:
        if device_decode._decompress_device_inner(stream, True, dev) != raw:
            raise AssertionError("the device decode of the enwik stream differs from its input")
    finally:
        device_decode.inverse_rle1_crc = real
    return max(seen, key=lambda rn: rn[0].shape[0])


def rle1_dec_phase(dev) -> dict:
    """rle1_dec (both launches) at the main path's shape, 8 rows of 900 kB
    of enwik, against its plain version on the card (exact), with its byte
    bound; beside it crc_ranges over its output, the whole step as the
    decode runs it (the two launches, the sizes read between them, D5 and
    the copy back), and the host C core's inverse_rle1 over the same rows
    one after another, as the decode ran it before."""
    from bz2tpu_torch import native
    from bz2tpu_torch.ops import crc, rle1_dec, rle1_dec_cuda

    rows, n = enwik_rows(dev)
    plan, offsets = rle1_dec.parse_ref(rows, n)
    total = int(offsets[-1])
    del plan
    out = torch.empty(total, dtype=torch.uint8, device=dev)

    def kernel():
        prefix, offs = rle1_dec_cuda.parse(rows, n)
        return rle1_dec_cuda.expand(rows, n, prefix, offs, out), offs

    def plain():
        plan, offs = rle1_dec.parse_ref(rows, n)
        return rle1_dec.expand_ref(plan, torch.empty(total, dtype=torch.uint8, device=dev)), offs

    n_in = int(n.sum())
    bound = rle1_dec.out_bound(rows.shape[0], int(n.max()))
    print(f"rle1_dec shapes: rows {tuple(rows.shape)}, n {n.tolist()}; {n_in} B in, {total} B out "
          f"(the output bound {bound} B, {bound / 2**20:.1f} MiB)")
    # Its bytes: each input byte read once, each output byte written once.
    row = compare("rle1_dec", kernel, plain, 10, nbytes=n_in + total, device=True)
    starts, ends = offsets[:-1].contiguous(), offsets[1:].contiguous()
    row["crc_ms"] = cuda_ms(lambda: crc.crc32_ranges(out, starts, ends), 10)
    steps = sorted(timed(lambda: rle1_dec.inverse_rle1_crc(rows, n)[0].cpu())[1] for _ in range(7))
    row["step_ms"] = steps[3] * 1e3
    row["copy_ms"] = sorted(timed(lambda: out.cpu())[1] for _ in range(7))[3] * 1e3
    flat, host_ends, crcs = rle1_dec.inverse_rle1_crc(rows, n)
    host_rows = [rows[r, : int(n[r])].cpu().numpy().tobytes() for r in range(rows.shape[0])]
    t0 = time.perf_counter()
    host = [native.inverse_rle1(r) for r in host_rows]
    row["host_native_ms"] = (time.perf_counter() - t0) * 1e3
    got = flat.cpu().numpy()
    for r, (data, crc_r) in enumerate(host):
        if got[host_ends[r] : host_ends[r + 1]].tobytes() != data or int(crcs[r]) != crc_r:
            raise AssertionError(f"rle1_dec's row {r} differs from the C core's inverse_rle1")
    row["out_bound_bytes"], row["out_bytes"] = bound, total
    print(f"rle1_dec: crc_ranges over its output {row['crc_ms']:.4f} ms; the decode's step (both launches, "
          f"the sizes read, D5, the copy back of {total} B) {row['step_ms']:.4f} ms (median of 7), the copy "
          f"back alone {row['copy_ms']:.4f} ms; the host C core's "
          f"inverse_rle1 over the same {rows.shape[0]} rows one after another {row['host_native_ms']:.4f} ms "
          f"({n_in / row['host_native_ms'] / 1e3:.1f} MB/s in); bytes and CRCs equal to the C core's: True")
    return row


def intake_kernel_inputs(corpus: bytes, dev) -> dict:
    """The arguments the intake's first chunk of the corpus hands
    block_cuts and crc_ranges: the chunk window ("chunk", its first "take"
    bytes the corpus's, "padded" its host copy), its pieces' sums
    ("cut_args": piece_out_cum, piece_raw_cum, n_pieces), "cap", the cuts
    the plain block_cuts_ref makes ("cuts") and its blocks' raw ranges
    ("starts", "ends")."""
    import numpy as np

    from bz2tpu_torch.format import constants as C
    from bz2tpu_torch.ops import rle1
    from bz2tpu_torch.ops.intake import chunk_capacity
    from bz2tpu_torch.runtime.compressor import DEFAULT_BATCH

    chunk_n, cap = chunk_capacity(LEVEL, DEFAULT_BATCH), C.block_capacity(LEVEL)
    take = min(chunk_n, len(corpus))
    padded = np.zeros(chunk_n, np.uint8)
    padded[:take] = np.frombuffer(corpus, np.uint8)[:take]
    chunk = torch.from_numpy(padded).to(dev)
    enc = rle1.rle1_encode(chunk, take)
    cut_args = (enc["piece_out_cum"], enc["piece_raw_cum"], enc["n_pieces"])
    cuts = rle1.block_cuts_ref(*cut_args, cap=cap, max_blocks=DEFAULT_BATCH)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), cuts[1][:-1]])
    return {"chunk": chunk, "take": take, "padded": padded, "cut_args": cut_args, "cap": cap, "cuts": cuts,
            "starts": starts, "ends": cuts[1]}


def slow_path_sums(dev, n: int = 1 << 20, seed: int = 14) -> tuple:
    """Sorted per-piece sums that block_cuts' windows do not hold: output
    steps of 1 with a fifth of them 0 (duplicates) and one in twenty a jump
    of 6 to 5,000 (a cut overshoots by more than 4), INT32_MAX past the
    last 1% of entries; (piece_out_cum, piece_raw_cum, n_pieces)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    steps = (rng.random(n) >= 0.2).astype(np.int64) + np.where(rng.random(n) < 0.05, rng.integers(6, 5001, n), 0)
    n_pieces = n - n // 100
    out = np.cumsum(steps)
    raw = np.cumsum(rng.integers(1, 256, n))
    out[n_pieces:] = raw[n_pieces:] = 2**31 - 1
    return (torch.from_numpy(out.astype(np.int32)).to(dev), torch.from_numpy(raw.astype(np.int32)).to(dev),
            torch.tensor(n_pieces, dtype=torch.int32, device=dev))


def search_steps(n: int) -> int:
    """Dependent steps of a 256-ary search over n entries: the fewest a
    warp needs with 256 entries in flight a step (block_cuts' bound)."""
    steps, span = 0, n
    while span > 1:
        span, steps = -(-span // 256), steps + 1
    return max(steps, 1)


def intake_split(chunk, length: int, level: int, max_blocks: int, reps: int = 5) -> dict | None:
    """The steps of ops/intake.device_intake on one chunk, lapped inside it
    by a stage clock (utils/profiling.StageClock): rle1_encode, block_cuts,
    rows (the rows gather, ns and raw lengths) and crc32_ranges, the median
    of ``reps`` runs after a warm-up, in seconds. Reads the bz2tpu_torch
    already imported, so tools/time_intake.py times another checkout's
    steps with it; None for a checkout whose device_intake takes no lap."""
    import inspect

    from bz2tpu_torch.ops.intake import device_intake
    from bz2tpu_torch.utils.profiling import StageClock

    if "lap" not in inspect.signature(device_intake).parameters:
        return None

    def steps() -> dict:
        t: dict[str, float] = {}
        clock = StageClock(t, chunk.device)
        device_intake(chunk, length, level=level, max_blocks=max_blocks, lap=clock.lap)
        return t

    steps()
    runs = [steps() for _ in range(reps)]
    return {k: sorted(r[k] for r in runs)[reps // 2] for k in runs[0]}


def host_op_count(fn) -> int:
    """The top-level aten ops that fn() issues from the host (torch.profiler,
    CPU activity): what eager torch launches one by one."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.cpu_parent is None and e.name.startswith("aten::"))



def cli_run(argv: list[str]) -> tuple[int, str, float]:
    """bz2tpu_torch.cli.main(argv) in this process (the kernels stay
    built): its exit code, what it wrote to stderr, and its seconds."""
    from bz2tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, seconds = timed(lambda: cli.main(argv))
    return rc, err.getvalue(), seconds


def files_and_streams(tmp, corpus, out, intake_out, blocks, block_rounds, all_counts, phase3, card) -> None:
    """Phase 5: the command line's file paths, a checkpoint resumed,
    BZ2File, the device backend and --recover, on the 16 MB corpus."""
    import bz2tpu_torch
    from bz2tpu_torch import native
    from bz2tpu_torch.ops import bwt_cuda, dec_cuda, huffman_cuda, mtf_cuda, mtf_dec_cuda, rle1_dec_cuda
    from bz2tpu_torch.runtime import compressor, stream

    mb = len(corpus) / 1e6
    path = os.path.join(tmp, "corpus.dat")
    with open(path, "wb") as f:
        f.write(corpus)
    # (a) the default path: compress_file through StreamCompressor. The
    # batch sizes the stream forms are recorded on the way to the card.
    sizes: list[int] = []
    real_batch_tensors = compressor._batch_tensors
    compressor._batch_tensors = lambda chunk, device, n_rows=None: (
        sizes.append(len(chunk)) or real_batch_tensors(chunk, device, n_rows))
    torch.cuda.reset_peak_memory_stats()
    zero(*all_counts)
    try:
        rc, err, file_s = cli_run([path, "--size", str(LEVEL), "--metrics"])
    finally:
        compressor._batch_tensors = real_batch_tensors
    file_peak = torch.cuda.max_memory_allocated()
    launches = {**bwt_cuda.LAUNCHES, **mtf_cuda.LAUNCHES, **huffman_cuda.LAUNCHES}
    if rc != 0:
        raise AssertionError(f"the command line's compress exited {rc}: {err}")
    metrics = json.loads([line for line in err.splitlines() if line.startswith("{")][-1])
    print(f"compress_file metrics: {json.dumps(metrics)}")
    with open(path + ".bz2", "rb") as f:
        packed = f.read()
    if packed != out:
        raise AssertionError("the command line's .bz2 differs from phase 3's compress stream")
    if stdlib_bz2.decompress(packed) != corpus:
        raise AssertionError("stdlib bz2 does not decode the command line's .bz2")
    print("command-line .bz2 byte-identical to phase 3's compress stream and decoded by stdlib bz2: True")
    print(f"file-path kernel launches: {launches}; stream batches {sizes} ({metrics['batches']} batches, "
          f"{metrics['blocks']} blocks)")
    for name in ("bwt_sort", "bwt_rerank", "mtf_ranks", "huffman_plan"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the file path")
    if sum(sizes) != len(blocks) or len(sizes) != metrics["batches"] or metrics["blocks"] != len(blocks):
        raise AssertionError(f"the stream's batches {sizes} do not cover the {len(blocks)} blocks")
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    want_sorts = sum(max(block_rounds[s : s + n]) for s, n in zip(starts, sizes))
    if not launches["bwt_sort"] == launches["bwt_rerank"] == want_sorts:
        raise AssertionError(f"K1/K2 launched {launches['bwt_sort']}/{launches['bwt_rerank']} times on the file "
                             f"path, not once per round of each of the stream's batches ({want_sorts})")
    if launches["huffman_plan"] != metrics["batches"]:
        raise AssertionError(f"D2 launched {launches['huffman_plan']} times on the file path, "
                             f"not once per stream batch ({metrics['batches']})")
    dec_path = os.path.join(tmp, "corpus.out")
    rc, err, dec_file_s = cli_run([path + ".bz2", "--dec", "-o", dec_path])
    with open(dec_path, "rb") as f:
        if rc != 0 or f.read() != corpus:
            raise AssertionError(f"the command line's --dec (decompress_file) did not give the corpus back: {err}")
    rc, err, check_s = cli_run([path + ".bz2", "--check"])
    if rc != 0:
        raise AssertionError(f"the command line's --check failed: {err}")
    stages = metrics["stages"]
    print(f"  compress_file (cli, level {LEVEL}) {mb / file_s:.3f} MB/s ({file_s:.3f} s; metrics "
          f"{metrics['seconds']} s: rle1_split {stages['rle1_split']} s, device_encode "
          f"{stages['device_encode']} s, stitch {stages['stitch']} s, host outside the stages "
          f"{metrics['seconds'] - sum(stages.values()):.3f} s); compress (phase 3) "
          f"{mb / phase3['compress']:.3f} MB/s ({phase3['compress']:.3f} s)")
    print(f"  decompress_file (cli --dec) {mb / dec_file_s:.3f} MB/s ({dec_file_s:.3f} s); decompress "
          f"(phase 4b) {mb / phase3['decompress']:.3f} MB/s ({phase3['decompress']:.3f} s); --check "
          f"{check_s:.3f} s")
    print(f"  peak device memory: compress_file {file_peak} B ({file_peak / 2**30:.3f} GiB), compress "
          f"(phase 3) {phase3['compress_peak']} B ({phase3['compress_peak'] / 2**30:.3f} GiB)")

    # (b) checkpoint after each 1 MB write, drop the compressor at 9 MB,
    # resume in a fresh one from the truncated sink.
    step, cut = WRITE_BYTES, CHECKPOINT_CUT
    sink = io.BytesIO()
    sc = stream.StreamCompressor(sink, level=LEVEL)
    for off in range(0, cut, step):
        sc.write(corpus[off : off + step])
        state = sc.checkpoint()
    emitted = sink.getvalue()
    del sc
    keep = stream.StreamCompressor.state_sink_bytes(state)
    resumed = io.BytesIO()
    resumed.write(emitted[:keep])
    sc = stream.StreamCompressor(resumed, state=state)
    if sc.input_offset != cut:
        raise AssertionError(f"the checkpoint resumes at {sc.input_offset}, not {cut}")
    for off in range(cut, len(corpus), step):
        sc.write(corpus[off : off + step])
    sc.close()
    if resumed.getvalue() != packed:
        raise AssertionError("the resumed stream differs from the uninterrupted one")
    print(f"checkpoint at {cut} B: blob {len(state)} B, sink cut to {keep} of {len(emitted)} B; "
          f"resumed stream byte-identical: True")

    # (c) BZ2File on the card, read back with a seek and read1.
    bz_path = os.path.join(tmp, "bz2file.bz2")
    with bz2tpu_torch.open(bz_path, "wb", level=LEVEL) as f:
        f.write(corpus)
    with open(bz_path, "rb") as f:
        if f.read() != packed:
            raise AssertionError("BZ2File's stream differs from compress's")
    with bz2tpu_torch.open(bz_path, "rb") as f:
        first = f.read(1000)
        f.seek(len(corpus) // 2)
        middle = f.read1(65536)
        f.seek(0)
        whole = f.read()
    half = len(corpus) // 2
    if first != corpus[:1000] or not middle or middle != corpus[half : half + len(middle)] or whole != corpus:
        raise AssertionError("BZ2File does not read back what it wrote")
    print(f"BZ2File: written on the card byte-identical to compress; read back, seek and read1 "
          f"({len(middle)} B) equal: True")

    # (d) the device backend, and --recover.
    dev_bz2 = os.path.join(tmp, "device.bz2")
    rc, err, dev_s = cli_run([path, "--backend", "device", "--size", str(LEVEL), "-o", dev_bz2])
    with open(dev_bz2, "rb") as f:
        if rc != 0 or f.read() != intake_out:
            raise AssertionError(f"--backend device differs from phase 4c's compress_device_intake: {err}")
    zero(*all_counts)
    dev_out = os.path.join(tmp, "device.out")
    rc, err, dev_dec_s = cli_run([dev_bz2, "--backend", "device", "--dec", "-o", dev_out])
    with open(dev_out, "rb") as f:
        if rc != 0 or f.read() != corpus:
            raise AssertionError(f"--backend device --dec did not give the corpus back: {err}")
    dec_launches = {**dec_cuda.LAUNCHES, **mtf_dec_cuda.LAUNCHES, **rle1_dec_cuda.LAUNCHES}
    for name in DECODE_KERNELS:
        if dec_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by --backend device --dec")
    print(f"--backend device: compress {mb / dev_s:.3f} MB/s byte-identical to compress_device_intake; "
          f"--dec {mb / dev_dec_s:.3f} MB/s with the decode kernels launched "
          f"{ {name: dec_launches[name] for name in DECODE_KERNELS} }")
    headers, _ = native.scan_blocks(packed)
    if len(headers) != len(blocks):
        raise AssertionError(f"{len(headers)} block markers in a stream of {len(blocks)} blocks")
    k = 1
    damaged = bytearray(packed)
    damaged[headers[k] // 8 + 1000] ^= 0xFF
    bad_path = os.path.join(tmp, "damaged.bz2")
    with open(bad_path, "wb") as f:
        f.write(damaged)
    rec_path = os.path.join(tmp, "recovered.out")
    rc, err, rec_s = cli_run([bad_path, "--recover", "-o", rec_path])
    start = sum(b.raw_length for b in blocks[:k])
    with open(rec_path, "rb") as f:
        salvaged = f.read()
    report = f"recovered {len(blocks) - 1}/{len(blocks)} blocks"
    if rc != 0 or report not in err or salvaged != corpus[:start] + corpus[start + blocks[k].raw_length :]:
        raise AssertionError(f"--recover did not salvage every block but block {k}: {err}")
    print(f"--recover: {report} ({len(salvaged)} B, every block but the damaged one) in {rec_s:.3f} s")
    print(f"  card: {card}")


def mesh_run(corpus: bytes, mesh, gather: bool = False) -> dict:
    """Phase 6's path on one rank: split the corpus, pad its blocks to a
    batch the mesh divides, encode this rank's rows, and stitch the whole
    stream (ranks meet at a barrier first, so the stitch's time is its
    own). Returns the stream, this rank's bits and seconds by step. With
    ``gather`` (a mesh of one rank), gather_blocks of the encode must give
    the rank's own rows back."""
    import numpy as np
    import torch.distributed as dist

    from bz2tpu_torch.parallel import encode_blocks_sharded, gather_blocks, pad_batch
    from bz2tpu_torch.parallel.stitch import stitch_stream_shard
    from bz2tpu_torch.runtime.compressor import split_blocks

    seconds = {}
    t0 = time.perf_counter()
    blocks = split_blocks(corpus, LEVEL)
    n_rows = pad_batch(len(blocks), mesh.size)
    batch = np.zeros((n_rows, max(b.data.size for b in blocks)), np.uint8)
    ns = np.ones(n_rows, np.int32)  # padding rows: one-byte blocks
    crcs = np.zeros(n_rows, np.int64)
    for i, blk in enumerate(blocks):
        batch[i, : blk.data.size] = blk.data
        ns[i], crcs[i] = blk.data.size, blk.crc
    seconds["split"] = time.perf_counter() - t0
    out, seconds["encode"] = timed(lambda: encode_blocks_sharded(batch, ns, crcs, mesh=mesh))
    if gather:
        gathered, seconds["gather"] = timed(lambda: gather_blocks(out, mesh))
        if gathered.keys() != out.keys() or any(not torch.equal(gathered[k], out[k]) for k in out):
            raise AssertionError("gather_blocks of a one-rank mesh does not give its rows back")
    rows = mesh.rows(n_rows)
    live = max(0, min(rows.stop - rows.start, len(blocks) - rows.start))
    bits = out["total_bits"].clone()
    bits[live:] = 0
    crcs_t = torch.from_numpy(crcs[rows]).to(mesh.device)
    t0 = time.perf_counter()
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
    seconds["wait"] = time.perf_counter() - t0
    steps: dict[str, float] = {}
    (stream, _), seconds["stitch"] = timed(
        lambda: stitch_stream_shard(out["words"], bits, crcs_t, live, LEVEL, mesh=mesh, timings=steps))
    return {"stream": stream, "rows": [rows.start, rows.stop], "live": live,
            "bits": int(bits.sum()), "seconds": seconds, "stitch_steps": steps}


def encode_launches() -> dict:
    from bz2tpu_torch.ops import bwt_cuda, huffman_cuda, mtf_cuda

    return {**bwt_cuda.LAUNCHES, **mtf_cuda.LAUNCHES, **huffman_cuda.LAUNCHES}


def compress_rank(corpus: bytes) -> tuple[dict, bytes]:
    """Phase 6d's path on one rank: bz2tpu_torch.compress itself on the
    per-block path, which takes the block mesh because the group's ranks
    divide its batch. A warm-up, an unclocked run (its launches) and a
    clocked one (its stages, "gather" the all-gather).
    Returns the report and the stream."""
    import bz2tpu_torch
    from bz2tpu_torch.ops import bwt_cuda, huffman_cuda, mtf_cuda
    from bz2tpu_torch.parallel import mesh as mesh_module
    from bz2tpu_torch.runtime import compressor

    compressor._DEVICE_STITCH = False
    received, sharded = [], []
    real_gather, real_encode = mesh_module.all_gather_padded, mesh_module.encode_blocks_sharded

    def gather(t, mesh, shapes=None):
        parts, shapes = real_gather(t, mesh, shapes)
        received.append(sum(p.numel() * p.element_size() for p in parts))
        return parts, shapes

    mesh_module.all_gather_padded = gather
    mesh_module.encode_blocks_sharded = lambda *a, **k: sharded.append(1) or real_encode(*a, **k)
    bz2tpu_torch.compress(corpus, level=LEVEL)  # warm-up: the allocator's pool at the corpus's sizes
    zero(bwt_cuda.LAUNCHES, mtf_cuda.LAUNCHES, huffman_cuda.LAUNCHES)
    received.clear()
    sharded.clear()
    stream, seconds = timed(lambda: bz2tpu_torch.compress(corpus, level=LEVEL))
    report = {"launches": encode_launches(), "compress_s": seconds, "received_bytes": sum(received),
              "sharded_encodes": len(sharded)}
    steps: dict[str, float] = {}
    clocked, report["clocked_s"] = timed(lambda: bz2tpu_torch.compress(corpus, level=LEVEL, timings=steps))
    if clocked != stream:
        raise AssertionError("the clocked compress differs from the unclocked one")
    report["steps"] = steps
    return report, stream


# Phase 6's child modes -> (backend, ranks). The gloo groups share the one
# card (NCCL refuses two ranks on one card); "nccl" is a group of one,
# initialised from env:// as torchrun would set it.
MESH_MODES = {"stitch": ("gloo", MESH_RANKS), "compress": ("gloo", MESH_RANKS), "nccl": ("nccl", 1)}


def mesh_rank(argv: list[str]) -> int:
    """Phase 6's worker: one rank of a group on the card, which reads the
    corpus from DIR and writes its streams and a JSON report (with the
    group's backend) there. MODE "stitch" (6b) runs mesh_run, "compress"
    (6d) compress_rank, "nccl" (6e) mesh_run with gather_blocks (under
    NCCL the small all-gathers of gather_ints hold CUDA tensors) and then
    bz2tpu_torch.compress with the group up.

        python3 chip_smoke.py --mesh-rank R --mesh-port PORT --mesh-dir DIR --mesh-mode MODE
    """
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    import torch.distributed as dist

    import bz2tpu_torch
    from bz2tpu_torch import _build
    from bz2tpu_torch.ops import bwt_cuda, huffman_cuda, mtf_cuda
    from bz2tpu_torch.parallel import block_mesh
    from bz2tpu_torch.parallel.distributed import initialize

    args = dict(zip(argv[::2], argv[1::2]))
    rank, tmp, mode = int(args["--mesh-rank"]), args["--mesh-dir"], args["--mesh-mode"]
    backend, ranks = MESH_MODES[mode]
    t0 = time.perf_counter()
    if ranks == 1:  # initialize(num_processes=1) returns with no group: take the environment's
        torch.cuda.set_device(0)
        initialize(backend=backend, timeout_s=120)
    else:
        initialize(coordinator_address=f"127.0.0.1:{args['--mesh-port']}", num_processes=ranks,
                   process_id=rank, backend=backend, timeout_s=120)
    mesh = block_mesh()
    if (mesh.rank, mesh.size) != (rank, ranks) or mesh.group is None or (
            ranks == 1 and mesh.device != torch.device("cuda", 0)):
        raise AssertionError(f"block_mesh() is {mesh}, not rank {rank} of a group of {ranks}")
    _build.lib()  # phase 1 built it: this loads it
    with open(os.path.join(tmp, "corpus.dat"), "rb") as f:
        corpus = f.read()
    ready_s = time.perf_counter() - t0
    report = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device), "ready_s": ready_s,
              "backend": dist.get_backend()}
    if mode == "compress":
        more, stream = compress_rank(corpus)
        report.update(more)
        streams = {"compress": stream}
    else:
        zero(bwt_cuda.LAUNCHES, mtf_cuda.LAUNCHES, huffman_cuda.LAUNCHES)
        run = mesh_run(corpus, mesh, gather=mode == "nccl")
        streams = {"mesh": run.pop("stream")}
        report.update(launches=encode_launches(), **run)
        if mode == "nccl":
            streams["compress"], report["compress_s"] = timed(lambda: bz2tpu_torch.compress(corpus, level=LEVEL))
    report["streams"] = list(streams)
    report["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    for name, stream in streams.items():
        with open(os.path.join(tmp, f"stream.{mode}.{name}.{rank}"), "wb") as f:
            f.write(stream)
    with open(os.path.join(tmp, f"report.{mode}.{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def start_ranks(tmp: str, mode: str, out: bytes) -> tuple[list[dict], float]:
    """The ranks of ``mode`` (MESH_MODES), each a copy of this script on the
    one card (see mesh_rank), a group of one taking its address from the
    environment; each rank's streams must equal ``out`` and its backend
    the mode's. Returns the ranks' reports and the wall from their start to
    every exit. A rank that fails, or has not finished within
    MESH_TIMEOUT_S, fails the run with its stderr's tail."""
    import socket
    import subprocess

    backend, ranks = MESH_MODES[mode]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    if ranks == 1:
        env.update(WORLD_SIZE="1", RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.cuda.empty_cache()
    logs = [(open(os.path.join(tmp, f"rank{r}.{mode}.out"), "wb"), open(os.path.join(tmp, f"rank{r}.{mode}.err"), "wb"))
            for r in range(ranks)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
                               "--mesh-port", str(port), "--mesh-dir", tmp, "--mesh-mode", mode],
                              stdout=o, stderr=e, env=env)
             for r, (o, e) in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MESH_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        wall = time.perf_counter() - t0
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for o, e in logs:
            o.close()
            e.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in failed:
        with open(os.path.join(tmp, f"rank{r}.{mode}.err"), "rb") as f:
            print(f"rank {r} exited {procs[r].returncode}; its stderr ends:\n"
                  f"{f.read()[-4000:].decode(errors='replace')}", file=sys.stderr)
    if failed:
        raise AssertionError(f"{mode} ranks {failed} failed or did not finish within {MESH_TIMEOUT_S} s")
    reports = []
    for r in range(ranks):
        with open(os.path.join(tmp, f"report.{mode}.{r}.json")) as f:
            reports.append(json.load(f))
        if reports[-1]["backend"] != backend:
            raise AssertionError(f"rank {r} ({mode}) ran on {reports[-1]['backend']}, not {backend}")
        for name in reports[-1]["streams"]:
            with open(os.path.join(tmp, f"stream.{mode}.{name}.{r}"), "rb") as f:
                if f.read() != out:
                    raise AssertionError(f"rank {r}'s {name} stream ({mode}) differs from phase 3's compress stream")
    return reports, wall


def nccl_phase(tmp: str, out: bytes, card: str) -> None:
    """Phase 6e: the mesh's NCCL branch, in a child process so that this
    one never holds a default group. Phase 6b wrote the corpus to tmp."""
    (rep,), wall = start_ranks(tmp, "nccl", out)
    sec = ", ".join(f"{k} {v:.3f} s" for k, v in rep["seconds"].items())
    print(f"6e one-rank NCCL group (backend {rep['backend']}, from env://) in a child process: the mesh's stream "
          f"(encode_blocks_sharded, gather_blocks, stitch_stream_shard, whose gather_ints all-gather CUDA "
          f"tensors under NCCL) and compress's with the group up byte-identical to phase 3's: True")
    print(f"  launches {rep['launches']}; group and library ready {rep['ready_s']:.3f} s; mesh {sec}; "
          f"compress {rep['compress_s']:.3f} s; child wall {wall:.3f} s")
    print(f"  card: {card}")


def batch_launches(blocks, block_rounds, lo: int, hi: int) -> dict:
    """The kernels' launches for an encode of rows lo..hi of the stream's
    blocks: bwt_stage sorts slot_limit(nb) blocks at a time (8 at level 9),
    each group once per round of its slowest block; K3 and D2 once a batch.
    Padding rows (one byte) never add rounds."""
    from bz2tpu_torch.ops import bwt

    hi = min(hi, len(blocks))
    step = bwt.slot_limit(max(b.data.size for b in blocks[lo:hi]).bit_length())
    sorts = sum(max(block_rounds[i : min(i + step, hi)]) for i in range(lo, hi, step))
    return {"bwt_sort": sorts, "bwt_rerank": sorts, "mtf_ranks": 1, "huffman_plan": 1}


def batches_launches(blocks, block_rounds, sizes: list[int], ranks: int = 1, rank: int = 0) -> dict:
    """batch_launches summed over batches of ``sizes`` blocks, each batch's
    rows split over ``ranks`` as the block mesh splits them (no rank may
    hold padding only)."""
    total = {"bwt_sort": 0, "bwt_rerank": 0, "mtf_ranks": 0, "huffman_plan": 0}
    base = 0
    for n in sizes:
        per = -(-n // ranks)
        lo = base + rank * per
        if lo >= base + n:
            raise AssertionError(f"rank {rank} holds only padding rows of the batch at block {base}")
        for k, v in batch_launches(blocks, block_rounds, lo, lo + per).items():
            total[k] += v
        base += n
    return total


def block_mesh_phase(tmp, corpus, out, blocks, block_rounds, all_counts, phase3, card) -> None:
    """Phase 6 (a, b): the block mesh, one rank in this process, then two
    ranks in their own processes on the one card."""
    from bz2tpu_torch.parallel import block_mesh

    mb = len(corpus) / 1e6
    n_blocks = len(blocks)

    # (a) one rank, no process group.
    mesh = block_mesh()
    if (mesh.group, mesh.size, mesh.device) != (None, 1, torch.device("cuda", 0)):
        raise AssertionError(f"block_mesh() without a group is {mesh}, not one rank on cuda:0")
    torch.cuda.reset_peak_memory_stats()
    zero(*all_counts)
    run, one_s = timed(lambda: mesh_run(corpus, mesh))
    peak = torch.cuda.max_memory_allocated()
    launches = encode_launches()
    sec = ", ".join(f"{k} {v:.3f} s" for k, v in run["seconds"].items())
    sec += " (" + ", ".join(f"{k} {v:.4f}" for k, v in run["stitch_steps"].items()) + ")"
    print(f"6a one rank, {run['rows'][1]} rows in one batch: launches {launches}")
    print(f"  mesh compress (1 rank) {mb / one_s:.3f} MB/s ({one_s:.3f} s: {sec}); compress (phase 3) "
          f"{mb / phase3['compress']:.3f} MB/s ({phase3['compress']:.3f} s)")
    print(f"  peak device memory {peak} B ({peak / 2**30:.3f} GiB); compress (phase 3) "
          f"{phase3['compress_peak']} B ({phase3['compress_peak'] / 2**30:.3f} GiB)")
    if run["stream"] != out:
        raise AssertionError("the one-rank mesh's stream differs from phase 3's compress stream")
    print("  stream byte-identical to phase 3's: True")
    want = batch_launches(blocks, block_rounds, 0, run["rows"][1])
    if launches != want:
        raise AssertionError(f"the one-rank mesh launched {launches}, not {want} (one batch of {n_blocks} blocks)")
    del run

    # (b) two ranks on the one card, a gloo group of two processes.
    with open(os.path.join(tmp, "corpus.dat"), "wb") as f:
        f.write(corpus)
    reports, wall = start_ranks(tmp, "stitch", out)
    print(f"6b {MESH_RANKS} ranks on one card (gloo): both ranks' streams byte-identical to phase 3's: True")
    for rep in reports:
        lo, hi = rep["rows"]
        if rep["live"] == 0:
            raise AssertionError(f"rank {rep['rank']} holds only padding rows {lo}-{hi - 1}")
        want = batch_launches(blocks, block_rounds, lo, hi)
        if rep["launches"] != want:
            raise AssertionError(f"rank {rep['rank']} (rows {lo}-{hi}) launched {rep['launches']}, not {want}")
        sec = ", ".join(f"{k} {v:.3f} s" for k, v in rep["seconds"].items())
        sec += " (" + ", ".join(f"{k} {v:.4f}" for k, v in rep["stitch_steps"].items()) + ")"
        print(f"  rank {rep['rank']} on {rep['device']}: rows {lo}-{hi - 1}, launches {rep['launches']}; "
              f"group and library ready {rep['ready_s']:.3f} s; {sec}; peak {rep['peak_bytes']} B")
    total_k1 = sum(rep["launches"]["bwt_sort"] for rep in reports)
    seg_words = [(rep["bits"] + 31) // 32 + 1 for rep in reports]
    print(f"  K1 launches over the ranks {total_k1} (phase 3's compress: {phase3['k1']})")
    if all(hi - lo == phase3["batch"] for lo, hi in (rep["rows"] for rep in reports)) and total_k1 != phase3["k1"]:
        raise AssertionError("the ranks' rows are phase 3's batches, but their K1 launches do not add up to its")
    print(f"  segment all-gather: {MESH_RANKS} x {max(seg_words)} 32-bit words = "
          f"{MESH_RANKS * max(seg_words) * 4} B received per rank; stitch "
          f"{', '.join(format(rep['seconds']['stitch'], '.4f') for rep in reports)} s by rank")
    print(f"  wall {wall:.3f} s from the processes' start to both exits ({mb / wall:.3f} MB/s); "
          f"no scaling figure: the {MESH_RANKS} ranks share one card")
    print(f"  card: {card}")


def per_block_phase(tmp, corpus, out, blocks, block_rounds, all_counts, phase3, card) -> None:
    """Phase 6 (c, d): the per-block path, in this process through compress
    and compress_file, then through compress on two ranks that share the
    card, where it takes the block mesh. Phase 6b wrote the corpus to tmp."""
    import bz2tpu_torch
    from bz2tpu_torch.runtime import compressor, stream

    mb = len(corpus) / 1e6
    path = os.path.join(tmp, "corpus.dat")
    # (c) one process. The batch sizes are recorded on the way to the card.
    sizes: list[int] = []
    real_batch_tensors = compressor._batch_tensors
    compressor._batch_tensors = lambda chunk, device, n_rows=None: (
        sizes.append(len(chunk)) or real_batch_tensors(chunk, device, n_rows))
    compressor._DEVICE_STITCH = False
    runs = {}
    try:
        for name, run in (("compress", lambda: bz2tpu_torch.compress(corpus, level=LEVEL)),
                          ("compress_file", lambda: stream.compress_file(path, path + ".bz2", level=LEVEL))):
            sizes.clear()
            zero(*all_counts)
            got, seconds = timed(run)
            if name == "compress_file":
                with open(path + ".bz2", "rb") as f:
                    got = f.read()
            launches = encode_launches()
            if got != out:
                raise AssertionError(f"the per-block path's {name} differs from phase 3's compress stream")
            want = batches_launches(blocks, block_rounds, sizes)
            if sum(sizes) != len(blocks) or launches != want:
                raise AssertionError(f"the per-block {name} launched {launches} on batches {sizes}, not {want}")
            runs[name] = seconds
            print(f"6c per-block {name}: byte-identical to phase 3's stream: True; batches {sizes}, "
                  f"launches {launches}")
    finally:
        compressor._batch_tensors = real_batch_tensors
        compressor._DEVICE_STITCH = True
    print(f"  per-block compress {mb / runs['compress']:.3f} MB/s ({runs['compress']:.3f} s), "
          f"compress_file {mb / runs['compress_file']:.3f} MB/s ({runs['compress_file']:.3f} s); "
          f"compress (phase 3) {mb / phase3['compress']:.3f} MB/s ({phase3['compress']:.3f} s): "
          f"{phase3['compress'] / runs['compress']:.3f}x and {phase3['compress'] / runs['compress_file']:.3f}x")

    # (d) two ranks, each calling compress with the per-block path on.
    reports, wall = start_ranks(tmp, "compress", out)
    print(f"6d {MESH_RANKS} ranks on one card (gloo), each calling bz2tpu_torch.compress on the per-block "
          f"path: both streams byte-identical to phase 3's: True")
    sizes = [min(phase3["batch"], len(blocks) - b) for b in range(0, len(blocks), phase3["batch"])]
    for rep in reports:
        want = batches_launches(blocks, block_rounds, sizes, rep["size"], rep["rank"])
        if rep["launches"] != want or rep["sharded_encodes"] != len(sizes):
            raise AssertionError(f"rank {rep['rank']} launched {rep['launches']} in {rep['sharded_encodes']} "
                                 f"sharded encodes, not {want} in {len(sizes)}")
        steps = rep["steps"]
        host = rep["clocked_s"] - sum(steps.values())
        print(f"  rank {rep['rank']} on {rep['device']}: launches {rep['launches']} in {rep['sharded_encodes']} "
              f"sharded encodes; compress {mb / rep['compress_s']:.3f} MB/s ({rep['compress_s']:.3f} s); "
              f"clocked {rep['clocked_s']:.3f} s: all-gather {steps['gather']:.4f} s with the wait for the "
              f"other rank ({rep['received_bytes']} B received), copies to the host {steps['fetch']:.4f} s, host split "
              f"+ stitch {host:.3f} s, stages "
              + ", ".join(f"{k} {v:.3f}" for k, v in steps.items() if k not in ("gather", "fetch"))
              + f"; group and library ready {rep['ready_s']:.3f} s; peak {rep['peak_bytes']} B")
    print(f"  wall {wall:.3f} s from the processes' start to both exits (each three 16 MB compresses, the "
          f"first a warm-up); no scaling figure: the {MESH_RANKS} ranks share one card")
    print(f"  card: {card}")


def cold_start(argv: list[str]) -> int:
    """Phase 7's child: import the port with the build cache the parent set
    (empty), then (a, c) load the kernel library or (b) export an artifact,
    then compress the corpus's first 2 MB from DIR; write the stream and a
    JSON report there.

        python3 chip_smoke.py --cold-start MODE --cold-dir DIR
    """
    entered = time.time()  # after the interpreter's start and torch's import
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    args = dict(zip(argv[::2], argv[1::2]))
    mode, tmp = args["--cold-start"], args["--cold-dir"]
    t0 = time.perf_counter()
    import bz2tpu_torch
    from bz2tpu_torch import _build, native
    from bz2tpu_torch.utils import aot

    report = {"entered_at": entered, "import_s": time.perf_counter() - t0, "cc_at_import": native.compiler_runs}
    t0 = time.perf_counter()
    if mode == "export":
        report["libraries"] = aot.export_artifact(os.path.join(tmp, "artifact"), levels=(LEVEL,))
    else:
        _build.lib()
    report["library_s"] = time.perf_counter() - t0
    with open(os.path.join(tmp, "head.dat"), "rb") as f:
        head = f.read()
    stream, report["compress_s"] = timed(lambda: bz2tpu_torch.compress(head, level=LEVEL))
    report.update(stream_at=time.time(), nvcc_runs=_build.compiler_runs, cc_runs=native.compiler_runs,
                  nvcc_s=_build.build_seconds, aot=aot.stats, cache=str(_build.BUILD_DIR))
    with open(os.path.join(tmp, f"cold.{mode}.bz2"), "wb") as f:
        f.write(stream)
    with open(os.path.join(tmp, f"cold.{mode}.json"), "w") as f:
        json.dump(report, f)
    return 0


def cold_start_phase(tmp: str, head: bytes, out_head: bytes, card: str) -> None:
    """Phase 7: a build from nothing, an export, and the exported artifact,
    each in a fresh process with an empty build cache."""
    import subprocess

    with open(os.path.join(tmp, "head.dat"), "wb") as f:
        f.write(head)
    reports = {}
    for mode in ("build", "export", "artifact"):
        env = {k: v for k, v in os.environ.items() if not k.startswith("BZ2TPU_TORCH_")}
        env["BZ2TPU_TORCH_CACHE_DIR"] = os.path.join(tmp, f"cache.{mode}")
        if mode == "artifact":
            env["BZ2TPU_TORCH_AOT_DIR"] = os.path.join(tmp, "artifact")
        t0 = time.time()
        try:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--cold-start", mode,
                                   "--cold-dir", tmp], env=env, capture_output=True, text=True,
                                  timeout=COLD_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise AssertionError(f"phase 7 ({mode}) did not finish within {COLD_TIMEOUT_S} s") from e
        if proc.returncode != 0:
            print(f"phase 7 ({mode}) exited {proc.returncode}; its stderr ends:\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            raise AssertionError(f"phase 7 ({mode}) failed")
        with open(os.path.join(tmp, f"cold.{mode}.json")) as f:
            rep = json.load(f)
        with open(os.path.join(tmp, f"cold.{mode}.bz2"), "rb") as f:
            stream = f.read()
        if stream != out_head or stdlib_bz2.decompress(stream) != head:
            raise AssertionError(f"phase 7 ({mode}): the stream differs from phase 3's or does not decode")
        rep["first_stream_s"] = rep["stream_at"] - t0
        reports[mode] = rep
        print(f"7{'abc'[len(reports) - 1]} {mode}: first {len(head)} B stream {rep['first_stream_s']:.3f} s after "
              f"the process's start (interpreter and torch {rep['entered_at'] - t0:.3f} s, import of the port "
              f"{rep['import_s']:.3f} s, "
              f"{'export' if mode == 'export' else 'kernel library'} {rep['library_s']:.3f} s, first compress "
              f"{rep['compress_s']:.3f} s); compiler runs nvcc {rep['nvcc_runs']} "
              f"({rep['nvcc_s'] if rep['nvcc_s'] is not None else 'none'} s), cc {rep['cc_runs']} "
              f"({rep['cc_at_import']} at import); artifact install {rep['aot']}; stream equal to phase 3's "
              f"and decoded by stdlib bz2: True")
    build, art = reports["build"], reports["artifact"]
    if build["nvcc_runs"] == 0 or build["cc_runs"] == 0:
        raise AssertionError(f"phase 7a ran nvcc {build['nvcc_runs']} and cc {build['cc_runs']} times in an empty cache")
    if reports["export"]["libraries"] != 2:
        raise AssertionError(f"the exported artifact holds {reports['export']['libraries']} libraries, not 2")
    if (art["nvcc_runs"], art["cc_runs"]) != (0, 0) or art["aot"]["installed_files"] != 2:
        raise AssertionError(f"phase 7c ran nvcc {art['nvcc_runs']} and cc {art['cc_runs']} times "
                             f"with the artifact installed ({art['aot']})")
    print(f"  first stream: {build['first_stream_s']:.3f} s building from nothing, {art['first_stream_s']:.3f} s "
          f"with the artifact ({build['first_stream_s'] / art['first_stream_s']:.2f}x)")
    print(f"  card: {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    import numpy as np

    import bz2tpu_torch
    from bz2tpu_torch import _build
    from bz2tpu_torch.format import constants as C
    from bz2tpu_torch.ops import bwt, bwt_cuda, dec_cuda, huffman, huffman_cuda, huffman_dec, mtf, mtf_cuda
    from bz2tpu_torch.ops import crc, crc_cuda, mtf_dec_cuda, rle1, rle1_cuda, rle1_dec_cuda
    from bz2tpu_torch.ops.intake import chunk_capacity
    from bz2tpu_torch.ops.pipeline import encode_batch
    from bz2tpu_torch.runtime import compressor, device_decode
    from bz2tpu_torch.runtime.compressor import DEFAULT_BATCH, HAVE_NATIVE, _batch_tensors, split_blocks
    from bz2tpu_torch.utils.corpus import make_mixed_corpus, real_text_split
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

    corpus = make_mixed_corpus(CORPUS_BYTES)
    from_files, from_markov = real_text_split(CORPUS_BYTES)
    print(f"corpus: {len(corpus)} B, its real-text part {from_files} B from installed files, "
          f"{from_markov} B of Markov fallback")
    # -- 2. kernels against their plain versions at main-path shapes -------
    blocks = split_blocks(corpus, LEVEL)
    batch = blocks[:DEFAULT_BATCH]
    blocks_t, ns, crcs = _batch_tensors(batch, dev)
    ns_host = ns.tolist()
    nb = max(ns_host).bit_length()
    lay = bwt.layout(list(range(len(batch))), ns_host, dev)
    offsets = lay.off.to(torch.int32)
    total = sum(ns_host)
    print(f"kernel shapes: first batch {tuple(blocks_t.shape)}, n={ns_host}, {total} keys a BWT round")

    # The table reports each kernel at its most frequent main-path use: the
    # batch's pair-round sort and re-rank, the MTF ranks of the batch and
    # the code lengths of one refinement iteration.
    stats: dict[str, dict] = {}
    keys0, hi0 = bwt.round0_keys(blocks_t, lay, nb)
    compare("bwt_sort_round0", lambda: bwt_cuda.sort_keys(keys0, nb, hi0),
            lambda: bwt_cuda.sort_keys_ref(keys0, nb, hi0), 10, nbytes=16 * total)
    sorted0 = bwt_cuda.sort_keys_ref(keys0, nb, hi0)
    rank0, _ = bwt_cuda.rerank_ref(sorted0, nb, nb + 24, offsets)
    k0 = torch.tensor([1 if n < 4 else 3 for n in ns_host], device=dev)
    keys1, hi1 = bwt.pair_keys(rank0, k0, lay, nb)
    field1 = (keys1 >> nb) & ((1 << (hi1 - nb)) - 1)
    sorted1 = bwt_cuda.sort_keys_ref(keys1, nb, hi1)
    print(f"pair-round sort: bits [{nb}, {hi1}) of {total} keys")
    stats["bwt_sort"] = compare(
        "bwt_sort", lambda: bwt_cuda.sort_keys(keys1, nb, hi1), lambda: bwt_cuda.sort_keys_ref(keys1, nb, hi1),
        10, nbytes=16 * total, library=lambda: torch.sort(field1, stable=True))
    compare("bwt_rerank_round0", lambda: bwt_cuda.rerank(sorted0, nb, nb + 24, offsets),
            lambda: bwt_cuda.rerank_ref(sorted0, nb, nb + 24, offsets), 10, nbytes=12 * total)
    stats["bwt_rerank"] = compare(
        "bwt_rerank", lambda: bwt_cuda.rerank(sorted1, nb, 3 * nb, offsets),
        lambda: bwt_cuda.rerank_ref(sorted1, nb, 3 * nb, offsets), 10, nbytes=12 * total)
    # What the scatter at the end of the re-rank costs alone: one torch call
    # that writes an int32 to each of the pair round's destinations.
    dest = offsets.long()[sorted1 >> (3 * nb)] + (sorted1 & ((1 << nb) - 1))
    src, scattered = torch.arange(total, dtype=torch.int32, device=dev), torch.empty(total, dtype=torch.int32, device=dev)
    print(f"scatter yardstick: index_copy_ of {total} int32 to bwt_rerank's destinations "
          f"{cuda_ms(lambda: scattered.index_copy_(0, dest, src), 10):.4f} ms")
    del dest, src, scattered
    last, _ = bwt.bwt_stage(blocks_t, ns)
    cseq, _, m, _, n_in_use = mtf.collapse(last, ns)
    print(f"MTF collapsed lengths m={m.tolist()}")
    # Its bytes: the live symbols read, the whole (B, cap) rank array
    # written (zeros at and past m); its operations: one compare and one
    # add per position and list lane in use.
    mtf_bytes = 4 * int(m.sum()) + 4 * cseq.numel() + 8 * m.numel()
    mtf_ops = 2 * int((m.long() * n_in_use.long()).sum())
    stats["mtf_ranks"] = compare(
        "mtf_ranks", lambda: mtf_cuda.mtf_ranks(cseq, n_in_use, m), lambda: mtf_cuda.mtf_ranks_ref(cseq, n_in_use, m),
        3, nbytes=mtf_bytes, ops=mtf_ops)
    compare("mtf_ranks_chunk2048", lambda: mtf_cuda.mtf_ranks(cseq, n_in_use, m, 2048),
            lambda: mtf_cuda.mtf_ranks_ref(cseq, n_in_use, m, 2048), 3, nbytes=mtf_bytes, ops=mtf_ops)
    want_ranks = mtf_cuda.mtf_ranks_ref(cseq, n_in_use, m, 2048)
    sweep = {}
    for chunk in (32, 64, 128, 256, 512, 1024, 2048, 4096):
        if max_abs_err(mtf_cuda.mtf_ranks(cseq, n_in_use, m, chunk), want_ranks) != 0:
            raise AssertionError(f"mtf_ranks at chunk {chunk} disagrees with its plain version")
        sweep[chunk] = round(cuda_ms(lambda: mtf_cuda.mtf_ranks(cseq, n_in_use, m, chunk), 10), 4)
    print(f"mtf_ranks by chunk length (ms, default {mtf_cuda.CHUNK}): {sweep}")
    del want_ranks
    # D2 on the batch's Huffman planning, with the inputs the main path
    # hands it (captured from one encode of the batch).
    calls = []
    real_plan = huffman.huffman_plan
    huffman.huffman_plan = lambda *a: calls.append(a) or real_plan(*a)
    try:
        encode_batch(blocks_t, ns, crcs)
    finally:
        huffman.huffman_plan = real_plan
    sym, n_sym, n_in_use, seed, maxsel = calls[0]
    print(f"huffman_plan inputs: symbols {tuple(sym.shape)}, n_sym {n_sym.tolist()}, maxsel {maxsel}")
    # Its bytes: the live symbols and the seed read, selectors, their MTF
    # ranks, lengths and iteration counts written; its operations: one
    # packed add per symbol and iteration, and each table refit's
    # alpha^2 leaf-rank compares.
    n_iters = huffman_cuda.huffman_plan(*calls[0])[3].long()  # held against the plain version below
    print(f"refinement iterations by block: {n_iters.tolist()}")
    B = sym.shape[0]
    plan_bytes = (4 * int(n_sym.sum()) + 4 * seed.numel() + 8 * B  # symbols, seed, n_sym, n_in_use
                  + 8 * B * maxsel + 4 * seed.numel() + 4 * B)  # selectors + ranks, lengths, iterations
    plan_ops = int((n_iters * n_sym.long()).sum()) + int((n_iters * 6 * (n_in_use.long() + 2) ** 2).sum())
    stats["huffman_plan"] = compare(
        "huffman_plan", lambda: huffman_cuda.huffman_plan(*calls[0]),
        lambda: huffman_cuda.huffman_plan_ref(*calls[0]), 3, nbytes=plan_bytes, ops=plan_ops)
    del calls, sym, seed
    del keys0, sorted0, rank0, keys1, field1, sorted1, last, cseq

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

    # K1's expected launches: each batch sorts once per doubling round, as
    # often as its slowest block needs alone; the per-block driver sorted
    # once per block and round.
    def sort_rounds(block) -> int:
        """K1 launches of one block's BWT alone: its doubling rounds."""
        bwt_cuda.LAUNCHES["bwt_sort"] = 0
        bwt.bwt_stage(*_batch_tensors([block], dev)[:2])
        return bwt_cuda.LAUNCHES["bwt_sort"]

    rounds = [[sort_rounds(b) for b in blocks[i : i + DEFAULT_BATCH]]
              for i in range(0, len(blocks), DEFAULT_BATCH)]
    want_sorts = sum(max(r) for r in rounds)
    print(f"doubling rounds per block, by batch: {rounds}; batched sorts {want_sorts}, "
          f"per-block sorts {sum(map(sum, rounds))}")

    all_counts = (bwt_cuda.LAUNCHES, mtf_cuda.LAUNCHES, huffman_cuda.LAUNCHES, dec_cuda.LAUNCHES,
                  mtf_dec_cuda.LAUNCHES, crc_cuda.LAUNCHES, rle1_cuda.LAUNCHES, rle1_dec_cuda.LAUNCHES)
    encode_kernels = ("bwt_sort", "bwt_rerank", "mtf_ranks", "huffman_plan")
    n_batches = -(-len(blocks) // DEFAULT_BATCH)
    torch.cuda.reset_peak_memory_stats()
    zero(*all_counts)
    out, port_s = timed(lambda: bz2tpu_torch.compress(corpus, level=LEVEL))
    compress_peak = torch.cuda.max_memory_allocated()
    launches = {**bwt_cuda.LAUNCHES, **mtf_cuda.LAUNCHES, **huffman_cuda.LAUNCHES}
    print(f"main-path kernel launches: {launches}")
    for name in encode_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if not launches["bwt_sort"] == launches["bwt_rerank"] == want_sorts < sum(map(sum, rounds)):
        raise AssertionError(f"K1/K2 launched {launches['bwt_sort']}/{launches['bwt_rerank']} times, "
                             f"not once per round of each batch ({want_sorts})")
    if launches["huffman_plan"] != n_batches:
        raise AssertionError(f"D2 launched {launches['huffman_plan']} times, not once per batch ({n_batches})")


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
    print(f"  port / stdlib: {stock_s / port_s:.2f}x")
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
    # Its bytes: per group, the selector read, the one jump-map entry the
    # chain visits and the start written.
    stats["dec_chain"] = compare("dec_chain", lambda: dec_cuda.group_starts(jump50, tbl, n_groups),
                                 lambda: dec_cuda.group_starts_ref(jump50, tbl, n_groups), 3,
                                 nbytes=12 * int(n_groups.sum()) + 4 * n_groups.numel())
    longest = int(n_groups.max())
    _, misses = dec_cuda.group_starts(jump50, tbl, n_groups, with_misses=True)
    print(f"dec_chain: {stats['dec_chain']['ms'] * 1e6 / longest:.1f} ns per group of the longest chain "
          f"({longest} groups), direct reads {misses.tolist()}")
    del jump50
    # dec_symbols and mtf_dec on the inputs a decode of the stream's batch
    # with the most symbols hands them.
    captured = decode_kernel_inputs(out, dev)
    args3 = captured["dec_symbols"]
    words3, offs, tbl3, lut3, lut_idx, base, perm = args3
    syms_w, lens_w = dec_cuda.decode_groups_ref(*args3)
    # dec_symbols' bytes: the group starts and tables read, the window
    # words and LUT entries its symbols reach (each once), the symbols and
    # lengths written; its operations: some 8 integer operations a symbol.
    n3 = syms_w.numel()
    lens3 = lens_w.view(*offs.shape, -1).long()
    pos = offs[:, :, None] + lens3.cumsum(2) - lens3
    v23 = dec_cuda.window23(words3, pos)
    rows3 = lut_idx.long().gather(1, tbl3.long())[:, :, None]
    lut_at = (rows3 << dec_cuda.LUT_BITS) + (v23 >> 3)
    n_words = torch.unique((pos >> 3).clamp(0, words3.numel() - 1)).numel()
    d3_bytes = (8 * n_words + torch.unique(lut_at).numel() + 12 * offs.numel()
                + 4 * (lut_idx.numel() + base.numel() + perm.numel()) + 8 * n3)
    # Its first pass against its plain version, and the symbols whose
    # bucket holds several lengths, so the step reads the 1 MiB LUT row.
    first_ref = dec_cuda.first_level_tables_ref(lut3)
    first_err = max_abs_err(dec_cuda.first_level_tables(lut3), first_ref)
    if first_err != 0:
        raise AssertionError(f"dec_symbols' first-level tables disagree with their plain version ({first_err})")
    first_bits = dec_cuda.FIRST_BITS
    marked = first_ref.view(-1)[(rows3 << first_bits) + (v23 >> (23 - first_bits))] == 0
    n_marked = int(marked.sum())
    print(f"dec_symbols shapes: groups {tuple(offs.shape)}, tables {tuple(base.shape[:2])}, LUT rows "
          f"{lut3.shape[0]}; {n3} symbols, {n_words} window words and {torch.unique(lut_at).numel()} LUT "
          f"entries reached, {int((syms_w == -2).sum())} symbols -2; first-level tables of 2^{first_bits} "
          f"buckets exact (tolerance 0), {int((first_ref == 0).sum())} of {first_ref.numel()} buckets marked, "
          f"{n_marked} symbols ({n_marked / n3:.6f}) read the 1 MiB row")
    stats["dec_symbols"] = compare("dec_symbols", lambda: dec_cuda.decode_groups(*args3),
                                   lambda: dec_cuda.decode_groups_ref(*args3), 3, nbytes=d3_bytes, ops=8 * n3,
                                   device=True)
    del syms_w, lens_w, lens3, pos, v23, rows3, lut_at, marked, first_ref, args3, words3, offs, tbl3, lut3
    del lut_idx, base, perm
    (js,) = captured.pop("mtf_dec")
    # mtf_dec's bytes: the move indices read, the permutations (256 B a
    # chunk) and emits (128 B a chunk) written; its operations: each move
    # shifts j + 1 list entries.
    chunk = mtf_dec_cuda.CHUNK
    steps = torch.arange(1, chunk + 1, device=dev)
    walked = torch.where(js.view(-1, chunk) > 0, steps, 0).amax(1)  # steps up to the last nonzero index
    pair = mtf_dec_cuda.WARP_CHUNKS
    padded = torch.cat([walked, walked.new_zeros(-walked.numel() % pair)])
    warp_steps = int(((padded.view(-1, pair).amax(1) + 3) // 4 * 4).sum()) * pair  # in groups of four steps
    print(f"mtf_dec shapes: move indices {tuple(js.shape)} ({js.shape[1] // chunk} chunks a block), "
          f"literals {int((js > 0).sum())}; trailing padding {1 - int(walked.sum()) / js.numel():.4f} of the "
          f"steps, {1 - warp_steps / js.numel():.4f} skipped by the kernel (a warp walks to the last nonzero "
          f"index of its {pair} chunks)")
    stats["mtf_dec"] = compare("mtf_dec", lambda: mtf_dec_cuda.chunk_perms(js),
                               lambda: mtf_dec_cuda.chunk_perms_ref(js), 3, nbytes=4 * js.numel(),
                               ops=int(js.long().sum()) + js.numel(), device=True)
    del js, captured, bt, words, tbl, n_groups, walked, padded
    # rle1_dec on 8 rows of 900 kB of enwik, as the level-9 decode hands them.
    stats["rle1_dec"] = rle1_dec_phase(dev)
    # crc_ranges and block_cuts at the shapes of the intake's first chunk
    # of the corpus: its window, its pieces' sums and its blocks' ranges.
    corpus_arr = np.frombuffer(corpus, np.uint8)
    ik = intake_kernel_inputs(corpus, dev)
    chunk, take, padded, cap, cut_args = ik["chunk"], ik["take"], ik["padded"], ik["cap"], ik["cut_args"]
    chunk_n = chunk.shape[0]
    _, raw_cuts, n_cut = ik["cuts"]
    starts_raw = ik["starts"]
    n_entries, n_pieces = cut_args[0].shape[0], int(cut_args[2])
    live = int(n_cut)
    print(f"intake kernel shapes: chunk {chunk_n} B ({take} of the corpus), {n_pieces} pieces of "
          f"{n_entries} entries, {live} blocks, raw cuts {raw_cuts.tolist()}")
    # block_cuts' bytes: what the function needs, a binary search of
    # ceil(log2 n_pieces) + 1 entries and the two sums at the cut for each
    # live block, n_pieces read, the cuts and n_blocks written; a compare
    # an entry searched. What bounds it is latency: every cut is searched
    # at once (a cut overshoots its target by at most 4 bytes, so where
    # each can land is known ahead), so the least chain of dependent loads
    # is one search's, at most 256 entries a step in flight for a warp
    # (ceil(log256 N) loads), then the window of sums it found, each at
    # L2's latency (tools/load_latency.py).
    probes = (n_pieces - 1).bit_length() + 1
    stats["block_cuts"] = compare(
        "block_cuts", lambda: rle1_cuda.block_cuts(*cut_args, cap=cap, max_blocks=DEFAULT_BATCH),
        lambda: rle1.block_cuts_ref(*cut_args, cap=cap, max_blocks=DEFAULT_BATCH), 20,
        nbytes=live * (4 * probes + 8) + 4 + 4 * (2 * DEFAULT_BATCH + 1), ops=live * probes, device=True)
    slow = int(rle1_cuda.block_cuts(*cut_args, cap=cap, max_blocks=DEFAULT_BATCH, with_slow=True)[3])
    spec = importlib.util.spec_from_file_location("load_latency", ROOT / "tools" / "load_latency.py")
    load_latency = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(load_latency)
    l2_ns = load_latency.dependent_load_ns(load_latency.WARM_BYTES, warm=True)
    chain = search_steps(n_entries) + 1
    print(f"block_cuts latency bound: {chain} dependent loads (ceil(log256 {n_entries}) search steps and one "
          f"window) x {l2_ns:.1f} ns (L2, a pointer chase) = {chain * l2_ns * 1e-6:.6f} ms; device "
          f"{stats['block_cuts']['device_ms']:.4f} ms; cuts that searched past their window: {slow} of {live}")
    if slow:
        raise AssertionError(f"block_cuts took the slow path for {slow} cuts of the corpus's first chunk")
    # Sums the windows do not hold (steps above 5, duplicates): the slow
    # path on the card against the plain version.
    syn = slow_path_sums(dev)
    syn_live = int(rle1.block_cuts_ref(*syn, cap=cap, max_blocks=DEFAULT_BATCH)[2])
    syn_probes = (int(syn[2]) - 1).bit_length() + 1
    compare("block_cuts_slow_path", lambda: rle1_cuda.block_cuts(*syn, cap=cap, max_blocks=DEFAULT_BATCH),
            lambda: rle1.block_cuts_ref(*syn, cap=cap, max_blocks=DEFAULT_BATCH), 20,
            nbytes=syn_live * (4 * syn_probes + 8) + 4 + 4 * (2 * DEFAULT_BATCH + 1), ops=syn_live * syn_probes,
            device=True)
    syn_slow = int(rle1_cuda.block_cuts(*syn, cap=cap, max_blocks=DEFAULT_BATCH, with_slow=True)[3])
    print(f"block_cuts on {syn[0].shape[0]} synthetic sums (steps 0, 1 and 6-5,000): {syn_slow} of {syn_live} "
          f"live cuts searched past their window")
    if syn_slow == 0:
        raise AssertionError("the synthetic sums did not drive block_cuts' slow path")
    del syn
    # crc_ranges' bytes: the bytes its ranges cover, read once, the ranges
    # read and the CRCs written; its operations some 5 a byte.
    covered = int(raw_cuts.max())
    stats["crc_ranges"] = compare(
        "crc_ranges", lambda: crc_cuda.crc_ranges(chunk, starts_raw, raw_cuts),
        lambda: crc.crc32_ranges_ref(chunk, starts_raw, raw_cuts), 10,
        nbytes=covered + 16 * DEFAULT_BATCH, ops=5 * covered, device=True)
    # The blocks before the chunk's last are the host splitter's too.
    want_crcs = [b.crc for b in blocks[: live - 1]]
    if crc_cuda.crc_ranges(chunk, starts_raw, raw_cuts)[: live - 1].tolist() != want_crcs:
        raise AssertionError("crc_ranges disagrees with the host splitter's block CRCs on the first chunk")
    _, split_s = timed(lambda: split_blocks(corpus_arr[:take], LEVEL))
    print(f"  yardstick, not a library call: the host C splitter (RLE1, cuts and block CRCs in C) over the same "
          f"{take} B: {split_s * 1e3:.4f} ms")
    # 16 ranges on the chunk, four of them empty, overlapping and unordered.
    rng = np.random.default_rng(12)
    a, b = rng.integers(0, chunk_n + 1, 16), rng.integers(0, chunk_n + 1, 16)
    s16, e16 = np.minimum(a, b), np.maximum(a, b)
    s16[:4] = e16[:4] = [0, chunk_n, chunk_n // 2, 12345]
    s16_t, e16_t = torch.from_numpy(s16).to(dev), torch.from_numpy(e16).to(dev)
    compare("crc_ranges_b16", lambda: crc_cuda.crc_ranges(chunk, s16_t, e16_t),
            lambda: crc.crc32_ranges_ref(chunk, s16_t, e16_t), 10, nbytes=chunk_n + 24 * 16, ops=5 * chunk_n,
            device=True)
    # A widened window, 32 MiB (the corpus, then zeros), cut into 8
    # ranges that cover it.
    wide = torch.zeros(4 * chunk_n, dtype=torch.uint8, device=dev)
    wide[: len(corpus)] = torch.frombuffer(bytearray(corpus), dtype=torch.uint8).to(dev)
    wcuts = torch.arange(1, DEFAULT_BATCH + 1, device=dev) * wide.shape[0] // DEFAULT_BATCH
    wstarts = wcuts - wide.shape[0] // DEFAULT_BATCH
    compare("crc_ranges_32MiB", lambda: crc_cuda.crc_ranges(wide, wstarts, wcuts),
            lambda: crc.crc32_ranges_ref(wide, wstarts, wcuts), 10, nbytes=wide.shape[0] + 16 * DEFAULT_BATCH,
            ops=5 * wide.shape[0], device=True)
    del chunk, ik, cut_args, wide
    # Every batch of both 16 MB streams: the share of the steps that read
    # the map directly (their window missed), and the kernel's time on the
    # batch where that share is largest.
    worst = (-1.0, "", 0, 0.0)
    for name, stream in (("port", out), ("stdlib", stock)):
        parsed, _ = device_decode.parse_blocks(stream)
        words = device_decode.stream_words(stream, dev)
        shares = []
        for k, (nbc, group) in enumerate(device_decode.batches(parsed)):
            bt = device_decode.batch_tensors([parsed[i] for i in group], dev)
            jump50 = huffman_dec.jump50_maps(words, bt["start_bit"], bt["lut"], bt["lut_idx"], nbc)
            args = (jump50, bt["selectors"], bt["n_groups"])
            share = int(dec_cuda.group_starts(*args, with_misses=True)[1].sum()) / int(bt["n_groups"].sum())
            shares.append(round(share, 4))
            if share > worst[0]:
                worst = (share, name, k, cuda_ms(lambda: dec_cuda.group_starts(*args), 5) * 1e6 / int(args[2].max()))
            del bt, jump50, args
        print(f"dec_chain direct-read share by batch of {name}'s stream: {shares}")
        del words
    print(f"dec_chain on the batch with the largest direct-read share ({worst[1]}'s batch {worst[2]}, "
          f"{worst[0]:.4f}): {worst[3]:.1f} ns per group of its longest chain")

    # (b) decode on the card: the port's stream and stdlib's, no host fallback.
    device_decode.decompress_device(stdlib_bz2.compress(head, LEVEL))  # warm-up
    torch.cuda.reset_peak_memory_stats()

    def decode_launches() -> dict:
        got = {**dec_cuda.LAUNCHES, **mtf_dec_cuda.LAUNCHES, **rle1_dec_cuda.LAUNCHES}
        return {name: got[name] for name in DECODE_KERNELS}

    zero(*all_counts)
    dec_port, dec_port_s = timed(lambda: device_decode._decompress_device_inner(out, True, dev))
    dec_launches = decode_launches()
    zero(*all_counts)
    dec_stock, dec_stock_s = timed(lambda: device_decode._decompress_device_inner(stock, True, dev))
    stock_launches = decode_launches()
    decode_peak = torch.cuda.max_memory_allocated()
    print(f"decode-path kernel launches: port's stream {dec_launches}, stdlib's stream {stock_launches}")
    for name in DECODE_KERNELS:
        if dec_launches[name] <= 0 or stock_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the device decode of both 16 MB streams")
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
    dec_split: dict[str, float] = {}
    clocked_dec, clocked_dec_s = timed(
        lambda: device_decode._decompress_device_inner(out, True, dev, dec_timings, dec_split))
    if clocked_dec != corpus:
        raise AssertionError("the clocked device decode differs from the input")
    stages = ", ".join(f"{k} {v:.4f} s" for k, v in dec_timings.items())
    steps = ", ".join(f"{k} {v:.4f} s" for k, v in dec_split.items())
    print(f"  clocked decode of the port's stream {clocked_dec_s:.3f} s, per stage (synchronised): {stages}")
    print(f"  steps of huffman and mtf (synchronised): {steps}")
    trace = device_profile(lambda: device_decode._decompress_device_inner(out, True, dev))
    if trace["result"] != corpus:
        raise AssertionError("the traced device decode differs from the input")
    print(f"  traced decode of the port's stream (torch.profiler, device activity): wall {trace['wall_s']:.4f} s "
          f"profiled, {dec_port_s:.4f} s unprofiled; {trace['device_events']} device events "
          f"({trace['kernel_events']} kernels); device busy {trace['busy_s']:.4f} s: "
          f"{trace['busy_s'] / trace['wall_s']:.4f} of the profiled wall, {trace['busy_s'] / dec_port_s:.4f} "
          f"of the unprofiled one")
    print("  top device ops: " + "; ".join(f"{t['name']} {t['s'] * 1e3:.3f} ms over {t['launches']}"
                                         for t in trace["top"]))

    # (c) compress with the intake on the card. Each device_intake call
    # (one chunk window tried) is recorded on the way.
    windows: list[tuple[int, int]] = []
    real_intake = compressor.device_intake
    compressor.device_intake = lambda chunk, length, **kw: (
        windows.append((chunk.shape[0], length)) or real_intake(chunk, length, **kw))

    def intake_launches() -> dict:
        got = {**bwt_cuda.LAUNCHES, **mtf_cuda.LAUNCHES, **huffman_cuda.LAUNCHES, **crc_cuda.LAUNCHES,
               **rle1_cuda.LAUNCHES}
        for name in encode_kernels:
            if got[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the device-intake path")
        if not got["crc_ranges"] == got["block_cuts"] == len(windows):
            raise AssertionError(f"crc_ranges/block_cuts launched {got['crc_ranges']}/{got['block_cuts']} times, "
                                 f"not once per device_intake call ({len(windows)})")
        return got

    try:
        t0 = time.perf_counter()
        intake_head = bz2tpu_torch.compress_device_intake(head, level=LEVEL)  # also the warm-up
        print(f"warm-up compress_device_intake of {len(head)} B: {time.perf_counter() - t0:.3f} s")
        if intake_head != bz2tpu_torch.compress_device_intake(head, level=LEVEL, device="cpu"):
            raise AssertionError("compress_device_intake on the card differs from the CPU path on 2 MB")
        print("compress_device_intake: first 2 MB byte-identical to the CPU path: True")
        torch.cuda.reset_peak_memory_stats()
        zero(*all_counts)
        windows.clear()
        intake_out, intake_s = timed(lambda: bz2tpu_torch.compress_device_intake(corpus, level=LEVEL))
        intake_peak = torch.cuda.max_memory_allocated()
        intake_counts = intake_launches()
        print(f"intake-path kernel launches: {intake_counts}; device_intake calls (window, bytes): {windows}")
        if stdlib_bz2.decompress(intake_out) != corpus:
            raise AssertionError("stdlib bz2 does not decode the device-intake stream to the input")
        print(f"  compress_device_intake {mb / intake_s:.3f} MB/s ({intake_s:.3f} s) ratio "
              f"{len(intake_out) / len(corpus):.6f}; compress (phase 3) {mb / port_s:.3f} MB/s ({port_s:.3f} s); "
              f"stdlib {mb / stock_s:.3f} MB/s (phase 3)")
        print(f"  peak device memory of the intake compress: {intake_peak} B")
        # The steps of the first chunk's intake, its host ops and device
        # events, and one trace of a warm intake compress.
        chunk = torch.from_numpy(padded).to(dev)  # phase 4a's: the first chunk
        split = intake_split(chunk, take, LEVEL, DEFAULT_BATCH)
        one = lambda: real_intake(chunk, take, level=LEVEL, max_blocks=DEFAULT_BATCH)  # noqa: E731
        ops = host_op_count(one)
        chunk_trace = device_profile(one)
        print(f"  first chunk's intake ({take} B), steps (lapped inside device_intake, median of 5): "
              + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in split.items())
              + f"; {ops} host-issued aten ops, {chunk_trace['device_events']} device events "
              f"({chunk_trace['kernel_events']} kernels)")
        windows.clear()
        trace = device_profile(lambda: bz2tpu_torch.compress_device_intake(corpus, level=LEVEL), top=None)
        if trace["result"] != intake_out:
            raise AssertionError("the traced intake compress differs from the unclocked one")
        print(f"  traced intake compress (torch.profiler, device activity): wall {trace['wall_s']:.4f} s profiled, "
              f"{intake_s:.4f} s unprofiled; {trace['device_events']} device events ({trace['kernel_events']} "
              f"kernels); device busy {trace['busy_s']:.4f} s: {trace['busy_s'] / trace['wall_s']:.4f} of the "
              f"profiled wall, {trace['busy_s'] / intake_s:.4f} of the unprofiled one")
        print("  top device ops: " + "; ".join(f"{t['name']} {t['s'] * 1e3:.3f} ms over {t['launches']}"
                                             for t in trace["top"][:12]))
        # The intake kernels' own device time (their wrappers' "ms" above
        # holds the host's issue of each call too).
        print("  intake kernels on the device: " + "; ".join(
            f"{t['name']} {t['s'] * 1e3:.4f} ms over {t['launches']}" for t in trace["top"]
            if any(k in t["name"] for k in INTAKE_KERNELS)))
        del chunk
        # An escalating input: zeros RLE1 each window into one under-full
        # block, so the window widens from 8 to 16 to 32 MiB.
        zeros = bytes(ZEROS_BYTES)
        zero(*all_counts)
        windows.clear()
        zeros_out, zeros_s = timed(lambda: bz2tpu_torch.compress_device_intake(zeros, level=LEVEL))
        zeros_counts, zeros_windows = intake_launches(), list(windows)
        if [w for w, _ in zeros_windows] != [chunk_n, 2 * chunk_n, 4 * chunk_n]:
            raise AssertionError(f"the zeros' windows were {zeros_windows}, not 8, 16 and 32 MiB")
        if stdlib_bz2.decompress(zeros_out) != zeros:
            raise AssertionError("stdlib bz2 does not decode the escalating input's stream")
        zeros_cpu, zeros_cpu_s = timed(lambda: bz2tpu_torch.compress_device_intake(zeros, level=LEVEL, device="cpu"))
        if zeros_cpu != zeros_out:
            raise AssertionError("compress_device_intake of the escalating input differs from the CPU path's")
        print(f"  escalating input, {len(zeros)} zero bytes: windows (window, bytes) {zeros_windows}, launches "
              f"{ {k: zeros_counts[k] for k in INTAKE_KERNELS} }; byte-identical to the CPU path "
              f"({zeros_cpu_s:.3f} s) and decoded by stdlib bz2: True; {len(zeros) / 1e6 / zeros_s:.3f} MB/s "
              f"({zeros_s:.3f} s)")
    finally:
        compressor.device_intake = real_intake
    print(f"  card: {card}")
    launches.update(dec_launches)
    launches.update({k: intake_counts[k] for k in INTAKE_KERNELS})

    # -- 5. files and streams on the card -------------------------------------
    block_rounds = [r for batch_rounds in rounds for r in batch_rounds]
    with tempfile.TemporaryDirectory() as tmp:
        files_and_streams(tmp, corpus, out, intake_out, blocks, block_rounds, all_counts,
                          {"compress": port_s, "decompress": host_s, "compress_peak": compress_peak}, card)

    # -- 6. the block mesh, and the per-block path that drives it --------------
    with tempfile.TemporaryDirectory() as tmp:
        phase6 = {"compress": port_s, "compress_peak": compress_peak, "k1": launches["bwt_sort"],
                  "batch": DEFAULT_BATCH}
        block_mesh_phase(tmp, corpus, out, blocks, block_rounds, all_counts, phase6, card)
        per_block_phase(tmp, corpus, out, blocks, block_rounds, all_counts, phase6, card)
        nccl_phase(tmp, out, card)

    # -- 7. cold start: fresh processes, empty build caches ----------------------
    with tempfile.TemporaryDirectory() as tmp:
        cold_start_phase(tmp, head, out_head, card)

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
    if "--mesh-rank" in sys.argv:
        sys.exit(mesh_rank(sys.argv[1:]))
    sys.exit(cold_start(sys.argv[1:]) if "--cold-start" in sys.argv else main())
