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
  4. the fully-device path on the same corpus at level 9: (a) the dec_chain
     kernel against its plain loop at the shapes of the stream's batch
     with the most Huffman groups (exact), its ns per group of the longest
     chain, and on every batch of the port's and stdlib's 16 MB streams
     the share of steps whose window missed (tools/time_dec_chain.py times
     the kernel of two checkouts on those batches);
     (b) decompress_device of phase 3's stream and of stdlib's, each equal to the corpus and
     decoded on the card with no host fallback, timed against the host C
     decoder and stdlib bz2; (c) compress_device_intake of the corpus,
     decoded by stdlib bz2, byte-identical to the CPU path on its first
     2 MB, MB/s against stdlib, with every encode kernel launched;
     then the peak device memory;
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
     dec_chain launched, and --recover on a copy with one block's bytes
     flipped salvaging every other block.
Each phase's main path runs with every launch count set to 0 just before
it, and fails if a kernel of that path was not launched.
The script imports nothing of JAX or of the JAX package. The line before
the last is the kernel table as JSON: per kernel its launches on the 16 MB
compress (dec_chain: on the decode of the port's stream), its time and
its plain version's at the shapes above, the library call's where one
computes the same function, and its bound: the bytes it must move (inputs
read once, outputs written once) over 3.35 TB/s, or its operations over
67 T/s where those take longer. The last line is {"ok": true, "device":
{...}}. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import bz2 as stdlib_bz2
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import torch

LEVEL = 9
CORPUS_BYTES = 16_000_000
CHECK_BYTES = 2_000_000
WRITE_BYTES, CHECKPOINT_CUT = 1_000_000, 9_000_000  # phase 5b: write size, where the compressor drops


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


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
CORE_OPS_PER_S = 67e12  # H100 SXM outside the tensor cores (float32 rate)


def compare(name, fn, ref, reps, *, nbytes: int, ops: int = 0, library=None) -> dict:
    """Kernel call fn() against its plain version ref() on the same inputs:
    exact agreement, then both timed, with the library call where there is
    one, and the kernel's bound from the bytes and operations given."""
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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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


# name -> (source, the TPU kernel it replaces). dec_chain and
# huffman_plan replace no pl.pallas_call: they are the device loops of
# the Huffman group chain (lax.fori_loop) and of the Huffman refinement
# (lax.while_loop around the code-length tree scan).
KERNELS = {
    "bwt_sort": ("bz2tpu_torch/csrc/bwt_sort.cu", "bz2tpu/ops/bwt_pallas.py:118"),
    "bwt_rerank": ("bz2tpu_torch/csrc/bwt_rerank.cu", "bz2tpu/ops/bwt_pallas.py:243"),
    "mtf_ranks": ("bz2tpu_torch/csrc/mtf_ranks.cu", "bz2tpu/ops/mtf_pallas.py:72"),
    "huffman_plan": ("bz2tpu_torch/csrc/huffman_plan.cu", "bz2tpu/ops/huffman.py:278"),
    "dec_chain": ("bz2tpu_torch/csrc/dec_chain.cu", "bz2tpu/ops/huffman_dec.py:237"),
}



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
    from bz2tpu_torch.ops import bwt_cuda, dec_cuda, huffman_cuda, mtf_cuda
    from bz2tpu_torch.runtime import stream

    mb = len(corpus) / 1e6
    path = os.path.join(tmp, "corpus.dat")
    with open(path, "wb") as f:
        f.write(corpus)
    # (a) the default path: compress_file through StreamCompressor. The
    # batch sizes the stream forms are recorded on the way to the card.
    sizes: list[int] = []
    real_batch_tensors = stream._batch_tensors
    stream._batch_tensors = lambda chunk, device: sizes.append(len(chunk)) or real_batch_tensors(chunk, device)
    torch.cuda.reset_peak_memory_stats()
    zero(*all_counts)
    try:
        rc, err, file_s = cli_run([path, "--size", str(LEVEL), "--metrics"])
    finally:
        stream._batch_tensors = real_batch_tensors
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
    if dec_cuda.LAUNCHES["dec_chain"] <= 0:
        raise AssertionError("kernel dec_chain was not launched by --backend device --dec")
    print(f"--backend device: compress {mb / dev_s:.3f} MB/s byte-identical to compress_device_intake; "
          f"--dec {mb / dev_dec_s:.3f} MB/s with dec_chain launched {dec_cuda.LAUNCHES['dec_chain']} times")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    import numpy as np

    import bz2tpu_torch
    from bz2tpu_torch import _build
    from bz2tpu_torch.ops import bwt, bwt_cuda, dec_cuda, huffman, huffman_cuda, huffman_dec, mtf, mtf_cuda
    from bz2tpu_torch.ops.pipeline import encode_batch
    from bz2tpu_torch.runtime import device_decode
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

    all_counts = (bwt_cuda.LAUNCHES, mtf_cuda.LAUNCHES, huffman_cuda.LAUNCHES, dec_cuda.LAUNCHES)
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
    del bt, words, jump50, tbl, n_groups
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
    zero(*all_counts)
    dec_port, dec_port_s = timed(lambda: device_decode._decompress_device_inner(out, True, dev))
    dec_launches = dec_cuda.LAUNCHES["dec_chain"]
    print(f"decode-path kernel launches (port's stream): {dict(dec_cuda.LAUNCHES)}")
    if dec_launches <= 0:
        raise AssertionError("kernel dec_chain was not launched on the device decode path")
    dec_stock, dec_stock_s = timed(lambda: device_decode._decompress_device_inner(stock, True, dev))
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
    intake_launches = {**bwt_cuda.LAUNCHES, **mtf_cuda.LAUNCHES, **huffman_cuda.LAUNCHES}
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

    # -- 5. files and streams on the card -------------------------------------
    block_rounds = [r for batch_rounds in rounds for r in batch_rounds]
    with tempfile.TemporaryDirectory() as tmp:
        files_and_streams(tmp, corpus, out, intake_out, blocks, block_rounds, all_counts,
                          {"compress": port_s, "decompress": host_s, "compress_peak": compress_peak}, card)

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
