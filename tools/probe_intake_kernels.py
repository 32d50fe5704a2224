"""Variants of the device intake's kernels crc_ranges (D5) and block_cuts
(D6) timed on the card, on the arguments the intake's first 8 MiB chunk of
the 16 MB corpus hands them.

    python3 tools/probe_intake_kernels.py [--reps N] [--out FILE]

It builds the 16 MB mixed corpus (bz2tpu_torch.utils.corpus) and takes
the intake's first chunk at level 9 as chip_smoke.py does
(chip_smoke.intake_kernel_inputs: the chunk window, its pieces' sums, the
blocks' raw ranges). It compiles with nvcc, all at once:

  * tools/probe_intake_kernels.cu: D5's first design (two launches) and
    its parts: pass 1 alone, pass 1 with its scan patched out (the byte
    chains and the stores only), pass 2 alone on pass 1's output; D6's
    first design, and its searches with every cut's target given (a warp a
    cut, no chain);
  * bz2tpu_torch/csrc/crc_ranges.cu as the port builds it, and with its
    source patched (D5_PATCHES): 256 and 1,024 threads a CTA, the byte
    table once a lane, every tile stopping once its aggregate is out, no
    look-back, the byte chains alone, the set-up alone, the tile taken
    from blockIdx, the global timer stamped at eight points; and
    bz2tpu_torch/csrc/block_cuts.cu as the port builds it, and patched
    (D6_PATCHES): 2 and 4 probes a lane a search step (64- and 128-ary
    searches, each window then loaded on its own), its chain walk cut
    out, clock64() stamps; each its own library;

with -Xptxas -v (registers, spills), and counts the SASS instructions of
each kernel and of its loops (cuobjdump). Each variant that computes the
function is held exact against the plain version (ops/crc.crc32_ranges_ref,
ops/rle1.block_cuts_ref); D5's first design and the port are also run on
16 ranges of the chunk and on a 32 MiB window, and D6's on synthetic sums
whose cuts leave their windows (chip_smoke.slow_path_sums). Each variant
is timed with CUDA events over N calls after a warm-up, in turns, and its
kernels' device time by torch.profiler over 10 N more (each kernel's
mean over the events seen), in all and by kernel, also twice in turns. It prints
one JSON object (card name and power limit, shapes, ms and device ms per
variant, the port D6's slow cuts, ptxas lines, SASS counts) and writes it
to --out. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CORPUS_BYTES = 16_000_000
# The port's sources and variants of them (name -> [(text or pattern,
# replacement, times it occurs), ...]); the variants in EXACT compute the
# function, the others are for timing only. "tile_by_block" takes each
# tile from blockIdx: on the 8 MiB chunk every CTA is resident at once, so
# its look-back cannot wait on a CTA that has not started.
D5_PATCHES = {
    "port": [],
    "threads256": [("constexpr int kLogThreads = 9;", "constexpr int kLogThreads = 8;", 1)],
    "threads1024": [("constexpr int kLogThreads = 9;", "constexpr int kLogThreads = 10;", 1)],
    "table_per_lane": [  # 32 copies of the byte table, entry b of lane l at 32 b + l: no bank conflicts
        ("  __shared__ u32 tab[256];", "  __shared__ u32 tab0[256];\n  __shared__ u32 tab[256 * 32];", 1),
        ("    tab[t] = c;", "    tab0[t] = c;", 1),
        ("  for (int i = t; i < 2 * n_ranges; i += kThreads) {",
         "  for (int i = t; i < 256 * 32; i += kThreads) tab[i] = tab0[i >> 5];\n"
         "  for (int i = t; i < 2 * n_ranges; i += kThreads) {", 1),
        ("tab[((s >> 24) ^ byte) & 0xffu]", "tab[((((s >> 24) ^ byte) & 0xffu) << 5) | (threadIdx.x & 31)]", 1)],
    "aggregates_only": [("    if (((p ? (p - 1) : 0) >> kLogSpan) == (long long)tile) s_owns = 1;\n", "", 1)],
    "no_lookback": [("    if (tile > 0) {\n      for (long long round = 0;; ++round) {",
                     "    if (false) {\n      for (long long round = 0;; ++round) {", 1)],
    "chain_only": [("  // Inclusive scan of the warp's states:",
                    "  if (s == 0x9e3779b9u) crcs[0] = s;\n  return;\n  // Inclusive scan of the warp's states:", 1)],
    "setup_only": [("  // This thread's 64 bytes from state 0",
                    "  if (tab[t & 255] == 0x9e3779b9u) crcs[0] = d[0].x;\n  return;\n  // This thread's 64 bytes from state 0", 1)],
    "tile_by_block": [("    const unsigned tile = (unsigned)got;", "    const unsigned tile = blockIdx.x;", 1)],
}
# "stamps": the port's crc_ranges with the global timer read by thread 0
# of tile 0 and of the tiles that hold the middle range's end and the
# second-to-last range's end, at eight points (after the tile id, after
# the set-up, after its byte chain, after the warp scan, after the
# aggregate is out, after the look-back, and the endpoint warp's lane 0
# after its first pass's parts and at its end), written past the CRCs; "clocks": block_cuts with clock64() read by warp
# 0 (after reading n_pieces and the last sums, after the searches and
# windows, after the chain walk, at the end) and by warp 1 (its search
# done), written over `slow`.
D5_PATCHES["stamps"] = [
    ("  const unsigned tile = s_tile;",
     "  const unsigned tile = s_tile;\n  const long long e3 = pts.at(n_ranges + n_ranges / 2, n), e_last = pts.at(2 * n_ranges - 2, n);\n  const int stamp_slot = tile == 0 ? 0 : tile == ((e3 ? e3 - 1 : 0) >> kLogSpan) ? 1 : tile == ((e_last ? e_last - 1 : 0) >> kLogSpan) ? 2 : -1;\n"
     "#define STAMP(k) if (t == 0 && stamp_slot >= 0) { unsigned long long g; asm volatile(\"mov.u64 %0, %%globaltimer;\""
     " : \"=l\"(g)); crcs[8 + 8 * stamp_slot + (k)] = (long long)g; }\n"
     "#define STAMPW(k) if (lane == 0 && stamp_slot >= 0) { unsigned long long g; asm volatile(\"mov.u64 %0, %%globaltimer;\""
     " : \"=l\"(g)); crcs[8 + 8 * stamp_slot + (k)] = (long long)g; }\n  STAMP(0)", 1),
    ("  __syncthreads();\n\n  // This thread's 64 bytes", "  __syncthreads();\n  STAMP(1)\n\n  // This thread's 64 bytes", 1),
    ("  // Inclusive scan of the warp's states:", "  STAMP(2)\n  // Inclusive scan of the warp's states:", 1),
    ("  __syncthreads();\n\n  // Warp 0: the warp totals'", "  __syncthreads();\n  STAMP(3)\n\n  // Warp 0: the warp totals'", 1),
    ("  if (!s_owns) return;", "  STAMP(4)\n  if (!s_owns) {\n    STAMP(7)\n    return;\n  }", 1),
    ("    if (t == 0) s_prefix = prefix;", "    STAMP(5)\n    if (t == 0) s_prefix = prefix;", 1),
    ("      const u32 constant = __shfl_xor_sync(BZ2T_FULL_MASK, v, 1);",
     "      const u32 constant = __shfl_xor_sync(BZ2T_FULL_MASK, v, 1);\n      if (ep0 == 0) STAMPW(6)", 1),
    ("    if (!have_prefix) prefix_wait();\n  } else {", "    if (!have_prefix) prefix_wait();\n    STAMPW(7)\n  } else {", 1)]
# block_cuts' search with `fan` probes a lane a step, 32 fan parts; its
# last step loads no tail, so every window is loaded on its own.
FAN_SEARCH = """__device__ long long first_at_least(const int* __restrict__ a, long long lo, long long hi, long long target,
                                    const int* __restrict__ raw = nullptr, Tail* tail = nullptr) {
  constexpr int kFan = FAN;
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long step = (hi - lo + 32 * kFan - 1) / (32 * kFan);
    int vals[kFan];
#pragma unroll
    for (int j = 0; j < kFan; ++j) {
      const long long part = lo + (long long)(lane * kFan + j) * step;
      vals[j] = a[part < hi ? min(part + step, hi) - 1 : hi - 1];
    }
    int first = kFan;
#pragma unroll
    for (int j = kFan - 1; j >= 0; --j)
      if (lo + (long long)(lane * kFan + j) * step < hi && (long long)vals[j] >= target) first = j;
    const u32 mask = __ballot_sync(BZ2T_FULL_MASK, first < kFan);
    if (mask == 0) return hi;
    const int src = __ffs(mask) - 1;
    const long long f_first = lo + (long long)(src * kFan + __shfl_sync(BZ2T_FULL_MASK, first, src)) * step;
    hi = min(f_first + step, hi) - 1;
    lo = f_first;
  }
  return lo;
}
"""
SEARCH = re.compile(r"__device__ long long first_at_least\(.*?\n}\n", re.S)
D6_PATCHES = {
    "port": [],
    "fan2": [(SEARCH, FAN_SEARCH.replace("FAN", "2"), 1)],
    "fan4": [(SEARCH, FAN_SEARCH.replace("FAN", "4"), 1)],
    "clocks": [
        ("group = (int)(blockDim.x >> 5) - 1;",
         "group = (int)(blockDim.x >> 5) - 1;\n  const long long c0 = clock64();\n  long long* clk = reinterpret_cast<long long*>(slow);", 1),
        ("      s_base = 0;", "      s_base = 0;\n      clk[0] = clock64() - c0;", 1),
        ("      if (lane == 0) w_lo[m] = lo;", "      if (lane == 0) {\n        w_lo[m] = lo;\n        if (m == 0) clk[4] = clock64() - c0;\n      }", 1),
        ("    __syncthreads();\n    if (warp == 0) {", "    __syncthreads();\n    if (threadIdx.x == 0) clk[1] = clock64() - c0;\n    if (warp == 0) {", 1),
        ("      if (lane == 0) s_base = base;", "      if (lane == 0) clk[2] = clock64() - c0;\n      if (lane == 0) s_base = base;", 1),
        ("    if (slow) *slow = n_slow;", "    clk[3] = clock64() - c0;", 1)],
    "no_resolution": [("      const int cuts = min(group, max_blocks - b0);", "      const int cuts = 0;", 1)],
}
EXACT = {"d5": ("port", "threads256", "threads1024", "table_per_lane", "tile_by_block"),
         "d6": ("port", "fan2", "fan4")}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def patch(source: str, edits: list, what: str) -> str:
    """source with each edit made: (text or compiled pattern, replacement,
    the times it must occur)."""
    for old, new, count in edits:
        if isinstance(old, re.Pattern):
            source, found = old.subn(lambda _: new, source)
        else:
            found = source.count(old)
            source = source.replace(old, new)
        if found != count:
            raise RuntimeError(f"patch {what} matches {found} times, not {count}")
    return source


def build(tmp: Path) -> tuple[dict, dict]:
    """Compile every library at once; (name -> path, name -> ptxas lines)."""
    from bz2tpu_torch import _build

    nvcc = _build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    csrc = ROOT / "bz2tpu_torch" / "csrc"
    jobs = {"probe": ROOT / "tools" / "probe_intake_kernels.cu"}
    for label, file, patches in (("d5", "crc_ranges.cu", D5_PATCHES), ("d6", "block_cuts.cu", D6_PATCHES)):
        for name, edits in patches.items():
            patched = tmp / f"{label}_{name}.cu"
            patched.write_text(patch((csrc / file).read_text(), edits, f"{name} of {file}"))
            jobs[f"{label}_{name}"] = patched
    procs = {}
    for name, src in jobs.items():
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(csrc), "-o", str(tmp / f"{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        logs[name] = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
    return {name: tmp / f"{name}.so" for name in jobs}, logs


def device_split(fn, reps: int) -> dict:
    """fn() once, then reps calls under torch.profiler (device activity,
    chip_smoke.device_events): the device milliseconds a call in all
    ("ms") and by kernel name ("by_name", a launch's mean times its
    launches a call), and the device events seen ("events")."""
    from chip_smoke import call_ms, device_events

    ops = device_events(fn, reps)
    return {"ms": call_ms(ops), "by_name": {k[:60]: v["ms"] * v["per_call"] for k, v in ops.items()},
            "events": sum(v["events"] for v in ops.values())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_intake_kernels.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_intake_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from bz2tpu_torch.ops import crc, crc_cuda, rle1
    from bz2tpu_torch.utils.corpus import make_mixed_corpus
    from bz2tpu_torch.utils.device import gpu_name_and_power_limit
    from chip_smoke import cuda_ms, intake_kernel_inputs, slow_path_sums
    from probe_dec_kernels import sass_counts

    dev = torch.device("cuda")
    card = gpu_name_and_power_limit()
    corpus = make_mixed_corpus(CORPUS_BYTES)
    ik = intake_kernel_inputs(corpus, dev)
    chunk, cap, cut_args = ik["chunk"], ik["cap"], ik["cut_args"]
    max_blocks = len(ik["ends"])
    n = chunk.shape[0]
    # D5's cases: the chunk's blocks, 16 ranges of it, a 32 MiB window.
    gen = torch.Generator().manual_seed(12)
    a, b = torch.randint(0, n + 1, (2, 16), generator=gen)
    wide = torch.zeros(4 * n, dtype=torch.uint8, device=dev)
    wide[: len(corpus)] = torch.frombuffer(bytearray(corpus), dtype=torch.uint8).to(dev)
    wcuts = torch.arange(1, max_blocks + 1, device=dev) * wide.shape[0] // max_blocks
    d5_cases = {
        "chunk": (chunk, ik["starts"].long(), ik["ends"].long()),
        "b16": (chunk, torch.minimum(a, b).to(dev), torch.maximum(a, b).to(dev)),
        "32MiB": (wide, wcuts - wide.shape[0] // max_blocks, wcuts),
    }
    want5 = {k: crc.crc32_ranges_ref(*v) for k, v in d5_cases.items()}
    ref_cuts = rle1.block_cuts_ref(*cut_args, cap=cap, max_blocks=max_blocks)
    syn = slow_path_sums(dev)
    d6_cases = {"chunk": cut_args, "slow_path": syn}
    want6 = {k: rle1.block_cuts_ref(*v, cap=cap, max_blocks=max_blocks) for k, v in d6_cases.items()}
    result = {"card": card, "shapes": {"chunk_bytes": n, "covered": int(ik["ends"].max()), "ranges": max_blocks,
                                       "entries": cut_args[0].shape[0], "n_pieces": int(cut_args[2]),
                                       "live_cuts": int(ref_cuts[2]), "cap": cap}}

    with tempfile.TemporaryDirectory() as tmp:
        libs, ptxas = build(Path(tmp))
        result["ptxas"] = ptxas
        result["sass"] = {name: sass_counts(path) for name, path in libs.items()}
        h = {name: ctypes.CDLL(str(path)) for name, path in libs.items()}
        h["probe"].probe_d5_work.argtypes = [_L, _I]
        h["probe"].probe_d5_work.restype = _L
        h["probe"].probe_d5_first.argtypes = [_I, _I, _P, _L, _P, _I, _P, _P, _P]
        h["probe"].probe_d6.argtypes = [_I, _P, _P, _L, _P, _L, _I, _P, _I, _P, _P, _P, _P]
        for name in D5_PATCHES:
            h[f"d5_{name}"].bz2t_crc_ranges_tiles.argtypes = [_L]
            h[f"d5_{name}"].bz2t_crc_ranges_work.argtypes = [_I, _I]
            h[f"d5_{name}"].bz2t_crc_ranges.argtypes = [_P, _L, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P]
        for name in D6_PATCHES:
            h[f"d6_{name}"].bz2t_block_cuts.argtypes = [_P, _P, _L, _P, _L, _I, _P, _P, _P, _P, _P]
        cs = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        maps = torch.from_numpy(crc_cuda.shift_maps().view("int32").copy()).to(dev)

        def check(err, what):
            if err:
                raise RuntimeError(f"{what}: CUDA error {err}")

        def d5_first(case, parts=3, scan=1):
            ch, s, e = d5_cases[case]
            pts = torch.cat([s, e]).long()
            work = torch.empty(h["probe"].probe_d5_work(ch.shape[0], s.shape[0]), dtype=torch.int32, device=dev)
            crcs = torch.empty(s.shape[0], dtype=torch.int64, device=dev)
            if parts == 2:  # pass 2 reads pass 1's output
                check(h["probe"].probe_d5_first(1, 1, ch.data_ptr(), ch.shape[0], pts.data_ptr(), s.shape[0],
                                                work.data_ptr(), crcs.data_ptr(), cs()), "d5 pass 1")

            def run():
                check(h["probe"].probe_d5_first(parts, scan, ch.data_ptr(), ch.shape[0], pts.data_ptr(), s.shape[0],
                                                work.data_ptr(), crcs.data_ptr(), cs()), "d5 first design")
                return crcs
            return run

        def d5_port(case, build_name="port"):
            lib = h[f"d5_{build_name}"]
            ch, s, e = d5_cases[case]
            tiles = lib.bz2t_crc_ranges_tiles(ch.shape[0])
            work = torch.zeros(lib.bz2t_crc_ranges_work(tiles, s.shape[0]), dtype=torch.int32, device=dev)
            crcs = torch.zeros(s.shape[0] + (24 if build_name == "stamps" else 0), dtype=torch.int64, device=dev)

            def run():
                check(lib.bz2t_crc_ranges(ch.data_ptr(), ch.shape[0], s.data_ptr(), e.data_ptr(), 1, s.shape[0],
                                          maps.data_ptr(), work.data_ptr(), tiles, s.shape[0], crcs.data_ptr(),
                                          cs()), "d5 port")
                return crcs[: s.shape[0]]
            run.out = crcs
            return run

        def d6(case, variant, build_name="port"):
            oc, rc, npc = d6_cases[case]
            out_cuts = torch.empty(max_blocks, dtype=torch.int32, device=dev)
            raw_cuts = torch.empty_like(out_cuts)
            n_blocks = torch.empty((), dtype=torch.int32, device=dev)
            slow = torch.zeros(16 if build_name == "clocks" else 1, dtype=torch.int32, device=dev)
            ref = want6[case]
            live = int(ref[2])
            targets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), ref[0][: live - 1].long()]) + cap

            def run():
                if variant == "port":
                    err = h[f"d6_{build_name}"].bz2t_block_cuts(oc.data_ptr(), rc.data_ptr(), oc.shape[0], npc.data_ptr(), cap,
                                                       max_blocks, out_cuts.data_ptr(), raw_cuts.data_ptr(),
                                                       n_blocks.data_ptr(), slow.data_ptr(), cs())
                else:
                    err = h["probe"].probe_d6(variant == "given", oc.data_ptr(), rc.data_ptr(), oc.shape[0],
                                              npc.data_ptr(), cap, max_blocks, targets.data_ptr(), live,
                                              out_cuts.data_ptr(), raw_cuts.data_ptr(), n_blocks.data_ptr(), cs())
                check(err, f"d6 {variant}")
                if variant == "given":  # the live cuts only; the rest are the plain version's
                    return out_cuts[:live], raw_cuts[:live]
                return out_cuts, raw_cuts, n_blocks
            run.slow = slow
            return run

        d5 = {"first_design": (d5_first("chunk"), "chunk"),
              "first_pass1": (d5_first("chunk", 1), None),
              "first_pass1_no_scan": (d5_first("chunk", 1, 0), None),
              "first_pass2": (d5_first("chunk", 2), None)}
        for name in D5_PATCHES:
            d5[f"redesign_{name}"] = (d5_port("chunk", name), "chunk" if name in EXACT["d5"] else None)
        for case in ("b16", "32MiB"):
            d5[f"first_design_{case}"] = (d5_first(case), case)
            d5[f"redesign_port_{case}"] = (d5_port(case), case)
        d6v = {}
        for case in d6_cases:
            for variant in ("first", "given", "port"):
                d6v[f"{variant}_{case}"] = (d6(case, variant), case)
        for name in D6_PATCHES:
            if name != "port":
                d6v[f"port_{name}_chunk"] = (d6("chunk", "port", name), "chunk" if name in EXACT["d6"] else None)

        for label, variants, want in (("d5", d5, want5), ("d6", d6v, want6)):
            exact = {}
            for name, (run, case) in variants.items():
                got = run()
                torch.cuda.synchronize()
                if case is not None:
                    ref = want[case]
                    if name.startswith("given"):
                        live = int(ref[2])
                        ref = (ref[0][:live], ref[1][:live])
                    ref = ref if isinstance(ref, tuple) else (ref,)
                    got = got if isinstance(got, tuple) else (got,)
                    exact[name] = all(torch.equal(g, r) for g, r in zip(got, ref))
                    if not exact[name]:
                        raise AssertionError(f"{label} {name} disagrees with the plain version")
            times = {name: [] for name in variants}
            for turn in range(2):  # in turns, forwards then backwards
                for name in (list(variants) if turn == 0 else list(reversed(variants))):
                    times[name].append(cuda_ms(variants[name][0], args.reps))
            device = {name: [] for name in variants}
            for turn in range(2):  # in turns, forwards then backwards
                for name in (list(variants) if turn == 0 else list(reversed(variants))):
                    device[name].append(device_split(variants[name][0], 10 * args.reps))
            result[label] = {"ms": times, "device_ms": device, "exact": exact}
        result["d6"]["slow_cuts"] = {name: int(run.slow[0]) for name, (run, _) in d6v.items()
                                     if name.startswith("port") and "clocks" not in name}
        # The timer stamps (ns from tile 0's first) and warp clocks (cycles).
        stamps = d5["redesign_stamps"][0]
        stamps()
        torch.cuda.synchronize()
        st = stamps.out[8:].view(3, 8)
        result["d5"]["stamps_ns"] = {tile: (row - st[0, 0]).tolist() for tile, row in
                                     zip(("0", "middle_end", "last_end"), st)}
        clocks = d6v["port_clocks_chunk"][0]
        clocks()
        torch.cuda.synchronize()
        result["d6"]["clocks_cycles"] = dict(zip(("prologue", "searched", "walked", "end", "warp1_search"),
                                                 clocks.slow.view(torch.int64)[:5].tolist()))
    print(json.dumps(result))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
