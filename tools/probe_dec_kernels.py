"""Variants of the decode kernels dec_symbols (D3) and mtf_dec (D4) timed
on the card, on the inputs a decode of the port's 16 MB stream hands them.

    python3 tools/probe_dec_kernels.py [--reps N] [--out FILE]

It builds the 16 MB mixed corpus at level 9 (bz2tpu_torch.utils.corpus),
compresses it with the port and captures the arguments of both kernels on
the stream's batch with the most symbols (chip_smoke.decode_kernel_inputs).
It compiles with nvcc, all at once:

  * tools/probe_dec_kernels.cu: D3's first design as it was, with its
    stores sent to a shared-memory sink, with its LUT read replaced by a
    constant, and with both; D4's first design; D4 as one warp a chunk with
    32-bit lane words and the trailing zeros skipped, as two and as four
    chunks a warp, and as one thread a chunk;
  * bz2tpu_torch/csrc/dec_symbols.cu and mtf_dec.cu as the port builds
    them, dec_symbols with other CTA widths and first-level widths
    (BZ2T_D3_WARPS, BZ2T_D3_FIRST_BITS), and dec_symbols with one part
    patched out for timing (D3_PATCHES: no write-out, no decode), each its
    own library;

with -Xptxas -v (registers, spills), and counts the SASS instructions of
each kernel and of its loops (cuobjdump, from the CUDA toolkit or
Triton's copy). Each variant that computes the function is held exact
against the plain version (ops/dec_cuda.decode_groups_ref,
ops/mtf_dec_cuda.chunk_perms_ref); each is timed with CUDA events over N
calls after a warm-up, in turns, and its kernels' device time is summed
by torch.profiler over N more (the events also count any gap the host
leaves between launches). It prints one JSON object (card name
and power limit, shapes, the symbols whose first-level bucket is marked at
each width, ms per variant, ptxas lines, SASS counts) and
writes it to --out. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
LEVEL = 9
CORPUS_BYTES = 16_000_000
# name -> (source, -D definitions); "port" builds as _build.py does.
D3_BUILDS = {
    "port": {},
    "warps8": {"BZ2T_D3_WARPS": 8},
    "first11": {"BZ2T_D3_FIRST_BITS": 11},
    "first12": {"BZ2T_D3_FIRST_BITS": 12},
}
# Timing-only variants of dec_symbols: the port's source with one part cut
# out or changed (name -> (text, replacement)); none computes the function.
D3_PATCHES = {
    "no_write_out": ("    out_s[e] = w_sym[e];\n    out_l[e] = w_len[e];\n",
                     "    if (w_sym[e] == 0x7fffffff) out_s[e] = w_len[e];\n"),
    "no_decode": ("    decode_group(words, n_words, offs[at], c, w_sym + lane * kGroup, w_len + lane * kGroup);\n",
                  "    w_sym[lane * kGroup] = c.base[0] + (int)offs[at];\n"),
}
D4_BUILDS = {"port": {}}
D4_VARIANTS = ("first_design", "lanes32_a_chunk", "lanes16_a_chunk", "lanes8_a_chunk", "thread_a_chunk")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def tool(name: str) -> str | None:
    found = shutil.which(name) or (lambda p: p if os.path.exists(p) else None)(f"/usr/local/cuda/bin/{name}")
    if found:
        return found
    try:
        import triton
        cand = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / name
        return str(cand) if cand.exists() else None
    except ImportError:
        return None


def build(tmp: Path) -> tuple[dict, dict]:
    """Compile every library at once; (name -> path, name -> ptxas lines)."""
    from bz2tpu_torch import _build

    nvcc = _build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    jobs = {"probe": (ROOT / "tools" / "probe_dec_kernels.cu", {})}
    csrc = ROOT / "bz2tpu_torch" / "csrc"
    for name, defs in D3_BUILDS.items():
        jobs[f"d3_{name}"] = (csrc / "dec_symbols.cu", defs)
    for name, (text, replacement) in D3_PATCHES.items():
        source = (csrc / "dec_symbols.cu").read_text()
        if source.count(text) != 1:
            raise RuntimeError(f"patch {name} does not match dec_symbols.cu once")
        patched = tmp / f"dec_symbols_{name}.cu"
        patched.write_text(source.replace(text, replacement))
        jobs[f"d3p_{name}"] = (patched, {})
    for name, defs in D4_BUILDS.items():
        jobs[f"d4_{name}"] = (ROOT / "bz2tpu_torch" / "csrc" / "mtf_dec.cu", defs)
    procs = {}
    for name, (src, defs) in jobs.items():
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(csrc), "-o", str(tmp / f"{name}.so"),
               str(src), *[f"-D{k}={v}" for k, v in defs.items()]]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        logs[name] = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
    return {name: tmp / f"{name}.so" for name in jobs}, logs


def sass_counts(lib: Path) -> dict | None:
    """Per kernel of the library: its SASS instructions and, for each loop
    (a branch back to an earlier address), the instructions in its body."""
    cuobjdump = tool("cuobjdump")
    if cuobjdump is None:
        return None
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)
        addrs = [int(a, 16) for a, _ in ins]
        loops = []
        for a, body in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", body)
            if m and int(m.group(1), 16) < int(a, 16):
                lo, hi = int(m.group(1), 16), int(a, 16)
                loops.append(sum(lo <= x <= hi for x in addrs))
        out[name] = {"instructions": len(ins), "loop_bodies": loops}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_dec_kernels.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_dec_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import bz2tpu_torch
    from bz2tpu_torch.ops import dec_cuda, mtf_dec_cuda
    from bz2tpu_torch.utils.corpus import make_mixed_corpus
    from bz2tpu_torch.utils.device import gpu_name_and_power_limit
    from chip_smoke import cuda_ms, decode_kernel_inputs, device_ms

    dev = torch.device("cuda")
    card = gpu_name_and_power_limit()
    stream = bz2tpu_torch.compress(make_mixed_corpus(CORPUS_BYTES), level=LEVEL)
    captured = decode_kernel_inputs(stream, dev)
    words, offs, tbl, lut, lut_idx, base, perm = captured["dec_symbols"]
    (js,) = captured["mtf_dec"]
    B, G = offs.shape
    T = base.shape[1]
    n_chunks = js.numel() // mtf_dec_cuda.CHUNK
    # Symbols whose first-level bucket is marked, by first-level width.
    lens_w = dec_cuda.decode_groups_ref(words, offs, tbl, lut, lut_idx, base, perm)[1].view(B, G, -1).long()
    pos = offs[:, :, None] + lens_w.cumsum(2) - lens_w
    v23 = dec_cuda.window23(words, pos)
    rows = lut_idx.long().gather(1, tbl.long())[:, :, None]
    marked = {}
    for bits in (10, 11, 12, 14):
        first = dec_cuda.first_level_tables_ref(lut, bits)
        marked[bits] = int((first.view(-1)[(rows << bits) + (v23 >> (23 - bits))] == 0).sum())
    del lens_w, pos, v23, rows
    walked = torch.where(js.view(-1, 128) > 0, torch.arange(1, 129, device=dev), 0).amax(1)
    result = {"card": card, "d3_shape": {"groups": [B, G], "tables": T, "lut_rows": lut.shape[0],
                                         "symbols": B * G * 50, "marked_symbols_by_first_bits": marked},
              "d4_shape": {"js": list(js.shape), "chunks": n_chunks, "literals": int((js > 0).sum()),
                           "steps_to_last_nonzero": int(walked.sum())}}

    with tempfile.TemporaryDirectory() as tmp:
        libs, ptxas = build(Path(tmp))
        result["ptxas"] = ptxas
        result["sass"] = {name: sass_counts(path) for name, path in libs.items()}
        handles = {name: ctypes.CDLL(str(path)) for name, path in libs.items()}
        probe = handles["probe"]
        probe.probe_d3_first.argtypes = [_I, _P, _L, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P]
        probe.probe_d4.argtypes = [_I, _P, _L, _P, _P, _P]
        for name in handles:
            if name.startswith("d3"):
                for fn, types in (("bz2t_lut_first_entries", []),
                                  ("bz2t_lut_first_level", [_P, _I, _P, _P]),
                                  ("bz2t_dec_symbols", [_P, _L, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                                                        _P])):
                    getattr(handles[name], fn).argtypes = types
            elif name.startswith("d4_"):
                handles[name].bz2t_mtf_dec.argtypes = [_P, _L, _P, _P, _P]
        cs = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        want3 = dec_cuda.decode_groups_ref(words, offs, tbl, lut, lut_idx, base, perm)
        want4 = mtf_dec_cuda.chunk_perms_ref(js)
        syms = torch.empty(B, G * 50, dtype=torch.int32, device=dev)
        lens = torch.empty_like(syms)
        q = torch.empty(js.shape[0], js.shape[1] // 128, 256, dtype=torch.uint8, device=dev)
        emit = torch.empty(js.shape[0], js.shape[1] // 128, 128, dtype=torch.uint8, device=dev)

        def d3_first(variant):
            def run():
                err = probe.probe_d3_first(variant, words.data_ptr(), words.numel(), offs.data_ptr(), tbl.data_ptr(),
                                           lut.data_ptr(), lut.shape[0], lut_idx.data_ptr(), base.data_ptr(),
                                           perm.data_ptr(), B, T, G, syms.data_ptr(), lens.data_ptr(), cs())
                if err:
                    raise RuntimeError(f"probe_d3_first {variant}: CUDA error {err}")
            return run

        def d3_port(lib):
            first = torch.empty(lut.shape[0], lib.bz2t_lut_first_entries(), dtype=torch.uint8, device=dev)

            def run(first_only=False):
                err = lib.bz2t_lut_first_level(lut.data_ptr(), lut.shape[0], first.data_ptr(), cs())
                if not err and not first_only:
                    err = lib.bz2t_dec_symbols(words.data_ptr(), words.numel(), offs.data_ptr(), tbl.data_ptr(),
                                               lut.data_ptr(), lut.shape[0], first.data_ptr(), lut_idx.data_ptr(),
                                               base.data_ptr(), perm.data_ptr(), B, T, G, syms.data_ptr(),
                                               lens.data_ptr(), cs())
                if err:
                    raise RuntimeError(f"dec_symbols: CUDA error {err}")
            return run

        def d4(run_fn):
            def run():
                err = run_fn(js.data_ptr(), n_chunks, q.data_ptr(), emit.data_ptr(), cs())
                if err:
                    raise RuntimeError(f"mtf_dec variant: CUDA error {err}")
            return run

        d3 = {f"first_design_{tag}": (d3_first(v), v == 0)
              for v, tag in enumerate(("as_is", "sink_stores", "const_lut", "sink_and_const"))}
        for name in D3_BUILDS:
            run = d3_port(handles[f"d3_{name}"])
            d3[f"redesign_{name}"] = (run, True)
            if name == "port":
                d3["redesign_port_first_pass_only"] = (lambda run=run: run(True), False)
        for name in D3_PATCHES:
            d3[f"redesign_{name}"] = (d3_port(handles[f"d3p_{name}"]), False)
        d4v = {name: (d4(lambda *a, v=v: probe.probe_d4(v, *a)), True) for v, name in enumerate(D4_VARIANTS)}
        for name in D4_BUILDS:
            d4v[f"redesign_{name}"] = (d4(handles[f"d4_{name}"].bz2t_mtf_dec), True)

        for label, variants, outs, want in (("d3", d3, (syms, lens), want3), ("d4", d4v, (q, emit), want4)):
            exact = {}
            for name, (run, checked) in variants.items():
                for t in outs:
                    t.fill_(-1 if t.dtype == torch.int32 else 7)
                run()
                torch.cuda.synchronize()
                if checked:
                    exact[name] = all(torch.equal(g, w) for g, w in zip(outs, want))
                    if not exact[name]:
                        raise AssertionError(f"{label} {name} disagrees with the plain version")
            times = {name: [] for name in variants}
            for turn in range(2):  # in turns, forwards then backwards
                order = list(variants) if turn == 0 else list(reversed(variants))
                for name in order:
                    times[name].append(cuda_ms(variants[name][0], args.reps))
            device = {name: device_ms(run, args.reps) for name, (run, _) in variants.items()}
            result[label] = {"ms": times, "device_ms": device, "exact": exact}
    print(json.dumps(result))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
