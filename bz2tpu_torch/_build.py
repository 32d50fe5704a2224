"""Build and load the port's CUDA kernels (the counterpart of the JAX
package's compile cache, bz2tpu/utils/jaxenv.py).

At first use, every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a``,
one ``nvcc`` per source, all started together, and the objects link into
ONE shared library with a plain C interface, which ``ctypes`` loads. The
library lands in the build cache, ``build/bz2tpu_torch/`` at the root of
the checkout unless ``BZ2TPU_TORCH_CACHE_DIR`` names another
(utils/buildenv.py), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once. A missing
``nvcc`` or a failed build raises: there is no fallback for a CUDA tensor.

The library has a plain C interface and links the CUDA runtime statically
(nvcc's default), so it depends on the toolkit that built it, never on
torch's ABI: a shipped build (utils/aot.py) keys on the sources and
flags, not on the torch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# The build cache; utils/buildenv.setup_build_cache re-points it.
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "bz2tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> (argtypes); every entry point returns a cudaError_t as int, the
# *_scratch and *_work helpers return a buffer size in 32-bit words, the
# *_smem helper one in bytes, *_entries a count of entries.
SIGNATURES = {
    "bz2t_radix_sort_scratch": (_I,),
    "bz2t_radix_sort_u64": (_P, _P, _P, _P, _I, _I, _I, _P),
    "bz2t_rerank_work": (_I, _I),
    "bz2t_rerank": (_P, _I, _I, _I, _P, _I, _P, _P, _P),
    "bz2t_mtf_scratch": (_I, _I, _I),
    "bz2t_mtf_ranks": (_P, _P, _P, _I, _I, _I, _P, _P, _P),
    "bz2t_dec_chain_smem": (_I,),
    "bz2t_dec_chain": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "bz2t_huffman_plan": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    "bz2t_lut_first_entries": (),
    "bz2t_lut_first_level": (_P, _I, _P, _P),
    "bz2t_dec_symbols": (_P, _L, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "bz2t_mtf_dec": (_P, _L, _P, _P, _P),
    "bz2t_crc_ranges_tiles": (_L,),
    "bz2t_crc_ranges_work": (_I, _I),
    "bz2t_crc_ranges": (_P, _L, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P),
    "bz2t_block_cuts": (_P, _P, _L, _P, _L, _I, _P, _P, _P, _P, _P),
    "bz2t_rle1_dec_tiles": (_L,),
    "bz2t_rle1_dec_parse": (_P, _L, _L, _P, _I, _I, _P, _P, _P, _P, _P),
    "bz2t_rle1_dec_expand": (_P, _L, _L, _P, _I, _I, _P, _P, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc run, None if cached
compiler_runs = 0  # nvcc processes this process started (compiles and the link)


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_name() -> str:
    """The kernel library's file name in the build cache."""
    return f"libbz2tpu_torch_{_digest()}.so"


def _compile(out: Path) -> None:
    global build_seconds, compiler_runs
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_sources(), objs)
        ]
        compiler_runs += len(procs)
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(src.name, log) for src, proc, log in zip(_sources(), procs, logs) if proc.returncode]
        if not failed:
            compiler_runs += 1
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            if link.returncode:
                failed = [("link", link.stdout + link.stderr)]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{name}:\n{log}" for name, log in failed))
        os.replace(tmp, out)  # atomic: concurrent builds race safely
    finally:
        build_seconds = time.perf_counter() - t0
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    from bz2tpu_torch.utils.buildenv import setup_build_cache

    setup_build_cache()
    with _lock:
        if _lib is None:
            out = BUILD_DIR / library_name()
            if not out.exists():
                _compile(out)
            handle = ctypes.CDLL(str(out))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
