"""Build and load the port's CUDA kernels (the counterpart of the JAX
package's compile cache, bz2tpu/utils/jaxenv.py).

At first use, every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into
ONE shared library with a plain C interface, which ``ctypes`` loads. The
library lands in ``build/bz2tpu_torch/`` at the root of the checkout, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. A missing ``nvcc`` or a failed build raises:
there is no fallback for a CUDA tensor.
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
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "bz2tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> (argtypes); every entry point returns a cudaError_t as int, the
# *_scratch helpers return a scratch size in 32-bit words.
SIGNATURES = {
    "bz2t_radix_sort_scratch": (_I,),
    "bz2t_radix_sort_u64": (_P, _P, _P, _P, _I, _I, _I, _P),
    "bz2t_rerank_scratch": (_I,),
    "bz2t_rerank": (_P, _I, _I, _P, _P, _P, _P),
    "bz2t_mtf_scratch": (_I, _I, _I),
    "bz2t_mtf_ranks": (_P, _P, _P, _I, _I, _I, _P, _P, _P),
    "bz2t_dec_chain": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc run, None if cached


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


def _compile(out: Path) -> None:
    global build_seconds
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race safely


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            out = BUILD_DIR / f"libbz2tpu_torch_{_digest()}.so"
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
