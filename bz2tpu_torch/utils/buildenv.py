"""The build cache, and the prime pass that fills it.

The counterpart of bz2tpu/utils/jaxenv.py. bz2tpu's compiled code lives in
a persistent XLA compilation cache; the port's is two shared libraries,
the CUDA kernels (_build.py, one ``nvcc`` of every ``csrc/*.cu``) and the
host C core (native/, one ``cc`` of ``_bz2dec.c``), each named by a hash
of its sources in one directory: ``BZ2TPU_TORCH_CACHE_DIR``, or
``build/bz2tpu_torch/`` at the root of the checkout. A shipped build
(utils/aot.py) named by ``BZ2TPU_TORCH_AOT_DIR`` is installed into it. The
variables carry ``_TORCH`` because what they hold is not bz2tpu's, and one
process may use both packages.

The libraries are all that persists from one process to the next: a CUDA
context, the caching allocator's pool and the lazily loaded kernel modules
belong to one process. So a primed cache spares later processes the
compilers, and nothing else.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np

from bz2tpu_torch import _build

_DONE = False

# Bytes that reach every kernel of both compress paths: repeated text, every
# byte value, a long run (RLE1) and seeded random bytes.
_PRIME_INPUT = (b"bz2tpu_torch primes its build cache. " * 1500 + bytes(range(256)) * 64 + b"\0" * 5000
                + np.random.default_rng(9).integers(0, 256, 20_000, dtype=np.uint8).tobytes())


def setup_build_cache(path: str | os.PathLike | None = None) -> Path:
    """Point the build cache (``_build.BUILD_DIR``, where both libraries are
    built and looked for) at ``path``, else at ``BZ2TPU_TORCH_CACHE_DIR``
    where it is set, else leave it at ``build/bz2tpu_torch/``; then install
    the artifact that ``BZ2TPU_TORCH_AOT_DIR`` names, if any. Returns the
    cache.

    Without ``path`` it runs once per process: importing the package makes
    that call, before native/ builds. A ``path`` re-points the cache for the
    builds that follow.
    """
    global _DONE
    if _DONE and path is None:
        return _build.BUILD_DIR
    _DONE = True
    cache = path or os.environ.get("BZ2TPU_TORCH_CACHE_DIR")
    if cache:
        _build.BUILD_DIR = Path(cache).expanduser().resolve()
    aot_dir = os.environ.get("BZ2TPU_TORCH_AOT_DIR")
    if aot_dir and Path(aot_dir).resolve() != _build.BUILD_DIR:
        from bz2tpu_torch.utils import aot

        aot.install(aot_dir, _build.BUILD_DIR)
    return _build.BUILD_DIR


def prime(levels=(9,), batch: int | None = None, device=None) -> None:
    """Build and load both libraries into the build cache, then run
    ``compress`` and ``compress_device_intake`` once per level on
    ``device`` (CUDA unless the caller names the CPU, where no kernel
    library is needed), each stream checked with stdlib bz2. Prints the
    build's seconds and compiler runs, then each level's seconds."""
    import bz2

    from bz2tpu_torch import native
    from bz2tpu_torch.runtime.compressor import compress, compress_device_intake
    from bz2tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cache = setup_build_cache()
    if not native.HAVE_NATIVE:
        raise RuntimeError(f"the host C library did not build into {cache} (is a C compiler installed?)")
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.lib()
    kernels = "not needed on the CPU" if dev.type != "cuda" else (
        "loaded" if _build.build_seconds is None else f"built by nvcc in {_build.build_seconds:.1f}s")
    print(f"build cache {cache}: kernel library {kernels}, ready in {time.perf_counter() - t0:.1f}s "
          f"(compiler runs in this process: nvcc {_build.compiler_runs}, cc {native.compiler_runs})")
    for level in levels:
        t0 = time.perf_counter()
        for fn in (compress, compress_device_intake):
            if bz2.decompress(fn(_PRIME_INPUT, level=level, parallel=batch, device=dev)) != _PRIME_INPUT:
                raise RuntimeError(f"{fn.__name__} at level {level} does not round-trip through stdlib bz2")
        print(f"primed level {level} on {dev}: {time.perf_counter() - t0:.1f}s")
