"""Shippable builds: a fresh process reaches the port's compiled code with
no compiler run.

The counterpart of bz2tpu/utils/aot.py. The build cache
(utils/buildenv.py) makes the compilers a one-time cost per cache, but a
fresh machine or an emptied cache still pays one ``nvcc`` of every
``csrc/*.cu`` and one ``cc`` of ``native/_bz2dec.c`` before the first
compressed byte. An artifact is a directory that holds both libraries
under their hashed names, and a manifest:

  * ``export_artifact(DIR)`` (``bz2tpu-torch --export-aot DIR``) builds
    both into DIR, runs the prime pass against them and writes the
    manifest;
  * a process started with ``BZ2TPU_TORCH_AOT_DIR=DIR`` installs them into
    its build cache when the package is imported, before native/ would
    compile (hardlink, or copy where a link fails; idempotent), and finds
    both libraries built.

Artifacts are exact-match: the version, both source digests (each hashes
its sources and compile command, so edited sources never load a stale
library) and the platform (machine, Python's extension suffix) must agree,
or install warns once and the libraries build from source as they would
without an artifact. The torch version is not part of the key: the kernel
library has a plain C interface and links the CUDA runtime statically, so
it does not depend on torch's ABI (see _build.py).
"""

from __future__ import annotations

import json
import os
import platform
import re
import shutil
import subprocess
import sysconfig
import warnings
from pathlib import Path

from bz2tpu_torch import _build

_ARTIFACT_VERSION = 1
_MANIFEST = "bz2tpu_torch_aot_manifest.json"

# One-shot state: (artifact, cache) pairs already handled by this process,
# and install counters (tests assert on these).
_installed: dict[tuple[str, str], bool] = {}
stats = {"installed_files": 0, "skipped_files": 0}


def _key() -> dict:
    """What an artifact must share with this process, apart from the digests."""
    return {"version": _ARTIFACT_VERSION, "machine": platform.machine(),
            "ext_suffix": sysconfig.get_config_var("EXT_SUFFIX")}


def _mismatch(manifest: dict) -> list[str]:
    """What in ``manifest`` differs from this process's build; [] if nothing."""
    from bz2tpu_torch import native  # mid-import when the package's import installs

    bad = [k for k, v in _key().items() if manifest.get(k) != v]
    if manifest["host"]["digest"] != native.source_digest():
        bad.append("host digest")
    if manifest["kernels"] is not None and manifest["kernels"]["digest"] != _build._digest():
        bad.append("kernel digest")
    return bad


def _libraries(manifest: dict) -> list[str]:
    return [part["file"] for part in (manifest["host"], manifest["kernels"]) if part is not None]


def install(artifact_dir, cache_dir) -> bool:
    """Install an artifact's libraries into the build cache ``cache_dir``
    (idempotent: a library already there is kept). Returns True if the
    artifact was usable; a mismatched or unreadable one warns, once per
    process, and leaves the libraries to build from source."""
    key = (str(Path(artifact_dir).resolve()), str(Path(cache_dir).resolve()))
    if key in _installed:
        return _installed[key]
    ok = False
    try:
        manifest = json.loads((Path(artifact_dir) / _MANIFEST).read_text())
        mismatch = _mismatch(manifest)
        if mismatch:
            warnings.warn(
                f"BZ2TPU_TORCH_AOT_DIR artifact at {artifact_dir} does not match this build "
                f"({', '.join(mismatch)}); building from source",
                stacklevel=2,
            )
        else:
            os.makedirs(cache_dir, exist_ok=True)
            for name in _libraries(manifest):
                src, dst = os.path.join(artifact_dir, name), os.path.join(cache_dir, name)
                if os.path.exists(dst):
                    stats["skipped_files"] += 1
                    continue
                try:
                    os.link(src, dst)  # same file system: no copy
                except OSError:
                    shutil.copy2(src, dst)
                stats["installed_files"] += 1
            ok = True
    except (OSError, ValueError, KeyError, TypeError) as e:
        warnings.warn(
            f"BZ2TPU_TORCH_AOT_DIR artifact at {artifact_dir} unreadable ({e!r}); building from source",
            stacklevel=2,
        )
    _installed[key] = ok
    return ok


def _nvcc_version(nvcc: str) -> tuple[str, str | None]:
    """``nvcc --version``'s text, and the CUDA release it names (the
    runtime the kernel library links statically)."""
    text = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True, timeout=60).stdout
    found = re.search(r"release (\d+\.\d+)", text)
    return text.strip(), found.group(1) if found else None


def export_artifact(path, levels=(9,), batch: int | None = None, device=None) -> int:
    """Build ``path`` as a shippable artifact: the host library (cc) and,
    for a CUDA ``device`` (the default), the kernel library (nvcc), each
    under its hashed name; then run the prime pass (utils/buildenv.prime)
    against them at ``levels`` and write the manifest. With
    ``device="cpu"`` the artifact holds the host library only and its
    manifest records ``"kernels": null``. A CUDA device without ``nvcc``
    raises before anything is written, as any failed build does before the
    manifest is. Returns the number of libraries in the artifact.
    """
    from bz2tpu_torch import native
    from bz2tpu_torch.utils import buildenv
    from bz2tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    nvcc = _build.nvcc_path() if dev.type == "cuda" else None
    if dev.type == "cuda" and nvcc is None:
        raise RuntimeError("nvcc not found: an artifact for the card needs the kernel library")
    buildenv.setup_build_cache()
    out = Path(path).resolve()
    out.mkdir(parents=True, exist_ok=True)
    # Build into the artifact and prime against it; the process's cache is
    # restored after, and a kernel library it had loaded stays loaded.
    prev_dir, prev_lib = _build.BUILD_DIR, _build._lib
    _build.BUILD_DIR, _build._lib = out, None
    try:
        host = native.library_path()
        if not host.exists():
            native._compile(host)
        native._load()  # the artifact's host library loads
        if nvcc is not None:
            _build.lib()
        buildenv.prime(levels=levels, batch=batch, device=dev)
        kernels = None
        if nvcc is not None:
            nvcc_text, release = _nvcc_version(nvcc)
            kernels = {"file": _build.library_name(), "digest": _build._digest(),
                       "nvcc_flags": list(_build.NVCC_FLAGS), "nvcc_version": nvcc_text,
                       "cuda_runtime": release}
    finally:
        _build.BUILD_DIR = prev_dir
        if prev_lib is not None:
            _build._lib = prev_lib
    manifest = {
        **_key(),
        "host": {"file": host.name, "digest": native.source_digest()},
        "kernels": kernels,
        "levels": list(levels),
    }
    (out / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    return len(_libraries(manifest))
