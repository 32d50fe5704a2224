"""The port's host C core (grown from bz2tpu/native/_bz2dec.c): stream and
block decoder, block scan, block header parse, RLE1 splitter, inverse RLE1
and CRC32.

At first import, ``_bz2dec.c`` compiles with ``cc`` (~1 s) into the build
cache beside the CUDA library of ``_build.py`` (``build/bz2tpu_torch/`` at
the root of the checkout, or ``BZ2TPU_TORCH_CACHE_DIR``), named by a hash
of the source and the command, and loads from there; nothing is written
inside a package directory. A shipped build (``BZ2TPU_TORCH_AOT_DIR``,
utils/aot.py) is installed into the cache first, so that it spares this
compile. Where no compiler is found or the build fails, ``HAVE_NATIVE`` is
False and the callers take their NumPy paths (bz2tpu_torch.oracle), as
bz2tpu's do.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path

from bz2tpu_torch import _build

SOURCE = Path(__file__).resolve().parent / "_bz2dec.c"
compiler_runs = 0  # cc processes this process started


def _command(out: Path) -> list[str]:
    cc = sysconfig.get_config_var("CC") or "cc"
    return [*cc.split(), "-O3", "-Wall", "-shared", "-fPIC",
            "-I", sysconfig.get_path("include"), str(SOURCE), "-o", str(out)]


def source_digest() -> str:
    """A hash of the source and the compile command."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_command(Path("out"))).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the built extension lives in the build cache: the name carries
    source_digest(), so an edited source rebuilds."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _build.BUILD_DIR / f"_bz2dec_{source_digest()}{suffix}"


def _compile(out: Path) -> None:
    global compiler_runs
    out.parent.mkdir(parents=True, exist_ok=True)
    compiler_runs += 1
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(_command(tmp), check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: concurrent builders race safely
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    out = library_path()
    if not out.exists():
        _compile(out)
    # The module name's last component must be the one PyInit__bz2dec names.
    loader = importlib.machinery.ExtensionFileLoader(f"{__name__}._bz2dec", str(out))
    spec = importlib.util.spec_from_file_location(loader.name, str(out), loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


# The build cache is set up here, after library_path is defined (installing
# a shipped build reads it) and before the build below.
from bz2tpu_torch.utils.buildenv import setup_build_cache  # noqa: E402

setup_build_cache()

try:  # pragma: no cover - exercised via the public wrappers
    _impl = _load()
    HAVE_NATIVE = True
    decode_stream = _impl.decode_stream
    crc32 = _impl.crc32
    rle1_split = _impl.rle1_split
    scan_blocks = _impl.scan_blocks
    parse_block_header = _impl.parse_block_header
    decode_block_at = _impl.decode_block_at
    inverse_rle1 = _impl.inverse_rle1
    CrcError = _impl.CrcError
except (OSError, ImportError, subprocess.SubprocessError):  # no compiler, or the build failed
    HAVE_NATIVE = False
    decode_stream = None
    crc32 = None
    rle1_split = None
    scan_blocks = None
    parse_block_header = None
    decode_block_at = None
    inverse_rle1 = None
    CrcError = None
