"""Atomic file output: unique temp in the target directory + rename.

Shared by the compression and decompression file drivers so a failure
mid-run never leaves a truncated output and concurrent writers to the same
path cannot clobber each other's temp files. The port's copy of
bz2tpu/utils/atomic.py, verbatim.
"""

from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager


@contextmanager
def atomic_output(out_path: str):
    """Yield a binary file object; on clean exit the file is renamed to
    out_path, on error the temp file is removed."""
    out_dir = os.path.dirname(os.path.abspath(out_path)) or "."
    fd, tmp_path = tempfile.mkstemp(
        prefix=os.path.basename(out_path) + ".", suffix=".bz2tpu-tmp", dir=out_dir
    )
    try:
        with os.fdopen(fd, "wb") as fout:
            yield fout
        os.replace(tmp_path, out_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
