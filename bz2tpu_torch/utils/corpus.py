"""The deterministic mixed corpus the port is timed on.

The port's own copy of the JAX package's benchmark corpus
(``bench.make_mixed_corpus`` and what it needs), so that nothing of the
port imports the benchmark of the TPU rounds. A Silesia-style mix in fixed
proportions: 40% real text (licence text and Python sources installed
beside NumPy), 15% binary (a NumPy extension module), 20% Markov text, 15%
structured runs and 10% random bytes. Where the installed files are
missing or too few, Markov text and random bytes stand in, so the same
call can give different bytes on two machines: ``real_text_split`` says
how many of the real-text bytes came from files.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

WORDS = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps  ", b"over\n", b"lazy ", b"dog. "]
REAL_TEXT_SHARE = 0.40
# The directory NumPy is installed in: its sources and its neighbours' are
# the real text, one of its extension modules the binary part.
SITE_PACKAGES = str(Path(np.__file__).parent.parent)
LICENCE_TEXT = "/THIRD_PARTY_NOTICES/LICENSES.txt"


def make_text(nbytes: int, seed: int) -> bytes:
    r = np.random.default_rng(seed)
    parts = []
    size = 0
    while size < nbytes:
        w = WORDS[int(r.integers(len(WORDS)))]
        parts.append(w)
        size += len(w)
    return b"".join(parts)[:nbytes]


def _file_text(nbytes: int) -> bytes:
    """Installed English/legal/source text, no repetition: at least
    ``nbytes`` of it where the files suffice."""
    pools = []
    if os.path.exists(LICENCE_TEXT):
        with open(LICENCE_TEXT, "rb") as f:
            pools.append(f.read())
    src = []
    size = 0
    seen: set[str] = set()
    # Widening pool ladder: NumPy's sources first, then a second package's,
    # then every installed .py. Paths dedupe so nothing repeats (repetition
    # flatters compressors).
    for pat in (f"{SITE_PACKAGES}/numpy/**/*.py",
                f"{SITE_PACKAGES}/jax/_src/*.py",
                f"{SITE_PACKAGES}/**/*.py"):
        if size > nbytes:
            break
        for p in sorted(glob.glob(pat, recursive=True)):
            if p in seen:
                continue
            seen.add(p)
            try:
                with open(p, "rb") as f:
                    src.append(f.read())
            except OSError:
                continue
            size += len(src[-1])
            if size > nbytes:
                break
    pools.append(b"".join(src))
    return b"".join(pools)


def _real_text(nbytes: int) -> bytes:
    blob = _file_text(nbytes)
    if len(blob) < nbytes:  # pad with Markov text, never by repetition
        blob += make_text(nbytes - len(blob), 7)
    return blob[:nbytes]


def real_text_split(corpus_bytes: int) -> tuple[int, int]:
    """(bytes from installed files, bytes of Markov fallback) in the
    real-text part of ``make_mixed_corpus(corpus_bytes)``."""
    want = int(corpus_bytes * REAL_TEXT_SHARE)
    from_files = min(len(_file_text(want)), want)
    return from_files, want - from_files


def _binary(nbytes: int) -> bytes:
    for p in sorted(glob.glob(f"{SITE_PACKAGES}/numpy/_core/*.so")):
        with open(p, "rb") as f:
            b = f.read()
        if len(b) >= nbytes:
            return b[:nbytes]
    return np.random.default_rng(3).integers(0, 256, nbytes, dtype=np.uint8).tobytes()


def _runs(nbytes: int, seed: int) -> bytes:
    r = np.random.default_rng(seed)
    vals = r.integers(0, 16, 4096, dtype=np.uint8)
    lens = r.integers(1, 600, 4096)
    return np.repeat(vals, lens).tobytes()[:nbytes]


def make_mixed_corpus(nbytes: int) -> bytes:
    """Silesia-style deterministic mix: 40% real text, 15% binary, 20%
    Markov text, 15% structured runs, 10% random."""
    spec = [
        (REAL_TEXT_SHARE, _real_text),
        (0.15, _binary),
        (0.20, lambda n: make_text(n, 11)),
        (0.15, lambda n: _runs(n, 13)),
        (0.10, lambda n: np.random.default_rng(17).integers(0, 256, n, dtype=np.uint8).tobytes()),
    ]
    blob = b"".join(fn(int(nbytes * frac)) for frac, fn in spec)
    if len(blob) < nbytes:
        blob += make_text(nbytes - len(blob), 19)
    return blob[:nbytes]
