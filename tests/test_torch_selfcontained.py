"""bz2tpu_torch stands alone: no module of the port, and neither
chip_smoke.py nor the port's tools/profile_compress.py and
tools/time_dec_chain.py, imports bz2tpu or the JAX
package's bench.py; importing them loads neither bz2tpu nor JAX, a fresh
copy builds its host C library under its own build/ directory, and each
copy of a bz2tpu host layer (the benchmark corpus included) agrees with
its original.
"""

import ast
import bz2 as stdlib_bz2
import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench
from bz2tpu import native as jax_native
from bz2tpu.format import bitio as jax_bitio
from bz2tpu.format import constants as jax_constants
from bz2tpu.format import crc32 as jax_crc32
from bz2tpu.oracle import decoder as jax_decoder
from bz2tpu.oracle import encoder as jax_encoder
from bz2tpu.runtime import compressor as jax_compressor
from bz2tpu.runtime import decompressor as jax_decompressor
from bz2tpu_torch import native
from bz2tpu_torch.format import bitio, constants, crc32
from bz2tpu_torch.oracle import decoder, encoder
from bz2tpu_torch.runtime import compressor, decompressor
from bz2tpu_torch.utils import corpus

from conftest import make_corpus
from test_randomised import craft_randomised_stream

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "bz2tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_compress.py", ROOT / "tools" / "time_dec_chain.py"]
JAX_SIDE = ("bz2tpu", "bench")  # the JAX package and its benchmark script


def _imports_of_bz2tpu(path: Path) -> list[str]:
    """Every import of bz2tpu, bz2tpu.* or bench in the file, at any depth."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [f"{path.name}:{node.lineno} {n}" for n in names if n.split(".")[0] in JAX_SIDE]
    return found


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_bz2tpu(path):
    assert _imports_of_bz2tpu(path) == []


def test_the_scan_sees_nested_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def f():\n    if True:\n        from bz2tpu.format import constants\n    import bz2tpu_torch\n"
                 "    import bench\n    from bench import make_mixed_corpus\n    import benchmarks\n")
    assert sorted(_imports_of_bz2tpu(f)) == ["m.py:3 bz2tpu.format", "m.py:5 bench", "m.py:6 bench"]


_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import bz2tpu_torch
for m in pkgutil.walk_packages(bz2tpu_torch.__path__, "bz2tpu_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
import chip_smoke
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bz2tpu", "bench"))
print("LOADED", loaded)
print("NATIVE", bz2tpu_torch.native.HAVE_NATIVE, bz2tpu_torch.native.library_path())
"""


def _run(code: str, cwd: Path) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_importing_the_port_loads_neither_jax_nor_bz2tpu():
    out = _run(_IMPORT_ALL.format(root=str(ROOT)), ROOT)
    assert "LOADED []" in out
    assert "NATIVE True" in out


def test_fresh_copy_builds_its_host_library_under_its_own_build_dir(tmp_path):
    shutil.copytree(ROOT / "bz2tpu_torch", tmp_path / "bz2tpu_torch", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run(_IMPORT_ALL.format(root=str(tmp_path)), tmp_path)
    assert "LOADED []" in out
    assert f"NATIVE True {tmp_path / 'build' / 'bz2tpu_torch'}" in out
    written = {p.relative_to(tmp_path).parts[0] for p in tmp_path.rglob("*") if "__pycache__" not in p.parts}
    assert written == {"bz2tpu_torch", "chip_smoke.py", "build"}


# --- parity of each copy with its original -----------------------------


def test_corpus_matches():
    assert corpus.WORDS == bench.WORDS
    assert corpus.make_mixed_corpus(1_000_000) == bench.make_mixed_corpus(1_000_000)
    assert corpus.make_text(5000, 3) == bench.make_text(5000, 3)
    assert corpus._runs(70_000, 13) == bench._runs(70_000, 13)
    from_files, from_markov = corpus.real_text_split(1_000_000)
    assert from_files + from_markov == 400_000


def test_corpus_falls_back_to_markov_text_without_installed_files(monkeypatch, tmp_path):
    monkeypatch.setattr(corpus, "SITE_PACKAGES", str(tmp_path))
    monkeypatch.setattr(corpus, "LICENCE_TEXT", str(tmp_path / "none.txt"))
    assert corpus.real_text_split(100_000) == (0, 40_000)
    blob = corpus.make_mixed_corpus(100_000)
    assert len(blob) == 100_000
    assert blob[:40_000] == corpus.make_text(40_000, 7)


def test_constants_match():
    names = [n for n in dir(jax_constants) if not n.startswith("_") and n.isupper()]
    assert names
    for n in names:
        assert getattr(constants, n) == getattr(jax_constants, n), n
    for level in range(1, 10):
        assert constants.block_capacity(level) == jax_constants.block_capacity(level)
    for n_sym in (0, 199, 200, 600, 1199, 2400, 10**6):
        assert constants.table_count_for_symbols(n_sym) == jax_constants.table_count_for_symbols(n_sym)


@pytest.mark.parametrize("size", [0, 1, 255, 2048, 4096, 100_003])
def test_crc32_matches(rng, size):
    np.testing.assert_array_equal(crc32.CRC32_TABLE, jax_crc32.CRC32_TABLE)
    data = rng.integers(0, 256, size, dtype=np.uint8)
    assert crc32.crc32(data) == jax_crc32.crc32(data) == jax_crc32.crc32_serial(data)
    crcs = rng.integers(0, 1 << 32, size % 50 + 1).tolist()
    assert crc32.stream_crc(crcs) == jax_crc32.stream_crc(crcs)
    np.testing.assert_array_equal(crc32.shift_operator(size), jax_crc32.shift_operator(size))
    np.testing.assert_array_equal(crc32._op_shift_one_byte(), jax_crc32._op_shift_one_byte())


def _write(mod, ops) -> tuple[bytes, int]:
    w = mod.BitWriter()
    for kind, n, v in ops:
        if kind == "bits":
            w.write_bits(n, v)
        else:
            w.write_unary(v)
    return w.getvalue(), w.bit_length


def test_bitio_matches(rng):
    ops = [("bits", int(n), int(rng.integers(0, 1 << 40)) & ((1 << int(n)) - 1)) for n in rng.integers(0, 33, 300)]
    ops += [("unary", 0, int(v)) for v in rng.integers(0, 6, 50)]
    got, want = _write(bitio, ops), _write(jax_bitio, ops)
    assert got == want
    r, jr = bitio.BitReader(got[0]), jax_bitio.BitReader(got[0])
    for n in rng.integers(0, 25, 200):
        if r.bits_remaining < 25:
            break
        assert r.read_bits(int(n)) == jr.read_bits(int(n))
    assert r.bit_position == jr.bit_position
    parts = [(rng.integers(0, 256, (b + 7) // 8, dtype=np.uint8), int(b)) for b in rng.integers(0, 200, 12)]
    got_cat, want_cat = bitio.concat_bitstreams(parts), jax_bitio.concat_bitstreams(parts)
    np.testing.assert_array_equal(got_cat[0], want_cat[0])
    assert got_cat[1] == want_cat[1]


_SPLIT_INPUTS = {
    "empty": lambda rng: b"",
    "one-byte": lambda rng: b"x",
    "runs": lambda rng: make_corpus(rng, "runs", 300_000),
    "mixed": lambda rng: make_corpus(rng, "text", 150_000) + make_corpus(rng, "random", 80_000)
    + bytes(1000) + make_corpus(rng, "runs", 60_000),
}


def _same_blocks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
        assert (g.raw_length, g.crc) == (w.raw_length, w.crc)


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("kind", list(_SPLIT_INPUTS))
def test_split_blocks_matches(rng, kind, level):
    data = _SPLIT_INPUTS[kind](rng)
    want = jax_compressor.split_blocks(data, level)
    _same_blocks(compressor.split_blocks(data, level), want)
    # The NumPy fallback, as without the native core.
    arr = np.frombuffer(data, np.uint8)
    _same_blocks(encoder.rle1_split(arr, level), want)
    _same_blocks(encoder.rle1_split(arr, level), jax_encoder.rle1_split(arr, level))


@functools.cache
def _streams() -> dict[str, bytes]:
    rng = np.random.default_rng(7)
    text = make_corpus(rng, "text", 120_000)
    big = make_corpus(rng, "text", 900_000) + make_corpus(rng, "random", 300_000)
    good = stdlib_bz2.compress(text, 1)
    corrupt = bytearray(stdlib_bz2.compress(make_corpus(rng, "text", 60_000), 1))
    corrupt[-7] ^= 0x01  # inside the stream CRC
    flipped = bytearray(good)
    flipped[len(flipped) // 2] ^= 0x20
    return {
        "stdlib-1": good,
        "stdlib-9-parallel": stdlib_bz2.compress(big, 9),
        "multi-member": stdlib_bz2.compress(text[:50_000], 9) + stdlib_bz2.compress(text[50_000:], 2),
        "randomised": craft_randomised_stream(make_corpus(rng, "text", 20_000)),
        "truncated": good[: len(good) // 2],
        "truncated-header": good[:20],
        "crc-corrupt": bytes(corrupt),
        "bit-flipped": bytes(flipped),
        "empty": b"",
    }


_STREAM_CASES = ["stdlib-1", "stdlib-9-parallel", "multi-member", "randomised", "truncated",
                 "truncated-header", "crc-corrupt", "bit-flipped", "empty"]
# The NumPy decoder walks symbols in Python: the 1.2 MB stream stays native.
_DECODE_CASES = [(c, False) for c in _STREAM_CASES] + [(c, True) for c in _STREAM_CASES if c != "stdlib-9-parallel"]


@pytest.mark.parametrize("case,fallback", _DECODE_CASES, ids=[f"{c}-{'numpy' if f else 'native'}" for c, f in _DECODE_CASES])
def test_decompress_matches(monkeypatch, case, fallback):
    stream = _streams()[case]
    assert set(_streams()) == set(_STREAM_CASES)
    if fallback:
        monkeypatch.setattr(native, "HAVE_NATIVE", False)
        monkeypatch.setattr(jax_native, "HAVE_NATIVE", False)
    try:
        want = jax_decompressor.decompress(stream)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            decompressor.decompress(stream)
        # The port raises its own class; bz2tpu raises the namesake.
        name = type(got.value).__name__
        assert type(got.value) is getattr(decoder, name)
        assert type(e) is getattr(jax_decoder, name)
        assert issubclass(decoder.Bz2FormatError, (ValueError, OSError))
        return
    assert decompressor.decompress(stream) == want


# --- copies of the stream, file and utils layer ------------------------


def _atomic_run(atomic_output, target: Path) -> list:
    """What atomic_output leaves behind: after a clean write, and after a
    write that raised."""
    seen = []
    with atomic_output(str(target)) as f:
        f.write(b"hello")
        seen.append(target.exists())
    seen.append((target.read_bytes(), sorted(p.name for p in target.parent.iterdir())))
    with pytest.raises(RuntimeError):
        with atomic_output(str(target)) as f:
            f.write(b"partial")
            raise RuntimeError("boom")
    seen.append((target.read_bytes(), sorted(p.name for p in target.parent.iterdir())))
    return seen


def test_atomic_output_matches(tmp_path):
    from bz2tpu.utils.atomic import atomic_output as jax_atomic_output
    from bz2tpu_torch.utils.atomic import atomic_output

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _atomic_run(atomic_output, tmp_path / "port" / "out.bin")
    assert got == _atomic_run(jax_atomic_output, tmp_path / "jax" / "out.bin")
    assert got == [False, (b"hello", ["out.bin"]), (b"hello", ["out.bin"])]


def test_metrics_match():
    from bz2tpu.utils import metrics as jax_metrics
    from bz2tpu_torch.utils import metrics

    runs = []
    for mod in (metrics, jax_metrics):
        m = mod.RunMetrics(op="compress", level=9)
        m.input_bytes, m.output_bytes, m.blocks, m.batches = 16_000_000, 3_984_928, 16, 3
        m.seconds = 0.4321
        m.stage_seconds = {"rle1_split": 0.01234, "device_encode": 0.3, "stitch": 0.0456}
        with m.stage("stitch"):
            pass
        m.stage_seconds["stitch"] = 0.0456  # the clock's reading differs between the two
        runs.append((m.to_dict(), m.to_json(), m.ratio, m.mb_per_s))
    assert runs[0] == runs[1]
    for table in ({1: 2.0, 2: 3.6, 4: 6.4}, {2: 5.0}, {1: 0.0, 2: 1.0}, {}):
        assert metrics.scaling_efficiency(table) == jax_metrics.scaling_efficiency(table)
    c = metrics.Clock()
    assert c.elapsed() >= 0


def test_bit_stitcher_matches():
    import io

    from bz2tpu.runtime.stream import BitStitcher as JaxBitStitcher
    from bz2tpu_torch.runtime.stream import BitStitcher

    rng = np.random.default_rng(602)
    # Zero-padded parts of 0-300 bits, empty ones and whole bytes among them.
    parts = []
    for nbits in [*rng.integers(0, 300, 40).tolist(), 0, 8, 16, 1, 7]:
        buf = rng.integers(0, 256, (nbits + 7) // 8 + 2, dtype=np.uint8)
        buf[(nbits + 7) // 8 :] = 0
        if nbits % 8:
            buf[nbits // 8] &= np.uint8((0xFF << (8 - nbits % 8)) & 0xFF)
        parts.append((buf, nbits))
    sinks = []
    for cls in (BitStitcher, JaxBitStitcher):
        sink = io.BytesIO()
        st = cls(sink)
        states = []
        for data, nbits in parts:
            st.append(data, nbits)
            states.append((st._carry, st._carry_bits, st.bits_written, len(sink.getvalue())))
        st.finish()
        sinks.append((sink.getvalue(), states, st.bits_written))
    assert sinks[0] == sinks[1]
    want, total = bitio.concat_bitstreams(parts)
    assert sinks[0][0] == want.tobytes()


@pytest.mark.parametrize("kind", ["text", "random", "runs", "zeros", "alternating"])
def test_oracle_compress_matches(kind):
    from bz2tpu.oracle import compress as jax_oracle_compress
    from bz2tpu.oracle import decompress as jax_oracle_decompress
    from bz2tpu_torch import oracle

    rng = np.random.default_rng(603)
    data = make_corpus(rng, kind, 12_000)
    out = oracle.compress(data, level=1)
    assert out == jax_oracle_compress(data, level=1)
    assert oracle.decompress(out) == jax_oracle_decompress(out) == data
    assert stdlib_bz2.decompress(out) == data
