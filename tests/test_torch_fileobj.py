"""bz2tpu_torch's file and stream-decode layer against bz2tpu's on the
same inputs: BZ2File / open (stdlib-bz2 parity, writes on the CPU path
byte-identical to bz2tpu's on JAX-CPU), StreamDecompressor,
decompress_file and recover, on well-formed, multi-member, truncated,
CRC-corrupt, bit-flipped, empty and trailing-junk streams, with the same
results or the same error classes. Tolerance 0 throughout.

The read paths are host code over the native C core and take no device.
Each test draws its data from its own seeded generator.
"""

import bz2 as stdlib_bz2
import functools
import io

import numpy as np
import pytest
import torch

import bz2tpu_torch
from bz2tpu import native as jax_native
from bz2tpu.runtime import decompressor as jax_decompressor
from bz2tpu.runtime import fileobj as jax_fileobj
from bz2tpu_torch import native
from bz2tpu_torch.oracle import decoder
from bz2tpu_torch.runtime import decompressor

from conftest import make_corpus
from test_torch_selfcontained import _streams as _selfcontained_streams

PARALLEL = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs in several
    worker processes, and torch's default of one thread a core in each
    oversubscribes the machine and slows every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _streams() -> dict[str, bytes]:
    rng = np.random.default_rng(660)
    a = make_corpus(rng, "text", 120_000)
    b = make_corpus(rng, "runs", 60_000)
    good = stdlib_bz2.compress(a, 1)
    second = bytearray(stdlib_bz2.compress(b, 1))
    for off in range(10, 200, 17):
        second[off] ^= 0xFF
    return {
        **_selfcontained_streams(),
        "members-parallel": b"".join(stdlib_bz2.compress(a[i::3], 1) for i in range(3)),
        "trailing-junk": good + b"not a stream",
        "trailing-magic-junk": good + b"BZh1" + bytes(32),
        "truncated-magic": good + b"BZ",
        "corrupt-second-member": good + bytes(second),
        "truncated-second-member": good + stdlib_bz2.compress(b, 1)[:20],
    }


_CASES = ["stdlib-1", "stdlib-9-parallel", "multi-member", "members-parallel", "randomised", "truncated",
          "truncated-header", "crc-corrupt", "bit-flipped", "empty", "trailing-junk", "trailing-magic-junk",
          "truncated-magic", "corrupt-second-member", "truncated-second-member"]


def _outcome(fn):
    """fn()'s value, or the name and message of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return ("raised", type(e).__name__, str(e))


def _same(got, want):
    assert got == want
    if got[0] == "raised" and got[1].startswith("Bz2"):
        # The port raises its own class, bz2tpu the namesake.
        assert issubclass(getattr(decoder, got[1]), (ValueError, OSError))


def _push(cls, stream: bytes, chunk: int):
    d = cls()
    out = [d.decompress(stream[i : i + chunk]) for i in range(0, len(stream), chunk)]
    return b"".join(out), d.eof, d.unused_data, d.needs_input


def _decode_file(fn, stream: bytes, tmp_path, name: str):
    src = tmp_path / f"{name}.bz2"
    src.write_bytes(stream)
    dst = tmp_path / f"{name}.out"
    res = _outcome(lambda: fn(str(src), str(dst)))
    if res[0] == "ok":
        return ("ok", dst.read_bytes())
    assert not dst.exists()  # nothing left behind on failure
    return res


def test_case_list_is_complete():
    assert set(_streams()) == set(_CASES)


@pytest.mark.parametrize("chunk", [4096, 1 << 20])
@pytest.mark.parametrize("case", _CASES)
def test_stream_decompressor_matches(case, chunk):
    stream = _streams()[case]
    _same(_outcome(lambda: _push(decompressor.StreamDecompressor, stream, chunk)),
          _outcome(lambda: _push(jax_decompressor.StreamDecompressor, stream, chunk)))


@pytest.mark.parametrize("case", _CASES)
def test_decompress_file_matches(case, tmp_path):
    stream = _streams()[case]
    got = _decode_file(decompressor.decompress_file, stream, tmp_path, "port")
    _same(got, _decode_file(jax_decompressor.decompress_file, stream, tmp_path, "jax"))
    if got[0] == "ok":
        assert got[1] == decompressor.decompress(stream)


@pytest.mark.parametrize("case", _CASES)
def test_recover_matches(case):
    stream = _streams()[case]
    _same(_outcome(lambda: decompressor.recover(stream)), _outcome(lambda: jax_decompressor.recover(stream)))


@pytest.mark.parametrize("case", _CASES)
def test_bz2file_read_matches(case):
    stream = _streams()[case]
    got = _outcome(lambda: bz2tpu_torch.BZ2File(io.BytesIO(stream)).read())
    _same(got, _outcome(lambda: jax_fileobj.BZ2File(io.BytesIO(stream)).read()))
    # And stdlib, whose semantics both copy.
    want = _outcome(lambda: stdlib_bz2.BZ2File(io.BytesIO(stream)).read())
    assert got[0] == want[0] and (got[0] == "raised" or got[1] == want[1])


def test_decompress_file_without_native_core(tmp_path, monkeypatch):
    # The NumPy whole-buffer fallback, as without a compiler.
    stream = _streams()["multi-member"]
    monkeypatch.setattr(native, "HAVE_NATIVE", False)
    monkeypatch.setattr(jax_native, "HAVE_NATIVE", False)
    got = _decode_file(decompressor.decompress_file, stream, tmp_path, "port")
    assert got == _decode_file(jax_decompressor.decompress_file, stream, tmp_path, "jax")
    assert got == ("ok", stdlib_bz2.decompress(stream))
    with pytest.raises(RuntimeError, match="native"):
        decompressor.recover(stream)
    with pytest.raises(RuntimeError, match="native"):
        decompressor.StreamDecompressor()


def test_recover_damaged_stream():
    # 4-block stream at level 1; the second block's data corrupted.
    rng = np.random.default_rng(670)
    data = make_corpus(rng, "text", 350_000)
    comp = bytearray(stdlib_bz2.compress(data, 1))
    headers, _ = native.scan_blocks(bytes(comp))
    assert len(headers) >= 3
    comp[headers[1] // 8 + 40] ^= 0xFF
    out, ok, total = decompressor.recover(bytes(comp))
    assert (out, ok, total) == jax_decompressor.recover(bytes(comp))
    assert ok == total - 1
    assert data.startswith(out[:50_000]) and data.endswith(out[-50_000:])
    assert decompressor.recover(stdlib_bz2.compress(data, 1)) == (data, total, total)


# --- StreamDecompressor, as tests/test_stream_decompressor.py ------------


@pytest.mark.parametrize("chunk", [7, 1024, 65536])
def test_incremental_matches_one_shot(chunk):
    rng = np.random.default_rng(680)
    data = make_corpus(rng, "text", 150_000)
    comp = stdlib_bz2.compress(data, 1)
    assert _push(decompressor.StreamDecompressor, comp, chunk) == (data, True, b"", False)
    d = decompressor.StreamDecompressor()
    d.decompress(comp)
    with pytest.raises(EOFError):
        d.decompress(b"x")


def test_unused_data_and_eof_parity():
    rng = np.random.default_rng(681)
    data = make_corpus(rng, "runs", 120_000)
    comp = stdlib_bz2.compress(data, 2) + b"TRAILING BYTES"
    ours, ref = decompressor.StreamDecompressor(), stdlib_bz2.BZ2Decompressor()
    assert ours.decompress(comp) == ref.decompress(comp) == data
    assert ours.eof == ref.eof is True
    assert ours.unused_data == ref.unused_data == b"TRAILING BYTES"


def test_incremental_partial_progress():
    rng = np.random.default_rng(682)
    data = make_corpus(rng, "text", 250_000)  # three level-1 blocks
    comp = stdlib_bz2.compress(data, 1)
    d = decompressor.StreamDecompressor()
    half = d.decompress(comp[: len(comp) // 2])
    assert len(half) > 0 and not d.eof and d.needs_input
    assert half + d.decompress(comp[len(comp) // 2 :]) == data
    assert d.eof


def test_incremental_bad_magic():
    with pytest.raises(decoder.Bz2FormatError):
        decompressor.StreamDecompressor().decompress(b"NOTB" + b"Z" * 100)


# --- BZ2File / open, as tests/test_fileobj.py ----------------------------


def test_write_matches_jax_and_stock_reads(tmp_path):
    rng = np.random.default_rng(690)
    data = make_corpus(rng, "text", 250_000)
    paths = {}
    for name, opener, dev in (("port", bz2tpu_torch.open, {"device": "cpu"}), ("jax", jax_fileobj.bz2_open, {})):
        paths[name] = tmp_path / f"{name}.bz2"
        with opener(paths[name], "wb", level=1, parallel=PARALLEL, **dev) as f:
            f.write(data[:100_000])
            assert f.tell() == 100_000
            f.write(data[100_000:])
    got = paths["port"].read_bytes()
    assert got == paths["jax"].read_bytes()
    assert got == bz2tpu_torch.compress(data, level=1, device="cpu")
    assert stdlib_bz2.decompress(got) == data


def test_write_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bz2tpu_torch.open(tmp_path / "f.bz2", "wb")
    assert not (tmp_path / "f.bz2").exists()
    blob = stdlib_bz2.compress(b"read paths need no card", 1)
    assert bz2tpu_torch.BZ2File(io.BytesIO(blob)).read() == b"read paths need no card"


def test_read_stock_stream(tmp_path):
    rng = np.random.default_rng(691)
    data = make_corpus(rng, "text", 300_000)
    p = tmp_path / "f.bz2"
    p.write_bytes(stdlib_bz2.compress(data, 1))
    with bz2tpu_torch.open(p, "rb") as f:
        assert f.read(1000) == data[:1000]
        assert f.read() == data[1000:]
        assert f.read() == b""
        assert f.tell() == len(data)


def test_append_makes_multimember(tmp_path):
    rng = np.random.default_rng(692)
    a = make_corpus(rng, "text", 120_000)
    b = make_corpus(rng, "runs", 80_000)
    p = tmp_path / "f.bz2"
    with bz2tpu_torch.BZ2File(p, "w", level=1, device="cpu") as f:
        f.write(a)
    with bz2tpu_torch.BZ2File(p, "a", level=1, device="cpu") as f:
        f.write(b)
    assert p.read_bytes() == (bz2tpu_torch.compress(a, level=1, device="cpu")
                              + bz2tpu_torch.compress(b, level=1, device="cpu"))
    with stdlib_bz2.open(p) as f:
        assert f.read() == a + b
    with bz2tpu_torch.open(p) as f:
        assert f.read() == a + b


def test_seek_tell_read1_peek():
    rng = np.random.default_rng(693)
    data = make_corpus(rng, "text", 120_000)
    f = bz2tpu_torch.BZ2File(io.BytesIO(stdlib_bz2.compress(data, 1)))
    assert f.seekable()
    assert f.read(5) == data[:5]
    f.seek(0)
    assert f.read(10) == data[:10]
    f.seek(600)
    assert f.read(10) == data[600:610]
    f.seek(100, io.SEEK_CUR)
    assert f.tell() == 710
    assert f.peek()[:5] == data[710:715]
    one = f.read1(5)
    assert one == data[710:715]
    rest = f.read1()
    assert rest == data[715 : 715 + len(rest)] and rest
    f.seek(-5, io.SEEK_END)
    assert f.read() == data[-5:]
    assert f.read1(0) == b""


def test_write_rejects_non_bytes(tmp_path):
    with bz2tpu_torch.open(tmp_path / "f.bz2", "wb", level=1, device="cpu") as f:
        with pytest.raises(TypeError):
            f.write(5)
        with pytest.raises(TypeError):
            f.write("text")


def test_read1_guards():
    f = bz2tpu_torch.BZ2File(io.BytesIO(), "w", level=1, device="cpu")
    with pytest.raises(io.UnsupportedOperation):
        f.read1()
    g = bz2tpu_torch.BZ2File(io.BytesIO(stdlib_bz2.compress(b"x", 1)))
    g.close()
    with pytest.raises(ValueError):
        g.read1()


def test_text_mode_roundtrip(tmp_path):
    p = tmp_path / "t.bz2"
    with bz2tpu_torch.open(p, "wt", level=1, encoding="utf-8", device="cpu") as f:
        f.write("héllo wörld\nline two\n")
    with bz2tpu_torch.open(p, "rt", encoding="utf-8") as f:
        assert f.readline() == "héllo wörld\n"
        assert f.read() == "line two\n"
    with stdlib_bz2.open(p, "rt", encoding="utf-8") as f:
        assert f.read() == "héllo wörld\nline two\n"


def test_exclusive_create(tmp_path):
    p = tmp_path / "x.bz2"
    with bz2tpu_torch.open(p, "xb", level=1, device="cpu") as f:
        f.write(b"abc")
    with pytest.raises(FileExistsError):
        bz2tpu_torch.open(p, "xb", device="cpu")


def test_mode_errors(tmp_path):
    with pytest.raises(ValueError):
        bz2tpu_torch.open(tmp_path / "f", "rwb")
    with pytest.raises(ValueError):
        bz2tpu_torch.open(tmp_path / "f", "rbt")
    with pytest.raises(ValueError):
        bz2tpu_torch.open(io.BytesIO(), "rb", encoding="utf-8")
    f = bz2tpu_torch.BZ2File(io.BytesIO(stdlib_bz2.compress(b"x", 1)))
    with pytest.raises(io.UnsupportedOperation):
        f.write(b"y")


def test_compresslevel_alias(tmp_path):
    rng = np.random.default_rng(694)
    data = make_corpus(rng, "text", 50_000)
    p = tmp_path / "f.bz2"
    with bz2tpu_torch.open(p, "wb", compresslevel=1, device="cpu") as f:
        f.write(data)
    assert p.read_bytes()[:4] == b"BZh1"
    assert stdlib_bz2.decompress(p.read_bytes()) == data


def test_iteration_lines(tmp_path):
    lines = [f"line {i}\n".encode() for i in range(200)]
    p = tmp_path / "f.bz2"
    with bz2tpu_torch.open(p, "wb", level=1, device="cpu") as f:
        f.write(b"".join(lines))
    with bz2tpu_torch.open(p, "rb") as f:
        assert list(f) == lines
