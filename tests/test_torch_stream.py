"""bz2tpu_torch.runtime.stream against bz2tpu.runtime.stream on JAX-CPU:
the bit stitcher, compress_stream and compress_file byte-identical to
bz2tpu's and to bz2tpu_torch.compress, StreamCompressor's checkpoints
resumed within the port and across the two packages in both directions,
and the device rule. Tolerance 0 throughout: the codec is integer.

Each test draws its data from its own seeded generator.
"""

import bz2 as stdlib_bz2
import io
import json

import numpy as np
import pytest
import torch

import bz2tpu_torch
from bz2tpu.format.bitio import BitWriter, concat_bitstreams
from bz2tpu_torch.runtime import compressor, stream
from bz2tpu_torch.utils.metrics import RunMetrics

from conftest import make_corpus

pytest.importorskip("jax")
from bz2tpu.runtime import stream as jax_stream  # noqa: E402
from bz2tpu.utils.metrics import RunMetrics as JaxRunMetrics  # noqa: E402

# One batch width for every JAX call, so the worker compiles its shapes once.
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


def _port_stream(data: bytes, level: int = 1, chunk_blocks: int = 2, metrics=None) -> bytes:
    sink = io.BytesIO()
    stream.compress_stream(io.BytesIO(data), sink, level=level, parallel=PARALLEL,
                           chunk_blocks=chunk_blocks, metrics=metrics, device="cpu")
    return sink.getvalue()


def _jax_stream(data: bytes, level: int = 1, chunk_blocks: int = 2, metrics=None) -> bytes:
    sink = io.BytesIO()
    jax_stream.compress_stream(io.BytesIO(data), sink, level=level, parallel=PARALLEL,
                               chunk_blocks=chunk_blocks, metrics=metrics)
    return sink.getvalue()


def test_stitcher_matches_concat():
    rng = np.random.default_rng(601)
    parts = []
    for _ in range(20):
        nbits = int(rng.integers(1, 200))
        w = BitWriter()
        for _ in range(nbits):
            w.write_bit(int(rng.integers(2)))
        parts.append((np.frombuffer(w.getvalue(), np.uint8), w.bit_length))
    want, _ = concat_bitstreams(parts)
    sink = io.BytesIO()
    st = stream.BitStitcher(sink)
    for data, nbits in parts:
        st.append(data, nbits)
    st.finish()
    np.testing.assert_array_equal(np.frombuffer(sink.getvalue(), np.uint8), want)


@pytest.mark.parametrize("chunk_blocks", [1, 2])
def test_compress_stream_matches_jax_and_compress(chunk_blocks):
    # 350 kB of text at level 1: 4 blocks in rounds of 1 or 2 blocks, the
    # trailing block of each round held back.
    rng = np.random.default_rng(610 + chunk_blocks)
    data = make_corpus(rng, "text", 350_000)
    m, jm = RunMetrics(), JaxRunMetrics()
    got = _port_stream(data, chunk_blocks=chunk_blocks, metrics=m)
    assert got == _jax_stream(data, chunk_blocks=chunk_blocks, metrics=jm)
    assert got == bz2tpu_torch.compress(data, level=1, parallel=PARALLEL, device="cpu")
    assert stdlib_bz2.decompress(got) == data
    assert (m.blocks, m.batches, m.level) == (jm.blocks, jm.batches, jm.level) == (4, m.batches, 1)
    assert set(m.stage_seconds) == {"rle1_split", "device_encode", "stitch"}


def test_compress_file_matches_jax_and_compress(tmp_path):
    # Long runs that cross the held-back block boundary re-split cleanly.
    rng = np.random.default_rng(620)
    data = b"a" * 150_000 + make_corpus(rng, "runs", 100_000) + make_corpus(rng, "text", 150_000)
    src = tmp_path / "in.dat"
    src.write_bytes(data)
    m = RunMetrics()
    stream.compress_file(str(src), str(tmp_path / "port.bz2"), level=1, parallel=PARALLEL,
                         metrics=m, device="cpu")
    jax_stream.compress_file(str(src), str(tmp_path / "jax.bz2"), level=1, parallel=PARALLEL)
    got = (tmp_path / "port.bz2").read_bytes()
    assert got == (tmp_path / "jax.bz2").read_bytes()
    assert got == bz2tpu_torch.compress(data, level=1, parallel=PARALLEL, device="cpu")
    assert stdlib_bz2.decompress(got) == data
    assert m.blocks >= 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.dat", "jax.bz2", "port.bz2"]


@pytest.mark.parametrize("data,level", [(b"", 9), (b"tiny", 9), (b"x" * 1000, 1)],
                         ids=["empty", "tiny", "one-run"])
def test_compress_stream_small_inputs(data, level):
    got = _port_stream(data, level=level)
    assert got == bz2tpu_torch.compress(data, level=level, device="cpu")
    assert stdlib_bz2.decompress(got) == data


@pytest.mark.parametrize("device_stitch", [True, False], ids=["concat", "per-block"])
def test_stream_encodes_through_encode_parts(device_stitch, monkeypatch):
    # 4 level-1 blocks, read two blocks' capacity at a time: two rounds of
    # 2 blocks, each one encode_parts call.
    rng = np.random.default_rng(650)
    data = make_corpus(rng, "text", 350_000)
    monkeypatch.setattr(compressor, "_DEVICE_STITCH", device_stitch)
    calls = []
    real = compressor.encode_parts

    def counted(batches, *a, **k):
        batches = list(batches)
        calls.append(sum(map(len, batches)))
        return real(batches, *a, **k)

    monkeypatch.setattr(compressor, "encode_parts", counted)
    got = _port_stream(data)
    assert calls == [2, 2]
    assert got == bz2tpu_torch.compress(data, level=1, parallel=PARALLEL, device="cpu")
    assert stdlib_bz2.decompress(got) == data


def test_compress_file_failure_leaves_no_output(tmp_path, monkeypatch):
    src = tmp_path / "in.dat"
    src.write_bytes(b"abc" * 1000)

    def boom(*args, **kwargs):
        raise RuntimeError("encode failed")

    monkeypatch.setattr(compressor, "_encode", boom)
    with pytest.raises(RuntimeError, match="encode failed"):
        stream.compress_file(str(src), str(tmp_path / "out.bz2"), level=1, device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == ["in.dat"]


# --- checkpoint / resume -----------------------------------------------


def _first_session(cls, data: bytes, cut: int, **device):
    """Feed data[:cut], checkpoint, and drop the compressor unclosed."""
    sink = io.BytesIO()
    sc = cls(sink, level=1, parallel=PARALLEL, chunk_blocks=1, **device)
    sc.write(data[:cut])
    state = sc.checkpoint()
    assert sc.input_offset == cut
    return state, sink.getvalue()


def _second_session(cls, state: bytes, emitted: bytes, rest: bytes, **device) -> bytes:
    """Truncate the sink to the checkpoint, resume, feed the rest, close."""
    keep = cls.state_sink_bytes(state)
    assert keep <= len(emitted)
    sink = io.BytesIO()
    sink.write(emitted[:keep])
    sc = cls(sink, parallel=PARALLEL, chunk_blocks=1, state=state, **device)
    sc.write(rest)
    sc.close()
    return sink.getvalue()


CPU = {"device": "cpu"}


@pytest.mark.parametrize("direction", ["port-to-port", "jax-to-port", "port-to-jax"])
def test_kill_and_resume_bit_identical(direction):
    rng = np.random.default_rng(630)
    data = make_corpus(rng, "text", 250_000) + make_corpus(rng, "runs", 100_000)
    want = _port_stream(data, chunk_blocks=1)
    assert stdlib_bz2.decompress(want) == data
    cut = 210_000  # past the first encode round: carry bits and a CRC to hand over
    first, second = direction.split("-to-")
    pkg = {"port": (stream.StreamCompressor, CPU), "jax": (jax_stream.StreamCompressor, {})}
    cls1, dev1 = pkg[first]
    cls2, dev2 = pkg[second]
    state, emitted = _first_session(cls1, data, cut, **dev1)
    st = json.loads(state)
    assert st["v"] == 1 and st["n_blocks"] >= 1 and st["carry_bits"] > 0
    got = _second_session(cls2, state, emitted, data[cut:], **dev2)
    assert got == want


def test_fresh_checkpoints_are_identical_across_packages():
    # Below the first encode round both compressors hold the same state:
    # the blob is the same bytes, key for key.
    data = b"checkpoint me " * 1000
    port = stream.StreamCompressor(io.BytesIO(), level=3, device="cpu")
    jax = jax_stream.StreamCompressor(io.BytesIO(), level=3)
    port.write(data)
    jax.write(data)
    assert port.checkpoint() == jax.checkpoint()
    assert stream.StreamCompressor.state_sink_bytes(port.checkpoint()) == 4  # "BZh3"


def test_checkpoint_every_write_still_identical():
    rng = np.random.default_rng(640)
    data = make_corpus(rng, "text", 300_000)
    want = _port_stream(data, chunk_blocks=2)
    sink = io.BytesIO()
    sc = stream.StreamCompressor(sink, level=1, parallel=PARALLEL, chunk_blocks=2, device="cpu")
    state = None
    for off in range(0, len(data), 61_000):
        sc.write(data[off : off + 61_000])
        state = sc.checkpoint()
    keep = stream.StreamCompressor.state_sink_bytes(state)
    sink2 = io.BytesIO()
    sink2.write(sink.getvalue()[:keep])
    sc2 = stream.StreamCompressor(sink2, parallel=PARALLEL, chunk_blocks=2, state=state, device="cpu")
    assert sc2.input_offset == len(data)
    sc2.close()
    assert sink2.getvalue() == want


def test_compressible_input_makes_progress():
    # Zeros RLE1-encode ~51x smaller than raw: write() must not spin when a
    # threshold's worth of raw bytes yields less than one full block.
    sink = io.BytesIO()
    sc = stream.StreamCompressor(sink, level=1, chunk_blocks=1, device="cpu")
    for _ in range(30):
        sc.write(b"\0" * 200_000)  # 6 MB, RLE1 ~120 kB
    sc.close()
    got = sink.getvalue()
    assert got == bz2tpu_torch.compress(bytes(6_000_000), level=1, device="cpu")
    assert stdlib_bz2.decompress(got) == bytes(6_000_000)


def test_bad_checkpoint_version_rejected():
    state = json.dumps({"v": 999}).encode()
    with pytest.raises(ValueError, match="version"):
        stream.StreamCompressor(io.BytesIO(), state=state, device="cpu")


def test_bad_level_rejected():
    with pytest.raises(ValueError, match="1..9"):
        stream.StreamCompressor(io.BytesIO(), level=0, device="cpu")


def test_write_after_close_rejected():
    sc = stream.StreamCompressor(io.BytesIO(), level=1, device="cpu")
    sc.close()
    sc.close()  # idempotent
    with pytest.raises(ValueError, match="after close"):
        sc.write(b"x")


def test_cuda_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.dat"
    src.write_bytes(b"abc")
    for call in (lambda: stream.StreamCompressor(io.BytesIO()),
                 lambda: stream.StreamCompressor(io.BytesIO(), device="cuda"),
                 lambda: stream.compress_stream(io.BytesIO(b"abc"), io.BytesIO()),
                 lambda: stream.compress_file(str(src), str(tmp_path / "out.bz2"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert [p.name for p in tmp_path.iterdir()] == ["in.dat"]
