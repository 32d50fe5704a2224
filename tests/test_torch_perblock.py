"""The per-block compress path (BZ2TPU_DEVICE_STITCH=0) on the CPU:
bz2tpu_torch's compress and compress_stream with its _DEVICE_STITCH off,
held byte-identical to the same calls with it on and to bz2tpu's
per-block path on JAX-CPU; compressor._encode_batches row by row against
bz2tpu's; and a StreamCompressor checkpoint taken on one path resumed on
the other, within the port and across the packages. Tolerance 0: the
codec is integer.
"""

import bz2 as stdlib_bz2
import io
import json
from functools import lru_cache

import numpy as np
import pytest
import torch

from bz2tpu_torch.runtime import compressor, stream

from conftest import make_corpus

pytest.importorskip("jax")
from bz2tpu.runtime import compressor as jax_compressor  # noqa: E402
from bz2tpu.runtime import stream as jax_stream  # noqa: E402

LEVEL, PARALLEL = 1, 2  # one JAX batch shape for every call: the worker compiles it once
KINDS = {"text": 601, "runs": 602}  # make_corpus kind -> seed
SCALARS = ("orig_ptr", "n_sym", "n_in_use", "n_groups", "n_selectors", "total_bits")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs in several
    worker processes, and torch's default of one thread a core in each
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@lru_cache(maxsize=None)
def _data(kind: str) -> bytes:
    return make_corpus(np.random.default_rng(KINDS[kind]), kind, 500_000)


@lru_cache(maxsize=None)
def _jax_per_block(kind: str) -> bytes:
    """bz2tpu.compress on its per-block path (its _DEVICE_STITCH off)."""
    saved = jax_compressor._DEVICE_STITCH
    jax_compressor._DEVICE_STITCH = False
    try:
        return jax_compressor.compress(_data(kind), level=LEVEL, parallel=PARALLEL)
    finally:
        jax_compressor._DEVICE_STITCH = saved


def _port(kind: str, per_block: bool, monkeypatch) -> tuple[bytes, bytes]:
    """The port's compress and compress_stream(chunk_blocks=2) streams."""
    monkeypatch.setattr(compressor, "_DEVICE_STITCH", not per_block)
    data = _data(kind)
    one = compressor.compress(data, level=LEVEL, parallel=PARALLEL, device="cpu")
    sink = io.BytesIO()
    stream.compress_stream(io.BytesIO(data), sink, level=LEVEL, parallel=PARALLEL, chunk_blocks=2,
                           device="cpu")
    return one, sink.getvalue()


@pytest.mark.parametrize("kind", list(KINDS))
def test_per_block_matches_concat_and_jax(kind, monkeypatch):
    got = _port(kind, True, monkeypatch)
    want = _jax_per_block(kind)
    assert got == (want, want)
    assert _port(kind, False, monkeypatch) == (want, want)
    assert stdlib_bz2.decompress(want) == _data(kind)


@pytest.mark.parametrize("kind", list(KINDS))
def test_encode_batches_rows_match_jax(kind):
    data = _data(kind)
    blocks = compressor.split_blocks(data, LEVEL)
    # text: 6 blocks, so 3 batches, the last one short; runs: RLE1 folds
    # them into one block.
    assert len(blocks) == {"text": 6, "runs": 1}[kind]
    got = list(compressor._encode_batches(blocks, PARALLEL, "cpu"))
    want = list(jax_compressor._encode_batches(jax_compressor.split_blocks(data, LEVEL),
                                               LEVEL * 100_000, PARALLEL))
    assert len(got) == len(want) == len(blocks)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        assert {k: g[k] for k in SCALARS} == {k: int(w[k]) for k in SCALARS}, i
        assert g["words"].dtype == np.uint32 and g["words"].size == (g["total_bits"] + 31) // 32, i
        np.testing.assert_array_equal(g["words"], w["words"][: g["words"].size], err_msg=f"row {i}")


@pytest.mark.parametrize("kind", list(KINDS))
def test_encode_batches_timings(kind):
    steps = {}
    rows = list(compressor._encode_batches(compressor.split_blocks(_data(kind), LEVEL), PARALLEL, "cpu",
                                           timings=steps))
    assert rows and list(steps) == ["bwt", "mtf", "rle2_out", "huffman", "pack", "fetch"]


def _compressor(pkg: str, per_block: bool, monkeypatch, **kw):
    """A StreamCompressor of ``pkg`` ("port" or "jax") on the per-block or
    the concat path."""
    if pkg == "port":
        monkeypatch.setattr(compressor, "_DEVICE_STITCH", not per_block)
        return stream.StreamCompressor(device="cpu", parallel=PARALLEL, chunk_blocks=1, **kw)
    monkeypatch.setattr(jax_compressor, "_DEVICE_STITCH", not per_block)
    return jax_stream.StreamCompressor(parallel=PARALLEL, chunk_blocks=1, **kw)


# (first compressor, resumed compressor): package and path of each.
RESUMES = [("port", True, "port", False), ("port", False, "port", True),
           ("jax", False, "port", True), ("port", True, "jax", True)]


@pytest.mark.parametrize("first_pkg,first_per_block,second_pkg,second_per_block", RESUMES,
                         ids=["port-perblock-to-concat", "port-concat-to-perblock",
                              "jax-concat-to-port-perblock", "port-perblock-to-jax-perblock"])
def test_checkpoint_resumes_on_the_other_path(first_pkg, first_per_block, second_pkg, second_per_block,
                                              monkeypatch):
    rng = np.random.default_rng(630)
    data = make_corpus(rng, "text", 250_000) + make_corpus(rng, "runs", 100_000)
    cut = 210_000  # past the first encode round: carry bits and a CRC to hand over
    monkeypatch.setattr(compressor, "_DEVICE_STITCH", True)
    whole = io.BytesIO()
    stream.compress_stream(io.BytesIO(data), whole, level=LEVEL, parallel=PARALLEL, chunk_blocks=1,
                           device="cpu")

    sink = io.BytesIO()
    sc = _compressor(first_pkg, first_per_block, monkeypatch, sink=sink, level=LEVEL)
    sc.write(data[:cut])
    state = sc.checkpoint()
    st = json.loads(state)
    assert st["v"] == 1 and st["n_blocks"] >= 1 and st["carry_bits"] > 0
    keep = stream.StreamCompressor.state_sink_bytes(state)
    resumed = io.BytesIO()
    resumed.write(sink.getvalue()[:keep])
    sc = _compressor(second_pkg, second_per_block, monkeypatch, sink=resumed, state=state)
    sc.write(data[cut:])
    sc.close()
    assert resumed.getvalue() == whole.getvalue()
    assert stdlib_bz2.decompress(resumed.getvalue()) == data
