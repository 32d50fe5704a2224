"""bz2tpu_torch's spans and counters (utils/profiling.py) on the CPU.

With no profiler running a span is a shared no-op, so compress and
decompress_device make no profiler call; under torch.profiler every span
of the table in utils/profiling.py shows, nested where it is placed, and
the outputs equal an unprofiled call's. The counters: a compress batch
each batch, a host sync each blocking read (every BWT round's, plus three
a batch), more BWT rounds on a periodic input than on random bytes, and
each reason a stream leaves the device decode on a stream made to leave
for it. Inputs come from numpy seeds.
"""

import bz2 as stdlib_bz2
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bz2tpu_torch
from bz2tpu_torch.runtime import compressor, device_decode
from bz2tpu_torch.utils import profiling
from bz2tpu_torch.utils.profiling import COUNTER_NAMES, SPANS

from conftest import make_corpus

CPU = torch.device("cpu")

# Where each span sits: the innermost bz2.* span around it (None: none).
PARENTS = {
    "bz2.split": {None},
    "bz2.upload": {None},
    "bz2.encode": {None},
    "bz2.bwt": {"bz2.encode"},
    "bz2.mtf": {"bz2.encode"},
    "bz2.rle2_out": {"bz2.encode"},
    "bz2.huffman": {"bz2.encode"},
    "bz2.pack": {"bz2.encode"},
    "bz2.wait": {"bz2.bwt", "bz2.mtf", None},  # ns, each round's active counts; max(n_sym); total bits
    "bz2.fetch": {None},
    "bz2.stitch": {None},
    "bz2.parse": {None},
    "bz2.members": {"bz2.parse"},
}
COMPRESS_SPANS = set(SPANS) - {"bz2.parse", "bz2.members"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (see test_torch_cli)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _delta(fn):
    """fn's result and the counters it moved."""
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _text(seed: int, n: int) -> bytes:
    return make_corpus(np.random.default_rng(seed), "text", n)


def test_spans_off_make_no_profiler_call(monkeypatch):
    data = _text(1601, 120_000)
    stream = stdlib_bz2.compress(data, 1)

    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert stdlib_bz2.decompress(bz2tpu_torch.compress(data, 1, parallel=2, device="cpu")) == data
    assert device_decode.decompress_device(stream, device="cpu") == data


def _spanned(prof) -> list[tuple[str, str | None, int]]:
    """(name, innermost bz2.* span around it on its thread, thread) of
    every bz2.* event, from the profiler's raw events (a tree of every op
    takes many times as long to build). No span is a user annotation,
    which the profiler would mirror on the card's timeline."""
    own = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("bz2.")]
    assert not any(e.is_user_annotation() for e in own)
    spans = sorted((e.start_ns(), -e.duration_ns(), e.name(), e.start_thread_id()) for e in own)
    out = []
    for j, (t0, neg, name, tid) in enumerate(spans):
        around = [n for s0, sneg, n, stid in spans[:j] if stid == tid and s0 - sneg >= t0 - neg]
        out.append((name, around[-1] if around else None, tid))
    return out


@pytest.mark.parametrize("op", ["compress", "decompress"])
def test_spans_under_the_profiler(op):
    data = _text(1602, 110_000)  # two blocks
    if op == "compress":
        call = lambda: bz2tpu_torch.compress(data, 1, parallel=1, device="cpu")  # noqa: E731
        want = COMPRESS_SPANS
    else:
        stream = stdlib_bz2.compress(data, 1)
        call = lambda: device_decode.decompress_device(stream, device="cpu")  # noqa: E731
        want = {"bz2.parse", "bz2.members"}
    plain = call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = call()
    assert traced == plain
    spanned = _spanned(prof)
    names = {name for name, _, _ in spanned}
    assert names <= set(SPANS)  # every bz2.* name comes from the table
    assert names == want
    for name, parent, _ in spanned:
        assert parent in PARENTS[name], (name, parent)
    # On the calling thread, one split (the first batch's: the second is
    # split ahead on the split worker, whose spans torch.profiler's
    # per-thread state does not record) and one stitch a call; a batch's
    # spans once a batch.
    caller = next(tid for name, _, tid in spanned if name in ("bz2.stitch", "bz2.parse"))
    n = {name: sum(s == name and tid == caller for s, _, tid in spanned) for name in names}
    if op == "compress":
        assert n["bz2.split"] == n["bz2.stitch"] == 1
        assert n["bz2.upload"] == n["bz2.encode"] == n["bz2.fetch"] == n["bz2.pack"] == 2  # a batch a block
    else:
        assert n == {"bz2.parse": 1, "bz2.members": 1}


@pytest.mark.parametrize("parallel", [2, 8])
def test_batches_and_host_syncs(parallel):
    data = _text(1603, 330_000)
    blocks = len(compressor.split_blocks(data, 1))
    out, moved = _delta(lambda: bz2tpu_torch.compress(data, 1, parallel=parallel, device="cpu"))
    assert stdlib_bz2.decompress(out) == data
    assert moved["batches"] == math.ceil(blocks / parallel)
    # Every BWT round reads its active counts back; a batch also reads its
    # block lengths, max(n_sym) and its total bits.
    assert moved["host_syncs"] == moved["bwt_rounds"] + 3 * moved["batches"]
    assert not any(k.startswith("decode_fallbacks") for k in moved)


def test_periodic_input_takes_more_bwt_rounds():
    rng = np.random.default_rng(1604)
    periodic = bytes(rng.integers(0, 256, 13, dtype=np.uint8)) * 4_000
    random = rng.integers(0, 256, len(periodic), dtype=np.uint8).tobytes()
    rounds = {}
    for name, data in (("periodic", periodic), ("random", random)):
        out, moved = _delta(lambda: bz2tpu_torch.compress(data, 1, device="cpu"))
        assert stdlib_bz2.decompress(out) == data
        rounds[name] = moved["bwt_rounds"]
    # Identical rotations stay tied until k >= n: one doubling round each
    # power of two; random keys part within a few rounds.
    assert rounds["periodic"] > rounds["random"] >= 1


def _fallback_streams() -> dict:
    data = _text(1605, 60_000)
    good = stdlib_bz2.compress(data, 1)
    second = stdlib_bz2.compress(b"second member", 9)
    randomised = bytearray(good)
    randomised[14] |= 0x80  # the first block's randomised bit (bit 112: magic, marker, CRC)
    # The last bit of the end-of-block code flipped: the decode's end of block
    # misses its end bit.
    last = device_decode.native.scan_blocks(good)[1][0] - 1
    altered = bytearray(good)
    altered[last >> 3] ^= 0x80 >> (last & 7)
    bad_crc = bytearray(good)
    bad_crc[-4] ^= 0x01  # inside the stream CRC, whatever the padding after it
    return {
        "header": [b"BZx9" + good[4:]],
        "scan": [stdlib_bz2.compress(b"")],  # no block at all
        # An empty member between two; junk between two; a cut magic after the last.
        "members": [good + stdlib_bz2.compress(b"") + second, good + b"junk" + second, good + second + b"BZh9"],
        "block": [bytes(randomised)],
        "validate": [bytes(altered)],
        "stream_crc": [good[:-4], bytes(bad_crc)],  # the CRC cut off; a CRC that does not match
    }


@pytest.mark.parametrize("reason", ["no_native", "header", "scan", "members", "block", "validate", "stream_crc"])
def test_decode_fallback_reasons(monkeypatch, reason):
    if reason == "no_native":
        monkeypatch.setattr(device_decode.native, "HAVE_NATIVE", False)
        streams = [stdlib_bz2.compress(_text(1606, 20_000), 1)]
    else:
        streams = _fallback_streams()[reason]
    # A stream that leaves after the card took it counts its block headers
    # and members too.
    parsed = reason in ("validate", "stream_crc")
    for stream in streams:
        got, moved = _delta(lambda: device_decode._decompress_device_inner(stream, True, CPU))
        assert got is None
        headers = len(device_decode.native.scan_blocks(stream)[0]) if parsed else 0
        assert moved.pop("decode_headers", 0) == headers
        assert moved.pop("decode_members", 0) == int(parsed)
        # A stream CRC is checked after every block's inverse RLE1 and CRC
        # ran on the device; a batch that fails validation never gets there.
        assert moved.pop("decode_rle1_device", 0) == (headers if reason == "stream_crc" else 0)
        assert moved == {f"decode_fallbacks.{reason}": 1}
    if reason == "validate":
        # decompress_device hands it to the host decoder, counted once; two
        # members decode on the card.
        with pytest.raises(ValueError):
            device_decode.decompress_device(streams[0], device="cpu")
        data = _text(1605, 60_000)
        two = stdlib_bz2.compress(data, 1) + stdlib_bz2.compress(b"second member", 9)
        out, moved = _delta(lambda: device_decode.decompress_device(two, device="cpu"))
        assert out == data + b"second member"
        assert moved == {"decode_headers": 2, "decode_members": 2, "decode_rle1_device": 2}


def test_decode_headers_count_the_blocks_decoded_on_the_card():
    data = _text(1608, 330_000)
    stream = stdlib_bz2.compress(data, 1)
    headers, _ = device_decode.native.scan_blocks(stream)
    assert len(headers) == 4
    out, moved = _delta(lambda: device_decode.decompress_device(stream, device="cpu"))
    assert out == data
    assert moved == {"decode_headers": len(headers), "decode_members": 1, "decode_rle1_device": len(headers)}


def test_counters_snapshot():
    snap = profiling.counters()
    assert set(COUNTER_NAMES) <= set(snap)
    launches = {k for k in snap if k.startswith("launches.")}
    assert {"launches.bwt_sort", "launches.bwt_rerank", "launches.mtf_ranks", "launches.huffman_plan",
            "launches.dec_chain", "launches.dec_symbols", "launches.mtf_dec", "launches.crc_ranges",
            "launches.block_cuts", "launches.rle1_dec"} == launches
    snap["batches"] += 1  # a copy: the live counters do not move
    assert profiling.counters()["batches"] == snap["batches"] - 1
    with pytest.raises(KeyError):
        profiling.count("not_a_counter")


@pytest.mark.cuda
def test_spans_leave_the_card_timeline_alone():
    """On the card, every device event under a profiler is a kernel, copy
    or fill of the port: no bz2.* range shows on the card's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from torch.autograd import DeviceType

    data = _text(1607, 250_000)
    bz2tpu_torch.compress(data, 1, parallel=2, device="cuda")  # builds and warms the kernels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = bz2tpu_torch.compress(data, 1, parallel=2, device="cuda")
        torch.cuda.synchronize()
    assert stdlib_bz2.decompress(out) == data
    events = prof.events()
    card = [e.name for e in events if e.device_type == DeviceType.CUDA]
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    assert card and not any(n.startswith("bz2.") for n in card)
    assert {"bz2.encode", "bz2.bwt", "bz2.upload", "bz2.fetch"} <= host
