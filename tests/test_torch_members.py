"""decompress_device on streams of several members (concatenated bzip2
streams, as Wikimedia's multistream dumps and pbzip2 write them), on the
CPU.

Well-formed chains decode on the device path (``_decompress_device_inner``
returns the bytes, not None): members of mixed levels, a member of several
blocks between one-block members, and the benchmark's own cut of its wiki
mix into 100-page members. Each output equals the plain reference
(portbench/reference/members_ref.py), stdlib bz2 and the JAX package's host
decoder. What the host decoder gives its own semantics to (an empty
member, junk between members, a cut magic after the last member, a later
member that fails a CRC or its level's block size) leaves the device path
with one count of its reason, and ``decompress_device`` returns the host
decoder's bytes or raises its error. Inputs come from numpy seeds.
"""

import bz2 as stdlib_bz2

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from bz2tpu.runtime.decompressor import decompress as jax_host_decompress  # noqa: E402
from bz2tpu_torch.runtime import decompressor, device_decode  # noqa: E402
from bz2tpu_torch.runtime.decompressor import decompress as port_host_decompress  # noqa: E402
from bz2tpu_torch.utils import profiling  # noqa: E402
from portbench import gen, run  # noqa: E402
from portbench.reference import members_ref  # noqa: E402

from conftest import make_corpus  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (see test_torch_cli)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moved(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _outcome(fn, stream):
    try:
        return fn(stream)
    except ValueError as e:
        return e


def _harness_cut() -> tuple[bytes, int]:
    """The benchmark's input from a 700 kB object of its wiki mix: a stdlib
    -9 stream after every 100th page (run.write_inputs), and its members."""
    mix = gen.load_mix("enwik")
    mix["objects"] = [dict(mix["objects"][0], bytes=700_000)]
    raw = [d for _, d in gen.make_objects(mix, 2**31 + 1905, threads=2)]
    inputs, members = run.write_inputs(raw, 9, {"records": 100, "after": "</page>\n"}, threads=2)
    assert members[0] >= 2
    return inputs[0], members[0]


def _members(seed: int, spec: list[tuple[str, int, int]]) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [stdlib_bz2.compress(make_corpus(rng, kind, n), level) for kind, n, level in spec]


def _chain(seed: int, spec: list[tuple[str, int, int]]) -> tuple[bytes, int]:
    return b"".join(_members(seed, spec)), len(spec)


TWO = [("text", 120_000, 1), ("runs", 60_000, 9)]
MULTIBLOCK_BETWEEN = [("text", 40_000, 9), ("text", 330_000, 1), ("runs", 50_000, 9)]
CHAINS = {
    "two": lambda: _chain(1901, TWO),
    "six": lambda: _chain(1902, [("text", 9_000 * (k + 1), k + 2) for k in range(6)]),
    # The output capacity follows the largest level: a -9 member's block of
    # 250 kB after a -1 one.
    "levels_1_9_1": lambda: _chain(1903, [("text", 90_000, 1), ("text", 250_000, 9), ("random", 30_000, 1)]),
    "multiblock_between": lambda: _chain(1904, MULTIBLOCK_BETWEEN),
    "harness_cut": _harness_cut,
}


@pytest.mark.parametrize("chain", CHAINS)
def test_members_decode_on_the_device_path(chain):
    stream, n_members = CHAINS[chain]()
    want = stdlib_bz2.decompress(stream)
    assert members_ref.decode(stream) == want
    assert jax_host_decompress(stream) == want
    got, moved = _moved(lambda: device_decode._decompress_device_inner(stream, True, CPU))
    assert got == want
    headers, _ = device_decode.native.scan_blocks(stream)
    assert moved == {"decode_headers": len(headers), "decode_members": n_members, "decode_rle1_device": len(headers)}
    assert device_decode.decompress_device(stream, device="cpu") == want


def test_the_walk_lists_each_member():
    members = _members(1904, MULTIBLOCK_BETWEEN)
    stream = b"".join(members)
    parsed, chain = device_decode.parse_blocks(stream)
    assert [(level, n) for level, n, _ in chain] == [(9, 1), (1, 4), (9, 1)]
    assert [p["level"] for p in parsed] == [9, 1, 1, 1, 1, 9]
    # Each member's end marker is the one its own stream has, moved to its place.
    at = 0
    for m, (_, _, end) in zip(members, chain):
        assert end == 8 * at + device_decode.native.scan_blocks(m)[1][0]
        at += len(m)
    # The host decoder's block-parallel path walks the same chain, each block
    # ending where its decode ends.
    headers, ends = device_decode.native.scan_blocks(stream)
    decoded = {h: device_decode.native.decode_block_at(stream, h, level, True)[2]
               for h, level in zip(headers, [p["level"] for p in parsed])}
    blocks, host_chain = decompressor.walk_members(stream, headers, ends, decoded.get)
    assert host_chain == chain
    assert blocks == [(h, p["end_bit"], p["level"]) for h, p in zip(headers, parsed)]


def _irregular() -> dict:
    rng = np.random.default_rng(1906)
    a, b, c = (make_corpus(rng, "text", n) for n in (70_000, 40_000, 150_000))
    ma, mb = stdlib_bz2.compress(a, 1), stdlib_bz2.compress(b, 1)
    bad_crc = bytearray(mb)
    bad_crc[-3] ^= 0x01  # inside the second member's stream CRC
    bad_block_crc = bytearray(mb)
    bad_block_crc[11] ^= 0x01  # the block CRC of the second member's block (bits 80-111)
    over = bytearray(stdlib_bz2.compress(c, 9))
    over[3] = ord("1")  # a 150 kB block under a BZh1 header, after a -9 member: within the capacity
    return {
        "empty_member_between": (ma + stdlib_bz2.compress(b"") + mb, "members"),
        "junk_between": (ma + b"junk" + mb, "members"),
        "cut_magic_after": (ma + mb + b"BZh", "members"),
        "later_block_crc": (ma + bytes(bad_block_crc), "members"),
        "later_stream_crc": (ma + bytes(bad_crc), "stream_crc"),
        "later_over_its_level": (stdlib_bz2.compress(a, 9) + bytes(over), "validate"),
    }


@pytest.mark.parametrize("case", list(_irregular()))
def test_irregular_members_go_to_the_host(case):
    stream, reason = _irregular()[case]
    got, moved = _moved(lambda: device_decode._decompress_device_inner(stream, True, CPU))
    assert got is None
    headers = moved.pop("decode_headers", 0)
    moved.pop("decode_members", None)
    # A later member's CRC is checked after every block's inverse RLE1 and
    # CRC ran on the device; a batch over its level never gets there.
    rle1 = moved.pop("decode_rle1_device", 0)
    assert rle1 == headers if case.endswith("_crc") else rle1 < headers or rle1 == 0
    assert moved == {f"decode_fallbacks.{reason}": 1}
    want = _outcome(port_host_decompress, stream)
    assert type(want).__name__ == type(_outcome(jax_host_decompress, stream)).__name__
    out, moved = _moved(lambda: _outcome(lambda s: device_decode.decompress_device(s, device="cpu"), stream))
    assert moved.get(f"decode_fallbacks.{reason}") == 1
    if isinstance(want, Exception):
        assert type(out) is type(want) and str(out) == str(want)
    else:
        assert out == want == jax_host_decompress(stream)


def test_a_later_members_bad_block_crc_is_found_after_the_device_rle1():
    # Every block's inverse RLE1 and CRC run on the device first; the host
    # then finds the second member's stored CRC wrong and hands the stream
    # to the host decoder, which keeps the first member.
    stream, _ = _irregular()["later_block_crc"]
    got, moved = _moved(lambda: device_decode._decompress_device_inner(stream, True, CPU))
    assert got is None
    assert moved == {"decode_headers": 2, "decode_members": 2, "decode_rle1_device": 2, "decode_fallbacks.members": 1}
    want = _outcome(port_host_decompress, stream)
    assert _outcome(lambda s: device_decode.decompress_device(s, device="cpu"), stream) == want
    # Unverified, the device path keeps both members' bytes.
    assert device_decode._decompress_device_inner(stream, False, CPU) == port_host_decompress(stream, verify_crc=False)


def test_non_magic_junk_after_the_last_member_is_ignored():
    chain, _ = _chain(1901, TWO)
    stream = chain + b"trailing bytes, not a member"
    want = port_host_decompress(stream)
    assert want == stdlib_bz2.decompress(chain)
    got, moved = _moved(lambda: device_decode._decompress_device_inner(stream, True, CPU))
    assert got == want
    assert moved["decode_members"] == 2 and not any(k.startswith("decode_fallbacks") for k in moved)


def _compressible(rng) -> bytes:
    """Ten MB of one 2 kB piece of text over and over: -9 blocks of 900 kB
    whose symbol data is a few kB, so their bit-range caps are the
    smallest."""
    return stdlib_bz2.compress(make_corpus(rng, "text", 2_000) * 5_000, 9)


BATCH_STREAMS = {
    "one_block_members": lambda rng: b"".join(
        stdlib_bz2.compress(make_corpus(rng, "text", 30_000), 9) for _ in range(12)
    ),
    "compressible_l9": _compressible,
    "incompressible_l1": lambda rng: stdlib_bz2.compress(make_corpus(rng, "random", 1_000_000), 1),
}


@pytest.mark.parametrize("name", BATCH_STREAMS)
def test_a_batch_holds_at_most_bucket_w_blocks(name):
    """Every row of a batch is sized to the output capacity, so a batch
    holds at most BUCKET_W blocks whatever their bits: blocks of one cap, in
    order, from any members."""
    parsed, _ = device_decode.parse_blocks(BATCH_STREAMS[name](np.random.default_rng(1907)))
    got = device_decode.batches(parsed)
    assert all(1 <= len(g) <= device_decode.BUCKET_W for _, g in got)
    assert sorted(i for _, g in got for i in g) == list(range(len(parsed)))
    for nbc, g in got:
        assert g == sorted(g) and {parsed[i]["n_bits_cap"] for i in g} == {nbc}
    if name == "compressible_l9":
        assert len(parsed) == 12 and max(p["n_bits_cap"] for p in parsed) <= 1 << 16
