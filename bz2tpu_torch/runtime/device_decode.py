"""decompress_device(): Huffman + MTF + inverse BWT on the device (torch).

Port of bz2tpu/runtime/device_decode.py, which it extends to streams of
several members:

  host    the C core (native/_bz2dec.c) finds the block boundaries with a
          byte-wise marker search; the member walk
          (decompressor.walk_members, which the host decoder's block-parallel
          path shares) chains the members, and the C core parses each block's small header
          (symbol map, selectors, code lengths) in one pass;
  device  per batch of up to 8 same-cap blocks, from any members: the
          jump-map Huffman decode (ops/huffman_dec.py, with the dec_chain
          and dec_symbols kernels), run expansion + inverse MTF
          (ops/mtf_dec.py, with the mtf_dec kernel), the pointer-doubling
          inverse BWT (ops/ibwt.py), the inverse RLE1 into one flat buffer
          and each block's CRC (ops/rle1_dec.py, with the rle1_dec and
          crc_ranges kernels), then one copy back per batch;
  host    the block CRC checks, each member's stream CRC, and the ordered
          concatenation.

A stream is a chain of members (concatenated bzip2 streams, as
Wikimedia's multistream dumps or pbzip2 write them): a member starts at a
byte-aligned ``BZh1``-``BZh9`` directly followed by a block header, its
last block ends at its end marker, and the next member starts at the byte
after the 32-bit stream CRC that follows the marker. Every device result
is validated exactly (EOB at the block's end bit, run lengths in bounds,
at most the member's level x 100,000 bytes, then the block CRC), and each
member's block CRCs fold into its own stream CRC. What the host decoder
gives its own semantics to goes to it as a whole: no native scanner, no
magic, an empty member, junk between members, a member-like magic after
the last member or off the chain, a randomised block, a batch that fails
validation, a stream CRC that is missing or does not match, a block CRC
that does not match in a later member. So the output equals
runtime/decompressor.decompress on every input; bz2tpu's form also
leaves every stream of several members to the host. An error from a
kernel build or launch is not such a case: it propagates.

Blocks are bucketed by the JAX form's bit-range cap (the symbol data's
bit count rounded up to a power of two), because that cap is part of what
``ok`` checks. The JAX form also buckets by the group count rounded up,
a compile shape only: here a batch's arrays are sized by its true largest
group count and decoded length, since eager torch compiles nothing per
shape. The output capacity of every row is the power of two at or
above the largest member level x 100,000.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from bz2tpu_torch import native
from bz2tpu_torch.format import constants as C
from bz2tpu_torch.format.bitio import BitReader
from bz2tpu_torch.format.crc32 import stream_crc_fold
from bz2tpu_torch.oracle import decoder as od
from bz2tpu_torch.oracle.decoder import Bz2CrcError, Bz2FormatError
from bz2tpu_torch.ops.huffman_dec import (
    build_len_luts,
    decode_symbol_data,
    decode_tables_arrays,
    window_words,
)
from bz2tpu_torch.ops.ibwt import ibwt
from bz2tpu_torch.ops.mtf_dec import CHUNK, mtf_rle2_decode
from bz2tpu_torch.ops.pipeline import StageClock, _lap
from bz2tpu_torch.ops.rle1_dec import inverse_rle1_crc
from bz2tpu_torch.runtime.decompressor import walk_members
from bz2tpu_torch.runtime.decompressor import decompress as host_decompress
from bz2tpu_torch.utils.device import resolve_device
from bz2tpu_torch.utils.profiling import count, span

BUCKET_W = 8  # blocks per device batch, as the JAX form's default


def _parse_block_header(stream: bytes, bit_off: int) -> dict:
    """One block header starting at its 48-bit marker, parsed by the C core
    (native.parse_block_header); the fields and errors of
    bz2tpu.runtime.device_decode._parse_block_header."""
    try:
        crc, randomised, orig_ptr, used, sel, lens, data_start = native.parse_block_header(stream, bit_off)
    except ValueError as exc:
        raise Bz2FormatError(str(exc)) from None
    if randomised:
        # Legacy randomised blocks go to the host decoders, which support them.
        raise Bz2FormatError("randomised block: host path")
    used_bytes = np.frombuffer(used, np.uint8).astype(np.int64)
    alpha = used_bytes.size + 2
    lengths = np.frombuffer(lens, np.uint8).reshape(-1, alpha)
    return {
        "crc": crc,
        "orig_ptr": orig_ptr,
        "used_bytes": used_bytes,
        "alpha": alpha,
        "selectors": np.frombuffer(sel, np.uint8).astype(np.int32),
        "tables": [od.build_decode_tables(row) for row in lengths],
        "data_start_bit": data_start,
    }


def _pow2_at_least(n: int, floor: int = 16) -> int:
    v = floor
    while v < n:
        v <<= 1
    return v


def decompress_device(
    stream: bytes,
    verify_crc: bool = True,
    device: str | torch.device | None = None,
    timings: dict | None = None,
) -> bytes:
    """Decode a .bz2 stream on the device; a stream the device path cannot
    certify is decoded by the host decoder instead (see the module doc).

    ``device`` defaults to CUDA and raises where there is none; pass
    ``device="cpu"`` for the plain torch path. ``timings``, when given,
    collects per-stage seconds of the device decode (see
    _decompress_device_inner).
    """
    dev = resolve_device(device)
    stream = bytes(stream)
    out = _decompress_device_inner(stream, verify_crc, dev, timings)
    if out is None:
        return host_decompress(stream, verify_crc=verify_crc)
    return out


def stream_words(stream: bytes, device: torch.device) -> torch.Tensor:
    """The window words (huffman_dec.window_words) of the stream
    zero-padded to a power of two, as the JAX form pads it: windows that
    read past the end see the same bytes."""
    arr = np.frombuffer(stream, dtype=np.uint8)
    padded = np.zeros(_pow2_at_least(arr.size, 1 << 12), dtype=np.uint8)
    padded[: arr.size] = arr
    return window_words(torch.from_numpy(padded).to(device))


def parse_blocks(
    stream: bytes, clock: StageClock | None = None
) -> tuple[list[dict], list[tuple[int, int, int]]] | None:
    """Every block header of the stream's members, each with its end bit,
    bit-range cap and member level, and each member's (level, block count,
    end-marker bit); None where the stream must go to the host decoder.

    The C core's scan gives every block header and end marker; the member
    walk (``decompressor.walk_members``) cuts the blocks from them, each at
    the next marker, and chains the members. With a clock, the scan and
    the header parse lap under "parse" and the walk under "members".
    """
    if not native.HAVE_NATIVE:
        count("decode_fallbacks.no_native")
        return None
    if len(stream) < 4 or stream[:3] != b"BZh" or not (ord("1") <= stream[3] <= ord("9")):
        count("decode_fallbacks.header")
        return None  # the host path raises the proper error
    headers, ends = native.scan_blocks(stream)
    if not headers or not ends or headers[0] != 32:
        count("decode_fallbacks.scan")
        return None
    _lap(clock, "parse")
    with span("bz2.members"):
        markers = sorted(headers + ends)

        def next_marker(cur: int) -> int | None:
            # A spurious marker inside block data cuts a block short: its
            # batch then fails validation.
            j = bisect.bisect_right(markers, cur)
            return markers[j] if j < len(markers) else None

        chain = walk_members(stream, headers, ends, next_marker)
    _lap(clock, "members")
    if chain is None:
        count("decode_fallbacks.members")
        return None
    bounds, members = chain
    parsed = []
    for start, end, level in bounds:
        try:
            hdr = _parse_block_header(stream, start)
        except (Bz2FormatError, EOFError):
            count("decode_fallbacks.block")
            return None
        n_bits = end - hdr["data_start_bit"]
        if n_bits <= 0:
            count("decode_fallbacks.block")
            return None
        hdr["end_bit"] = end
        hdr["n_bits_cap"] = _pow2_at_least(n_bits, 1 << 12)
        hdr["level"] = level
        parsed.append(hdr)
    count("decode_headers", len(parsed))
    count("decode_members", len(members))
    return parsed, members


def out_capacity(parsed: list[dict]) -> int:
    """Every row's output capacity: the largest member level x 100,000, to
    a power of two."""
    return _pow2_at_least(max(p["level"] for p in parsed) * C.BLOCK_SIZE_BASE)


def batches(parsed: list[dict]) -> list[tuple[int, list[int]]]:
    """(bit-range cap, block indices) of each device batch: blocks of one
    cap, from any members, up to BUCKET_W at a time."""
    buckets: dict[int, list[int]] = {}
    for i, p in enumerate(parsed):
        buckets.setdefault(p["n_bits_cap"], []).append(i)
    return [
        (nbc, idxs[i : i + BUCKET_W])
        for nbc, idxs in buckets.items()
        for i in range(0, len(idxs), BUCKET_W)
    ]


def batch_tensors(rows: list[dict], device: torch.device) -> dict[str, torch.Tensor]:
    """The per-block decode inputs of a batch, on the device: selectors
    (B, G) at the batch's true largest group count, canonical tables
    (B, T, ...), the shared length LUTs and each table's row in them."""
    b = len(rows)
    T = max(len(p["tables"]) for p in rows)
    G = max(p["selectors"].size for p in rows)
    sel = np.zeros((b, G), np.int32)
    bas = np.zeros((b, T, 21), np.int32)
    prm = np.zeros((b, T, C.HUFFMAN_MAX_ALPHABET), np.int32)
    lidx = np.zeros((b, T), np.int32)  # unused table slots read LUT row 0
    il = np.zeros((b, 256), np.int32)
    # Each distinct threshold row builds its 2^20-entry length LUT once
    # per batch; row 0 is the all-zero row of unused table slots.
    thr_rows = [np.zeros(21, np.int32)]
    lut_map = {thr_rows[0].tobytes(): 0}
    for r, p in enumerate(rows):
        sel[r, : p["selectors"].size] = p["selectors"]
        _, base_a, perm, thr_a = decode_tables_arrays(p["tables"])
        bas[r, : base_a.shape[0]] = base_a
        prm[r, : perm.shape[0]] = perm
        for t in range(thr_a.shape[0]):
            key = thr_a[t].tobytes()
            if key not in lut_map:
                lut_map[key] = len(thr_rows)
                thr_rows.append(thr_a[t])
            lidx[r, t] = lut_map[key]
        il[r, : p["used_bytes"].size] = p["used_bytes"]

    def put(a, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=dtype)).to(device)

    return {
        "start_bit": put([p["data_start_bit"] for p in rows], np.int64),
        "end_bit": put([p["end_bit"] for p in rows], np.int64),
        "orig_ptr": put([p["orig_ptr"] for p in rows], np.int64),
        "n_groups": put([p["selectors"].size for p in rows], np.int32),
        "eob": put([p["alpha"] - 1 for p in rows], np.int32),
        "selectors": put(sel),
        "base": put(bas),
        "perm": put(prm),
        "lut": build_len_luts(put(np.stack(thr_rows))),
        "lut_idx": put(lidx),
        "initial_list": put(il),
    }


def _decode_batch(
    words, rows: list[dict], nbc: int, out_cap: int, device, clock: StageClock | None,
    split: dict | None = None,
) -> list[tuple[memoryview, int]] | None:
    """Decode a batch of same-bucket blocks to each block's bytes and CRC;
    None if any block fails validation. With a clock and ``split``, the
    steps inside "huffman" and "mtf" also add their seconds to ``split``."""
    bt = batch_tensors(rows, device)
    _lap(clock, "tables")
    lap = StageClock(split, device).lap if clock is not None and split is not None else lambda stage: None
    hd = decode_symbol_data(
        words, bt["start_bit"], bt["end_bit"], bt["selectors"], bt["n_groups"], bt["base"],
        bt["perm"], bt["eob"], bt["lut"], bt["lut_idx"], n_bits_cap=nbc, lap=lap,
    )
    del bt["lut"]
    _lap(clock, "huffman")
    G = bt["selectors"].shape[1]
    m = -(-G * C.HUFFMAN_GROUP_SIZE // CHUNK) * CHUNK
    syms = torch.nn.functional.pad(hd["symbols"], (0, m - hd["symbols"].shape[1]), value=-1)
    md = mtf_rle2_decode(syms, hd["n_sym"], bt["initial_list"], bt["eob"], out_capacity=out_cap, lap=lap)
    ok = hd["ok"] & md["ok"] & (bt["orig_ptr"] < md["n_bwt"])
    del hd, syms
    n_bwt = md["n_bwt"].contiguous()
    b = len(rows)
    checks = torch.cat([ok.to(torch.int64), n_bwt.to(torch.int64)]).tolist()
    # Over its member's declared block size is a block the host decoder refuses.
    if not all(checks[:b]) or any(n > p["level"] * C.BLOCK_SIZE_BASE for n, p in zip(checks[b:], rows)):
        count("decode_fallbacks.validate")
        return None
    _lap(clock, "mtf")
    decoded = ibwt(md["bwt"], n_bwt, bt["orig_ptr"])
    _lap(clock, "ibwt")
    flat, ends, crcs = inverse_rle1_crc(decoded, n_bwt)
    del decoded
    data = memoryview(flat.cpu().numpy())
    crcs = crcs.tolist()
    count("decode_rle1_device", b)
    _lap(clock, "rle1_crc")
    return [(data[ends[r] : ends[r + 1]], crcs[r]) for r in range(b)]


def _decompress_device_inner(
    stream: bytes, verify_crc: bool, device: torch.device, timings: dict | None = None, split: dict | None = None
) -> bytes | None:
    """The device decode, or None where the stream must go to the host
    decoder (see the module doc).

    With ``timings``, seconds accumulate under "parse" (block scan and
    header parse, host), "members" (the member walk, host), "tables"
    (table packing, upload, length LUTs), "huffman", "mtf" (with
    validation), "ibwt" and "rle1_crc" (each batch's inverse RLE1, block
    CRCs and copy back on the device, then the CRC checks and each
    member's stream CRC on the host); every lap waits for the device (see
    ops/pipeline.StageClock). With ``split`` too, the steps of "huffman"
    accumulate there under "jump_maps", "dec_chain" (D1), "dec_symbols"
    (D3) and "validate", and those of "mtf" under "segments",
    "chunk_perms" (D4), "chunk_scan" and "expand".
    """
    clock = None if timings is None else StageClock(timings, device)
    with span("bz2.parse"):
        plan = parse_blocks(stream, clock)
    _lap(clock, "parse")
    if plan is None:
        return None
    parsed, members = plan
    words = stream_words(stream, device)
    out_cap = out_capacity(parsed)
    results: list[tuple[memoryview | bytes, int]] = [(b"", 0)] * len(parsed)
    for nbc, group in batches(parsed):
        walked = _decode_batch(words, [parsed[i] for i in group], nbc, out_cap, device, clock, split)
        if walked is None:
            return None
        for i, data in zip(group, walked):
            results[i] = data
    del words
    return _join_members(stream, verify_crc, parsed, members, results, clock)


def _join_members(
    stream: bytes, verify_crc: bool, parsed: list[dict], members: list[tuple[int, int, int]],
    results: list[tuple[memoryview | bytes, int]], clock: StageClock | None,
) -> bytes | None:
    """The members' bytes in order, each block's CRC (from the device) and
    each member's stream CRC checked; None where the host decoder owns the
    outcome."""
    pieces = []
    r = BitReader(stream)
    first = 0
    for m, (_, n_blocks, end) in enumerate(members):
        s_crc = 0
        for i in range(first, first + n_blocks):
            data, crc = results[i]
            if verify_crc and crc != parsed[i]["crc"]:
                if m:
                    # A later member that fails: the host decoder rolls back to
                    # the members before it.
                    count("decode_fallbacks.members")
                    return None
                raise Bz2CrcError(f"block CRC mismatch: {parsed[i]['crc']:#x} != {crc:#x}")
            s_crc = stream_crc_fold(s_crc, parsed[i]["crc"])
            pieces.append(data)
        first += n_blocks
        # The member's stream CRC sits 48 bits past its end marker.
        r._pos = end + 48
        if r._pos + 32 > len(stream) * 8:
            count("decode_fallbacks.stream_crc")
            return None
        if verify_crc and r.read_bits(32) != s_crc:
            # The host decoder raises for the first member and rolls back
            # to the members before a later one.
            count("decode_fallbacks.stream_crc")
            return None
    _lap(clock, "rle1_crc")
    return b"".join(pieces)
