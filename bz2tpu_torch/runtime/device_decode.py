"""decompress_device(): Huffman + MTF + inverse BWT on the device (torch).

Port of bz2tpu/runtime/device_decode.py:

  host    the native bit scan finds the block boundaries, and each
          block's small header (symbol map, selectors, code tables) is
          parsed with the BitReader;
  device  per batch of up to 8 same-shape blocks: the jump-map Huffman
          decode (ops/huffman_dec.py, with the dec_chain kernel), run
          expansion + inverse MTF (ops/mtf_dec.py) and the pointer-doubling
          inverse BWT (ops/ibwt.py), then one copy back per batch;
  host    native inverse RLE1 + CRC, the block and stream CRC checks, and
          the ordered concatenation.

Every device result is validated exactly (EOB at the block's end bit, run
lengths in bounds, then the block CRC). A stream the device path cannot
certify (several members, a randomised block, a block whose ``ok`` is
false) goes to the host decoder as a whole, so the output equals
bz2tpu.runtime.decompressor.decompress on every input. An error from a
kernel build or launch is not such a case: it propagates.

Blocks are bucketed by the JAX form's bit-range cap (the symbol data's
bit count rounded up to a power of two), because that cap is part of what
``ok`` checks. The JAX form also buckets by the group count rounded up,
a compile shape only: here a batch's arrays are sized by its true largest
group count and decoded length, since eager torch compiles nothing per
shape.
"""

from __future__ import annotations

import numpy as np
import torch

from bz2tpu import native
from bz2tpu.format import constants as C
from bz2tpu.format.bitio import BitReader
from bz2tpu.format.crc32 import stream_crc_fold
from bz2tpu.oracle import decoder as od
from bz2tpu.oracle.decoder import Bz2CrcError, Bz2FormatError
from bz2tpu.runtime.decompressor import decompress as host_decompress
from bz2tpu_torch.ops.huffman_dec import (
    build_len_luts,
    decode_symbol_data,
    decode_tables_arrays,
    window_words,
)
from bz2tpu_torch.ops.ibwt import ibwt
from bz2tpu_torch.ops.mtf_dec import CHUNK, mtf_rle2_decode
from bz2tpu_torch.ops.pipeline import StageClock, _lap
from bz2tpu_torch.utils.device import resolve_device

BUCKET_W = 8  # blocks per device batch, as the JAX form's default


def _parse_block_header(stream: bytes, bit_off: int) -> dict:
    """Host parse of one block header starting at its 48-bit marker (a
    copy of bz2tpu.runtime.device_decode._parse_block_header)."""
    r = BitReader(stream)
    r._pos = bit_off
    if r.read_bits(48) != C.BLOCK_HEADER_MARKER:
        raise Bz2FormatError("bad block marker")
    crc = r.read_bits(32)
    if r.read_bit():
        # Legacy randomised blocks go to the host decoders, which support them.
        raise Bz2FormatError("randomised block: host path")
    orig_ptr = r.read_bits(24)
    used = od._read_symbol_map(r)
    used_bytes = np.flatnonzero(used)
    if used_bytes.size == 0:
        raise Bz2FormatError("empty symbol map")
    alpha = used_bytes.size + 2
    n_groups = r.read_bits(3)
    if not C.HUFFMAN_MIN_TABLES <= n_groups <= C.HUFFMAN_MAX_TABLES:
        raise Bz2FormatError(f"bad table count {n_groups}")
    n_sel = r.read_bits(15)
    if not 1 <= n_sel <= C.HUFFMAN_MAX_SELECTORS:
        raise Bz2FormatError(f"bad selector count {n_sel}")
    selectors = od._decode_selectors(r, n_groups, n_sel)
    lengths = od._read_tables(r, n_groups, alpha)
    tables = [od.build_decode_tables(lengths[t]) for t in range(n_groups)]
    return {
        "crc": crc,
        "orig_ptr": orig_ptr,
        "used_bytes": used_bytes,
        "alpha": alpha,
        "selectors": np.asarray(selectors, dtype=np.int32),
        "tables": tables,
        "data_start_bit": r.bit_position,
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


def parse_blocks(stream: bytes) -> tuple[list[dict], list[int]] | None:
    """Every block header of a single-member stream, with its end bit and
    bit-range cap, and the end markers; None where the stream must go to the
    host decoder."""
    if not native.HAVE_NATIVE:
        return None
    if len(stream) < 4 or stream[:3] != b"BZh" or not (ord("1") <= stream[3] <= ord("9")):
        return None  # the host path raises the proper error
    headers, ends = native.scan_blocks(stream)
    if not headers or not ends or headers[0] != 32:
        return None
    # Single-member streams only: the final end marker must follow the
    # last header; anything else goes to the host path.
    boundaries = headers[1:] + [ends[-1]]
    parsed = []
    for start, end in zip(headers, boundaries):
        try:
            hdr = _parse_block_header(stream, start)
        except (Bz2FormatError, EOFError):
            return None
        n_bits = end - hdr["data_start_bit"]
        if n_bits <= 0:
            return None
        hdr["end_bit"] = end
        hdr["n_bits_cap"] = _pow2_at_least(n_bits, 1 << 12)
        parsed.append(hdr)
    return parsed, ends


def batches(parsed: list[dict]) -> list[tuple[int, list[int]]]:
    """(bit-range cap, block indices) of each device batch: blocks of one
    cap, up to BUCKET_W at a time."""
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
    words, rows: list[dict], nbc: int, out_cap: int, device, clock: StageClock | None
) -> list[bytes] | None:
    """Decode a batch of same-bucket blocks to their BWT-inverted bytes
    (still RLE1-encoded); None if any block fails validation."""
    bt = batch_tensors(rows, device)
    _lap(clock, "tables")
    hd = decode_symbol_data(
        words, bt["start_bit"], bt["end_bit"], bt["selectors"], bt["n_groups"], bt["base"],
        bt["perm"], bt["eob"], bt["lut"], bt["lut_idx"], n_bits_cap=nbc,
    )
    del bt["lut"]
    _lap(clock, "huffman")
    G = bt["selectors"].shape[1]
    m = -(-G * C.HUFFMAN_GROUP_SIZE // CHUNK) * CHUNK
    syms = torch.nn.functional.pad(hd["symbols"], (0, m - hd["symbols"].shape[1]), value=-1)
    md = mtf_rle2_decode(syms, hd["n_sym"], bt["initial_list"], bt["eob"], out_capacity=out_cap)
    ok = hd["ok"] & md["ok"] & (bt["orig_ptr"] < md["n_bwt"])
    del hd, syms
    if not bool(ok.all()):
        return None
    _lap(clock, "mtf")
    decoded = ibwt(md["bwt"], md["n_bwt"], bt["orig_ptr"]).cpu().numpy()
    n_bwt = md["n_bwt"].cpu().numpy()
    _lap(clock, "ibwt")
    return [decoded[r, : n_bwt[r]].tobytes() for r in range(len(rows))]


def _decompress_device_inner(
    stream: bytes, verify_crc: bool, device: torch.device, timings: dict | None = None
) -> bytes | None:
    """The device decode, or None where the stream must go to the host
    decoder: exactly where bz2tpu's form returns None.

    With ``timings``, seconds accumulate under "parse" (block scan and
    header parse, host), "tables" (table packing, upload, length LUTs),
    "huffman", "mtf" (with validation), "ibwt" (with the copy back) and
    "rle1_crc" (inverse RLE1 and CRCs, host); every lap waits for the
    device (see ops/pipeline.StageClock).
    """
    clock = None if timings is None else StageClock(timings, device)
    plan = parse_blocks(stream)
    _lap(clock, "parse")
    if plan is None:
        return None
    parsed, ends = plan
    words = stream_words(stream, device)
    out_cap = _pow2_at_least((stream[3] - ord("0")) * C.BLOCK_SIZE_BASE)
    results: list[bytes] = [b""] * len(parsed)
    for nbc, group in batches(parsed):
        walked = _decode_batch(words, [parsed[i] for i in group], nbc, out_cap, device, clock)
        if walked is None:
            return None
        for i, data in zip(group, walked):
            results[i] = data
    del words

    pieces = []
    s_crc = 0
    for i, p in enumerate(parsed):
        data, crc = native.inverse_rle1(results[i])
        if verify_crc and crc != p["crc"]:
            raise Bz2CrcError(f"block CRC mismatch: {p['crc']:#x} != {crc:#x}")
        s_crc = stream_crc_fold(s_crc, p["crc"])
        pieces.append(data)
    # The stream CRC sits 48 bits past the final end marker.
    pos = ends[-1] + 48
    if pos + 32 > len(stream) * 8:
        return None
    r = BitReader(stream)
    r._pos = pos
    stored = r.read_bits(32)
    if verify_crc and stored != s_crc:
        # Perhaps several members (one CRC each): the host path decides
        # whether this is an error or a member boundary.
        return None
    _lap(clock, "rle1_crc")
    return b"".join(pieces)
