"""The decode's inverse RLE1 and block CRCs on the device (torch).

The inverse BWT leaves a batch's blocks as rows of RLE1 bytes on the
device: bzip2 wrote each run of 4 to 255 equal bytes as 4 of them and a
count byte. ``parse`` works out each row's output size and its place in
the batch's output, ``expand`` writes the batch's bytes into one flat
buffer, and ``crc32_ranges`` (D5) takes each row's CRC-32/BZIP2 over it;
``inverse_rle1_crc`` runs the three.
Rows on a CUDA card launch D7 (ops/rle1_dec_cuda.py, csrc/rle1_dec.cu);
rows on the CPU take the plain version here. bz2tpu runs this step on the
host, block by block, after the copy back (bz2tpu/runtime/device_decode.py:285).

The plain version reads a row as maximal stretches of equal bytes. The
byte after a count starts a run of 1 whatever its value, so a count can
begin a stretch without belonging to its run (``aaaa`` ``b`` ``bbbb``: the
first ``b`` is a count). A stretch of length L entered with its first byte
a count (b = 1) or not (b = 0) hands "the next byte is a count" on
exactly when (L - b) mod 5 = 4: it resets (L mod 5 in 1..3), passes b on
(L mod 5 = 0) or flips it (L mod 5 = 4). So a stretch's b is the parity
of the flips since the last reset, two cumsums and a cummax; a byte at
offset o of its stretch is a count when (o - b) mod 5 = 4, and writes c
copies of the byte before it; every other byte writes itself.

A row of n bytes writes at most 259 ceil(n / 5) bytes (a count follows
four data bytes of its own and writes at most 255): ``out_bound``. The
decode calls ``inverse_rle1_crc`` once a batch.
"""

from __future__ import annotations

import math

import torch

from bz2tpu_torch.ops import rle1_dec_cuda
from bz2tpu_torch.ops.crc import DEFAULT_LANES, crc32_ranges

MAX_RUN_BYTES = 259  # 4 data bytes and a count of 255: the most 5 RLE1 bytes write


def out_bound(n_rows: int, n: int) -> int:
    """The most bytes ``n_rows`` rows of at most ``n`` bytes write."""
    return n_rows * -(-n // 5) * MAX_RUN_BYTES


def parse_ref(rows: torch.Tensor, n: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Plain version of parse: ({"len", "val"}, offsets), each byte's output
    count and the byte it writes, (B, W) int32 (0 past n)."""
    b, w = rows.shape
    dev = rows.device
    i32 = torch.int32
    idx = torch.arange(w, dtype=i32, device=dev).expand(b, w)
    valid = idx < n.to(i32).clamp(0, w)[:, None]
    c = rows.to(i32)
    prev = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], 1)
    # Stretches of equal valid bytes; each byte's offset in its stretch.
    head = (idx == 0) | (c != prev) | (valid != torch.cat([valid[:, :1], valid[:, :-1]], 1))
    start = torch.cummax(torch.where(head, idx, 0), 1).values
    off = idx - start
    last = torch.cat([head[:, 1:], torch.ones_like(head[:, :1])], 1)
    rem = (off + 1) % 5  # a stretch's length mod 5, at its last byte
    flips = torch.cumsum((last & (rem == 4)).to(i32), 1, dtype=i32)
    reset_at = torch.cummax(torch.where(last & (rem >= 1) & (rem <= 3), idx, -1), 1).values
    # Before a stretch: the flips so far less those up to the last reset.
    before = (start - 1).clamp(min=0).long()
    flips_before = torch.where(start > 0, flips.gather(1, before), 0)
    reset_before = torch.where(start > 0, reset_at.gather(1, before), -1)
    flips_at_reset = torch.where(reset_before >= 0, flips.gather(1, reset_before.clamp(min=0).long()), 0)
    entered_on_count = (flips_before - flips_at_reset) % 2
    is_count = valid & ((off - entered_on_count) % 5 == 4)
    length = torch.where(valid, torch.where(is_count, c, 1), 0)
    val = torch.where(is_count, prev, c)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(length.sum(1, dtype=torch.int64), 0)])
    return {"len": length, "val": val}, offsets


def expand_ref(plan: dict, out: torch.Tensor) -> torch.Tensor:
    """Plain version of expand: every byte's output in row order into
    out[:total]."""
    flat = torch.repeat_interleave(plan["val"].flatten().to(torch.uint8), plan["len"].flatten().long())
    out[: flat.shape[0]] = flat
    return out


def _check_rows(rows: torch.Tensor, n: torch.Tensor) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2 or 0 in rows.shape or rows.stride(1) != 1:
        raise ValueError(f"rows must be a non-empty (B, W) uint8 tensor with contiguous rows, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if n.dtype != torch.int32 or n.shape != rows.shape[:1] or not n.is_contiguous():
        raise ValueError(f"n must be a contiguous (B,) int32 tensor, got {n.dtype} {tuple(n.shape)}")
    if n.device != rows.device:
        raise ValueError(f"n is on {n.device}, the rows on {rows.device}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")


def parse(rows: torch.Tensor, n: torch.Tensor) -> tuple[object, torch.Tensor]:
    """Each row's place in the batch's output: (plan, offsets), where
    offsets (B + 1,) int64 on the rows' device holds each row's start and
    the batch's end, and plan is what ``expand`` takes.

    rows: (B, W) uint8, each row's bytes contiguous; n: (B,) int32 on the
    same device, the valid bytes of each row (clamped into [0, W]). A CPU
    tensor takes the plain version, a CUDA one launches D7."""
    _check_rows(rows, n)
    if rows.device.type == "cpu":
        return parse_ref(rows, n)
    return rle1_dec_cuda.parse(rows, n)


def expand(rows: torch.Tensor, n: torch.Tensor, plan, offsets: torch.Tensor, size: int) -> torch.Tensor:
    """The batch's bytes: a (size,) uint8 buffer on the rows' device whose
    first offsets[B] bytes are the rows' outputs in order (the rest left
    as it is); ``plan`` and ``offsets`` from ``parse`` on the same rows,
    ``size`` at least offsets[B]."""
    _check_rows(rows, n)
    out = torch.empty(max(size, 1), dtype=torch.uint8, device=rows.device)
    if rows.device.type == "cpu":
        return expand_ref(plan, out)
    return rle1_dec_cuda.expand(rows, n, plan, offsets, out)


def _cpu_lanes(total: int) -> int:
    """The plain CRC's lanes for ``total`` bytes: about 2 sqrt(total), a
    power of two, so its steps (total / lanes) and its fold (lanes x 32
    bits a round) both stay short."""
    lanes = 256
    while lanes < min(2 * math.isqrt(total), DEFAULT_LANES):
        lanes <<= 1
    return lanes


def inverse_rle1_crc(rows: torch.Tensor, n: torch.Tensor) -> tuple[torch.Tensor, list[int], torch.Tensor]:
    """A batch's inverse RLE1 and each row's CRC-32/BZIP2: its output
    (total,) uint8 on the rows' device, each row's start and the end as
    host ints (the one read from the device, which sizes the output
    exactly), and (B,) int64 CRCs on the device, from crc32_ranges over the
    output (arguments as ``parse``). On the CPU the output is padded to a
    multiple of the plain CRC's lanes."""
    plan, offsets = parse(rows, n)
    ends = offsets.tolist()
    total, lanes = ends[-1], _cpu_lanes(ends[-1])
    flat = expand(rows, n, plan, offsets, total if rows.device.type == "cuda" else -(-max(total, 1) // lanes) * lanes)
    return flat[:total], ends, crc32_ranges(flat, offsets[:-1], offsets[1:], lanes=lanes)
