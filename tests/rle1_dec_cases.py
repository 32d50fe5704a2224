"""Rows of RLE1 bytes for the decode's inverse RLE1 (ops/rle1_dec.py, D7),
shared by tests/test_torch_rle1_dec.py (CPU, the plain version) and
tests/test_torch_cuda.py (the kernel on the card). Imports no JAX.

``FAMILIES`` maps a name to a function that returns a list of rows (each
a bytes object of one block's RLE1 bytes, as the inverse BWT leaves it);
``as_batch`` packs rows into the (B, W) uint8 tensor and (B,) int32
lengths the op takes; ``decode_rows`` records the (rows, n) that a decode
of a stream hands the op.
"""

from __future__ import annotations

import bz2 as stdlib_bz2

import numpy as np
import torch

WORDS = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps  ", b"over\n", b"lazy ", b"dog. ", b"zzzz", b"....."]


def rle1(raw: bytes) -> bytes:
    """bzip2's RLE1: each run of 4 to 255 equal bytes as 4 of them and a
    count byte (the run's length less 4)."""
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and raw[j] == raw[i] and j - i < 255:
            j += 1
        out += raw[i:j] if j - i < 4 else raw[i : i + 4] + bytes([j - i - 4])
        i = j
    return bytes(out)


def serial(row: bytes) -> tuple[bytes, int]:
    """A literal copy of the C core's loop (native inverse_rle1): the
    output, and the state after the last byte (4: it ends on four equal
    data bytes with no count after them)."""
    out, prev, k = bytearray(), 0, 0
    for c in row:
        if k == 4:
            out += bytes([prev]) * c
            k = 0
            continue
        if c == prev:
            k += 1
        else:
            k, prev = 1, c
        out.append(c)
    return bytes(out), k


def text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return b"".join(WORDS[i] for i in rng.integers(len(WORDS), size=n // 3 + 1))[:n]


def runs(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 5, n // 50 + 1, dtype=np.uint8)
    return np.repeat(vals, rng.integers(1, 600, vals.size))[:n].tobytes()


def _random(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hi, n, dtype=np.uint8).tobytes() for hi, n in ((256, 100_000), (2, 100_000), (4, 50_000))]


FAMILIES = {
    # The count byte equals the run byte: 97 more a's, then a run of one.
    "count_equals_run_byte": lambda: [b"aaaa" + b"a" + b"xyz", b"bbbb" + b"b" + b"bbbb" + b"b", b"cccc" + b"c" * 6],
    # A count that starts a stretch of its own value: the first b is a count.
    "count_starts_a_stretch": lambda: [b"aaaa" + b"b" + b"bbbb" + b"\x02" + b"c", b"aaaab" * 40,
                                      b"aaaa" + b"\x04" + b"\x04" * 4 + b"\x04\x04"],
    "counts_0_and_255": lambda: [b"zzzz\x00" + b"y", b"zzzz\xff" + b"y", (b"qqqq\x00" + b"rrrr\xff") * 300],
    "stretch_lengths": lambda: [b"q" * n for n in (1, 3, 4, 5, 8, 9, 10)]
    + [b"ab" + b"q" * n + b"cd" for n in (1, 3, 4, 5, 8, 9, 10)] + [b"q" * 900_000],
    "ends_on_four_without_count": lambda: [b"xyzwwww", b"wwww", b"ab" + b"c" * 9, text(5_000, 7) + b"eeee"],
    "random": lambda: _random(8),
    "rle1_of_runs_and_text": lambda: [rle1(runs(200_000, 9)), rle1(text(120_000, 10))],
    "at_the_bound": lambda: [(b"qqqq\xff") * 20_000],
    "unequal_rows": lambda: [text(4_097, 11), b"a", rle1(runs(70_000, 12)), b"kkkk\x07", b"", rle1(text(12, 13))],
}


def as_batch(rows: list[bytes], device, width: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows as the op takes them: (B, W) uint8, zero past each row's end,
    and (B,) int32 lengths."""
    w = width or max(1, max(map(len, rows)))
    a = np.zeros((len(rows), w), np.uint8)
    for i, r in enumerate(rows):
        a[i, : len(r)] = np.frombuffer(r, np.uint8)
    n = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    return torch.from_numpy(a).to(device), n.to(device)


def stdlib_stream(level: int) -> bytes:
    """A stdlib stream of text and runs: three blocks at level 1, one at 9."""
    return stdlib_bz2.compress(text(180_000, 14) + runs(90_000, 15) + text(30_000, 16), level)


def decode_rows(stream: bytes, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The (rows, n) of each batch that decompress_device hands its inverse
    RLE1 on ``device``."""
    from bz2tpu_torch.runtime import device_decode

    seen = []
    real = device_decode.inverse_rle1_crc

    def record(rows, n):
        seen.append((rows.clone(), n.clone()))
        return real(rows, n)

    device_decode.inverse_rle1_crc = record
    try:
        assert device_decode.decompress_device(stream, device=device) == stdlib_bz2.decompress(stream)
    finally:
        device_decode.inverse_rle1_crc = real
    return seen
