"""Device intake: raw bytes -> RLE1 blocks, lengths and CRCs (torch).

Port of bz2tpu/ops/intake.py: ops/rle1.py (run detection and greedy
capacity cuts) composed with ops/crc.py (range CRCs over the original
bytes), so a raw chunk becomes ready-to-encode blocks with no host pass
over the data.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from bz2tpu_torch.format import constants as C
from bz2tpu_torch.ops.crc import crc32_ranges
from bz2tpu_torch.ops.rle1 import block_cuts, rle1_encode


def chunk_capacity(level: int, max_blocks: int) -> int:
    """Raw chunk bytes (a power of two) that fill max_blocks blocks.

    The power-of-two ceiling's slack over the need keeps the last block
    of a chunk full on typical data, so the partial-block holdback of
    compress_device_intake rarely fires.
    """
    need = C.block_capacity(level) * max_blocks
    cap = 1 << 12
    while cap < need:
        cap <<= 1
    return cap


def device_intake(
    chunk: torch.Tensor,
    length: int,
    *,
    level: int,
    max_blocks: int,
    lap: Callable[[str], None] = lambda step: None,
) -> dict[str, torch.Tensor]:
    """Raw bytes -> padded RLE1 blocks + lengths + CRCs, on chunk's device.

    chunk: (N,) uint8 raw input; length: valid bytes. Returns dict with
    blocks (max_blocks, capacity + 4) uint8, ns (max_blocks,) int32 (1 for
    empty slots), crcs (max_blocks,) int64 CRCs of each block's original
    bytes (0 for empty slots), raw_lens (max_blocks,) int32 and n_blocks
    (0-dim int32). ``lap`` is called with "rle1_encode", "block_cuts",
    "rows" (the rows gather, ns and raw lengths) and "crc32_ranges" as
    each step ends (a stage clock's lap, for a clocked intake).
    """
    cap = C.block_capacity(level)
    dev = chunk.device
    enc = rle1_encode(chunk, length)
    lap("rle1_encode")
    out_cuts, raw_cuts, n_blocks = block_cuts(
        enc["piece_out_cum"], enc["piece_raw_cum"], enc["n_pieces"],
        cap=cap, max_blocks=max_blocks,
    )
    lap("block_cuts")
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    starts_out = torch.cat([zero, out_cuts[:-1]])
    starts_raw = torch.cat([zero, raw_cuts[:-1]])
    b_valid = torch.arange(max_blocks, device=dev) < n_blocks

    # Rows carry cap + 4 columns: the crossing piece may overshoot the
    # capacity by up to 4 bytes.
    out = enc["out"]
    col = torch.arange(cap + 4, dtype=torch.int32, device=dev)[None, :]
    src = (starts_out[:, None] + col).clamp(0, out.shape[0] - 1).long()
    in_range = (col < (out_cuts - starts_out)[:, None]) & b_valid[:, None]
    rows = torch.where(in_range, out[src], 0)
    ns = torch.where(b_valid, (out_cuts - starts_out).clamp(min=1), 1)
    raw_lens = torch.where(b_valid, raw_cuts - starts_raw, 0)
    lap("rows")
    crcs = torch.where(b_valid, crc32_ranges(chunk, starts_raw, raw_cuts), 0)
    lap("crc32_ranges")
    return {
        "blocks": rows,
        "ns": ns,
        "crcs": crcs,
        "raw_lens": raw_lens,
        "n_blocks": n_blocks,
    }
