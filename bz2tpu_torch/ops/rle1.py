"""RLE1 (bzip2's first run-length stage) and the block cuts (torch).

Port of bz2tpu/ops/rle1.py. Run heads are change flags; a piece is at
most 255 raw bytes of one run (the oracle's unit), so every output byte's
position is a closed-form function of cumsums and cummaxes, and the
encoded bytes land with two scatters. Blocks take whole pieces, greedily
up to the level's capacity (stock bzip2's fill rule), by a search over
the per-piece output cumsum: ``block_cuts`` launches the D6 kernel
(ops/rle1_cuda.py, csrc/block_cuts.cu) for sums on a CUDA card and takes
the plain loop, ``block_cuts_ref``, for sums on the CPU.

JAX's ``.at[...].set(..., mode="drop")`` drops out-of-range indices, where
torch raises; here masked entries go to one spare slot past the end,
which is then cut off.
"""

from __future__ import annotations

import torch

from bz2tpu_torch.format import constants as C
from bz2tpu_torch.ops import rle1_cuda

_BIG = 2**31 - 1


def out_capacity(n: int) -> int:
    """Worst-case RLE1 output size for n input bytes (5/4 growth)."""
    return n + n // 4 + 8


def rle1_encode(data: torch.Tensor, length: int) -> dict[str, torch.Tensor]:
    """RLE1-encode data[:length].

    data: (N,) uint8, anything past ``length``. Returns dict with out
    (out_capacity(N),) uint8, out_len (0-dim int32), piece_out_cum and
    piece_raw_cum (N,) int32 inclusive per-piece output / raw cumsums
    (INT32_MAX past n_pieces, so a searchsorted gives greedy cuts), and
    n_pieces (0-dim int32).
    """
    n = data.shape[0]
    dev = data.device
    no = out_capacity(n)
    i32 = torch.int32
    idx = torch.arange(n, dtype=i32, device=dev)
    valid = idx < length
    d = torch.where(valid, data.to(i32), -1)
    prev = torch.cat([torch.full((1,), -2, dtype=i32, device=dev), d[:-1]])
    change = valid & (d != prev)

    run_start = torch.cummax(torch.where(change, idx, -1), 0).values
    off_in_run = idx - run_start
    piece_in_run = off_in_run // 255
    off_in_piece = off_in_run % 255
    piece_head = valid & (off_in_piece == 0)
    piece_id = torch.cumsum(piece_head.to(i32), 0, dtype=i32) - 1

    # run_end[i] = first run head after i (or length).
    nxt = torch.where(change, idx, _BIG)
    after = torch.cat([nxt[1:], torch.full((1,), _BIG, dtype=i32, device=dev)])
    run_end = torch.cummin(after.flip(0), 0).values.flip(0).clamp(max=length)
    piece_start = run_start + 255 * piece_in_run
    piece_end = torch.minimum(piece_start + 255, run_end)
    piece_raw = piece_end - piece_start
    piece_out = torch.where(piece_raw >= C.RLE1_MIN_RUN, 5, piece_raw)

    # Literals for offsets 0..3; a piece's count byte rides with offset 3.
    lit_mask = valid & (off_in_piece < C.RLE1_MIN_RUN)
    cnt_mask = valid & (off_in_piece == C.RLE1_MIN_RUN - 1)
    contrib = lit_mask.to(i32) + cnt_mask.to(i32)
    cum = torch.cumsum(contrib, 0, dtype=i32)
    out_pos = cum - contrib
    out_len = cum[-1] if n else torch.zeros((), dtype=i32, device=dev)

    out = torch.zeros(no + 1, dtype=torch.uint8, device=dev)
    out[torch.where(lit_mask, out_pos, no).long()] = data
    out[torch.where(cnt_mask, out_pos + 1, no).long()] = (piece_raw - C.RLE1_MIN_RUN).to(torch.uint8)

    piece_out_cum = torch.full((n + 1,), _BIG, dtype=i32, device=dev)
    piece_out_cum[torch.where(piece_head, piece_id, n).long()] = out_pos + piece_out
    piece_raw_cum = torch.full((n + 1,), _BIG, dtype=i32, device=dev)
    piece_raw_cum[torch.where(piece_head, piece_id, n).long()] = piece_end
    return {
        "out": out[:no],
        "out_len": out_len,
        "piece_out_cum": piece_out_cum[:n],
        "piece_raw_cum": piece_raw_cum[:n],
        "n_pieces": piece_head.sum(dtype=i32),
    }


def block_cuts_ref(
    piece_out_cum: torch.Tensor,
    piece_raw_cum: torch.Tensor,
    n_pieces: torch.Tensor,
    *,
    cap: int,
    max_blocks: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of block_cuts: one searchsorted and a few selects a
    block, issued from the host."""
    dev = piece_out_cum.device
    i32 = torch.int32
    last = (n_pieces - 1).clamp(min=0).long()
    total_out = torch.where(n_pieces > 0, piece_out_cum[last], 0)
    out_base = torch.zeros((), dtype=i32, device=dev)
    prev_raw = torch.zeros((), dtype=i32, device=dev)
    n_blocks = torch.zeros((), dtype=i32, device=dev)
    out_cuts, raw_cuts = [], []
    for _ in range(max_blocks):
        active = out_base < total_out
        hi = torch.searchsorted(piece_out_cum, (out_base + cap).reshape(1)).reshape(())
        hi = torch.minimum(hi.to(i32), n_pieces - 1).clamp(min=0).long()
        out_base = torch.where(active, piece_out_cum[hi], out_base)
        prev_raw = torch.where(active, piece_raw_cum[hi], prev_raw)
        out_cuts.append(out_base)
        raw_cuts.append(prev_raw)
        n_blocks = n_blocks + active.to(i32)
    return torch.stack(out_cuts), torch.stack(raw_cuts), n_blocks


def block_cuts(
    piece_out_cum: torch.Tensor,
    piece_raw_cum: torch.Tensor,
    n_pieces: torch.Tensor,
    *,
    cap: int,
    max_blocks: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stock bzip2's block-fill rule at piece boundaries: a block takes
    pieces through the first one whose cumulative output reaches ``cap``
    (it overshoots by up to 4 bytes), or the rest when none does.

    piece_out_cum, piece_raw_cum: (N,) int32 as rle1_encode gives them,
    N >= 1; n_pieces: 0-dim int32, all on one device; max_blocks >= 1.
    Returns (out_cuts, raw_cuts, n_blocks) on that device: block b covers
    output bytes [out_cuts[b-1], out_cuts[b]) and raw bytes [raw_cuts[b-1],
    raw_cuts[b]) with an implicit leading 0; unused slots repeat the final
    cut. CPU sums take the plain version; CUDA sums launch the kernel, which
    reads n_pieces on the card (no host sync).
    """
    for name, t in (("piece_out_cum", piece_out_cum), ("piece_raw_cum", piece_raw_cum)):
        if (t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] == 0 or t.shape != piece_out_cum.shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous non-empty (N,) int32 tensor like piece_out_cum, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if n_pieces.dtype != torch.int32 or n_pieces.dim() != 0:
        raise ValueError(f"n_pieces must be a 0-dim int32 tensor, got {n_pieces.dtype} {tuple(n_pieces.shape)}")
    if max_blocks < 1:
        raise ValueError(f"max_blocks must be at least 1, got {max_blocks}")
    dev = piece_out_cum.device
    if piece_raw_cum.device != dev or n_pieces.device != dev:
        raise ValueError("piece_out_cum, piece_raw_cum and n_pieces must lie on one device")
    if dev.type == "cpu":
        return block_cuts_ref(piece_out_cum, piece_raw_cum, n_pieces, cap=cap, max_blocks=max_blocks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return rle1_cuda.block_cuts(piece_out_cum, piece_raw_cum, n_pieces, cap=cap, max_blocks=max_blocks)
