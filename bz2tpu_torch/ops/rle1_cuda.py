"""block_cuts: stock bzip2's block-fill rule over a chunk's RLE1 pieces
(CUDA, csrc/block_cuts.cu).

The device intake's greedy cuts (ops/rle1.block_cuts) run in JAX as a
device lax.fori_loop of max_blocks steps, each a searchsorted over the
per-piece output sums (bz2tpu/ops/rle1.py:162, body :141-160); in eager
torch each step is a handful of launches from the host. The port runs
all of them in one launch of one CTA: a warp a cut searches where the cut
can land (a piece's output is at most 5 bytes, so a cut overshoots its
target by at most 4) and loads that window of sums into shared memory,
then one warp walks the chain of cuts there; n_pieces is read on the
card. A cut whose answer lies outside its window (sums with steps above
5 or duplicates) searches the rest of the array, which ``with_slow``
counts. It is a port-only kernel: it replaces a device loop, not a
pl.pallas_call.

ops/rle1.block_cuts checks the arguments and dispatches: the plain loop
for sums on the CPU, this for sums on a card.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"block_cuts": 0}


def block_cuts(
    piece_out_cum: torch.Tensor, piece_raw_cum: torch.Tensor, n_pieces: torch.Tensor, *, cap: int, max_blocks: int,
    with_slow: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The kernel on the sums' card: (out_cuts, raw_cuts, n_blocks), int32,
    as ops/rle1.block_cuts (which checks the arguments) returns them; with
    ``with_slow``, also a 0-dim int32 count of the cuts that searched past
    their window."""
    dev = piece_out_cum.device
    if dev.type != "cuda":
        raise ValueError(f"block_cuts runs on a CUDA card, not {dev}")
    out_cuts = torch.empty(max_blocks, dtype=torch.int32, device=dev)
    raw_cuts = torch.empty(max_blocks, dtype=torch.int32, device=dev)
    n_blocks = torch.empty((), dtype=torch.int32, device=dev)
    slow = torch.empty((), dtype=torch.int32, device=dev) if with_slow else None
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.bz2t_block_cuts(piece_out_cum.data_ptr(), piece_raw_cum.data_ptr(), piece_out_cum.shape[0],
                              n_pieces.data_ptr(), cap, max_blocks, out_cuts.data_ptr(), raw_cuts.data_ptr(),
                              n_blocks.data_ptr(), None if slow is None else slow.data_ptr(), stream)
    _build.check(err, "block_cuts")
    LAUNCHES["block_cuts"] += 1
    return (out_cuts, raw_cuts, n_blocks) if slow is None else (out_cuts, raw_cuts, n_blocks, slow)
