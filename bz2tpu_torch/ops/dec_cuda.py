"""dec_chain: the serial chain of Huffman group starts (CUDA,
csrc/dec_chain.cu) beside its plain torch loop.

Step 3 of the jump-map decode (ops/huffman_dec.py): group g of block b
starts where 50 symbols of table tbl[b, g] from the start of group g - 1
end, cur <- jump50[b, tbl[b, g], cur]. The JAX form runs it as a device
lax.fori_loop (bz2tpu/ops/huffman_dec.py:231-239); in eager torch a loop
of up to 18,002 steps of dependent gathers per bucket is bound by the
host's launch pace, so the port walks it in one kernel. It is a port-only
kernel: it replaces a fori_loop, not a pl.pallas_call.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"dec_chain": 0}


def group_starts_ref(jump50: torch.Tensor, tbl: torch.Tensor, n_groups: torch.Tensor) -> torch.Tensor:
    """Plain version: the chain as a loop over the G groups of the batch.
    Entries at and past a block's n_groups repeat its final position."""
    B, T, nbc = jump50.shape
    G = tbl.shape[1]
    flat = jump50.reshape(-1)
    row = torch.arange(B, dtype=torch.int64, device=jump50.device) * T
    tbl = tbl.to(torch.int64)
    cur = torch.zeros(B, dtype=torch.int64, device=jump50.device)
    starts = []
    for g in range(G):
        starts.append(cur)
        nxt = flat[(row + tbl[:, g]) * nbc + cur.clamp(0, nbc - 1)].to(torch.int64)
        cur = torch.where(g < n_groups, nxt, cur)
    if not starts:
        return torch.zeros(B, 0, dtype=torch.int32, device=jump50.device)
    return torch.stack(starts, 1).to(torch.int32)


def group_starts(jump50: torch.Tensor, tbl: torch.Tensor, n_groups: torch.Tensor) -> torch.Tensor:
    """Start bit (relative) of every Huffman group of a batch of blocks.

    jump50: (B, T, nbc) int32 50-symbol jump maps; tbl: (B, G) int32
    table per group, in [0, T); n_groups: (B,) int32, at most G. Returns
    (B, G) int32.
    """
    if jump50.dtype != torch.int32 or jump50.dim() != 3 or not jump50.is_contiguous():
        raise ValueError(f"jump50 must be a contiguous (B, T, nbc) int32 tensor, got {jump50.dtype} {tuple(jump50.shape)}")
    B, T, nbc = jump50.shape
    if tbl.dtype != torch.int32 or tbl.dim() != 2 or tbl.shape[0] != B or not tbl.is_contiguous() or tbl.device != jump50.device:
        raise ValueError(f"tbl must be a contiguous ({B}, G) int32 tensor on {jump50.device}")
    if n_groups.dtype != torch.int32 or n_groups.shape != (B,) or n_groups.device != jump50.device:
        raise ValueError(f"n_groups must be a ({B},) int32 tensor on {jump50.device}")
    if jump50.device.type == "cpu":
        return group_starts_ref(jump50, tbl, n_groups)
    if jump50.device.type != "cuda":
        raise ValueError(f"unsupported device {jump50.device}")
    lib = _build.lib()
    G = tbl.shape[1]
    starts = torch.empty(B, G, dtype=torch.int32, device=jump50.device)
    stream = torch.cuda.current_stream(jump50.device).cuda_stream
    err = lib.bz2t_dec_chain(
        jump50.data_ptr(), tbl.data_ptr(), n_groups.contiguous().data_ptr(),
        B, T, nbc, G, starts.data_ptr(), stream,
    )
    _build.check(err, "dec_chain")
    LAUNCHES["dec_chain"] += 1
    return starts
