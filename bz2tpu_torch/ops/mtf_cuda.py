"""K3: the MTF rank scan (CUDA, csrc/mtf_ranks.cu) beside its plain torch
version.

Port of bz2tpu/ops/mtf_pallas.py:mtf_ranks_pallas over a whole batch: the
rank of position t is the number of lanes whose last occurrence before t
is later than that of t's own symbol, with never-seen lanes at virtual
times -(lane + 1) (the initial list order) and unused lanes far below.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build

CHUNK = 2048  # positions per (block, chunk) slot, as the TPU kernel's tile
_NEG = -(1 << 30)

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"mtf_ranks": 0}


def mtf_ranks_ref(
    seq: torch.Tensor, n_in_use: torch.Tensor, m: torch.Tensor, chunk: int = CHUNK
) -> torch.Tensor:
    """Plain version of K3, chunk by chunk over the whole batch with a
    carried (B, 256) last-occurrence vector. Ranks at and past m are 0."""
    B, cap = seq.shape
    dev = seq.device
    lanes = torch.arange(256, dtype=torch.int64, device=dev)
    carry = torch.where(lanes[None, :] < n_in_use[:, None], -(lanes + 1)[None, :], _NEG)
    ranks = torch.zeros(B, cap, dtype=torch.int32, device=dev)
    for start in range(0, int(m.max()), chunk):
        seg = seq[:, start : start + chunk].to(torch.int64)  # (B, T)
        T = seg.shape[1]
        times = torch.arange(start, start + T, dtype=torch.int64, device=dev)
        onehot = torch.where(seg[:, :, None] == lanes, times[None, :, None], _NEG)
        incl = torch.cummax(onehot, dim=1).values  # (B, T, 256)
        before = torch.cat(
            [torch.full_like(incl[:, :1], _NEG), incl[:, :-1]], dim=1
        )
        last = torch.maximum(carry[:, None, :], before)
        own = last.gather(2, seg.clamp(0, 255)[:, :, None])
        r = (last > own).sum(dim=2)
        live = times[None, :] < m[:, None]
        ranks[:, start : start + T] = torch.where(live, r, 0).to(torch.int32)
        carry = torch.maximum(carry, incl[:, -1])
    return ranks


def mtf_ranks(
    seq: torch.Tensor, n_in_use: torch.Tensor, m: torch.Tensor, chunk: int = CHUNK
) -> torch.Tensor:
    """MTF ranks of a batch of collapsed dense sequences.

    seq: (B, cap) int32, symbols in [0, n_in_use) with adjacent entries
    distinct, -1 past m. n_in_use, m: (B,) int32. Returns (B, cap) int32,
    0 at and past m.
    """
    if seq.dtype != torch.int32 or seq.dim() != 2 or not seq.is_contiguous():
        raise ValueError(f"seq must be a contiguous (B, cap) int32 tensor, got {seq.dtype} {tuple(seq.shape)}")
    B = seq.shape[0]
    for name, t in (("n_in_use", n_in_use), ("m", m)):
        if t.dtype != torch.int32 or t.shape != (B,) or t.device != seq.device:
            raise ValueError(f"{name} must be a ({B},) int32 tensor on {seq.device}")
    if not 1 <= chunk <= 4096:
        raise ValueError(f"chunk must be in 1..4096, got {chunk}")
    if seq.device.type == "cpu":
        return mtf_ranks_ref(seq, n_in_use, m, chunk)
    if seq.device.type != "cuda":
        raise ValueError(f"unsupported device {seq.device}")
    lib = _build.lib()
    cap = seq.shape[1]
    n_in_use = n_in_use.contiguous()
    m = m.contiguous()
    ranks = torch.empty_like(seq)
    scratch = torch.empty(lib.bz2t_mtf_scratch(B, cap, chunk), dtype=torch.int32, device=seq.device)
    stream = torch.cuda.current_stream(seq.device).cuda_stream
    err = lib.bz2t_mtf_ranks(
        seq.data_ptr(), n_in_use.data_ptr(), m.data_ptr(), B, cap, chunk,
        ranks.data_ptr(), scratch.data_ptr(), stream,
    )
    _build.check(err, "mtf_ranks")
    LAUNCHES["mtf_ranks"] += 1
    return ranks
