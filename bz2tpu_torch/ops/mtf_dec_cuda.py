"""mtf_dec: each 128-literal chunk's inverse-MTF permutation and local
emits (CUDA, csrc/mtf_dec.cu) beside its plain torch loop.

The inverse MTF of ops/mtf_dec.py composes "move list entry j to the
front" over a block's literals in two levels: within each chunk of 128
literals, step by step from the identity, then across chunks by a scan of
the chunk permutations. The JAX form runs the first level as a device
lax.fori_loop of 128 steps (bz2tpu/ops/mtf_dec.py:100-112); in eager torch
each step is some 8 launches over the whole (B, m / 128, 256) uint8 state,
so the port runs all of it in one kernel: a warp takes two chunks, each
lane 16 entries of a list in four 32-bit registers, and stops after the
last nonzero index of both (a zero index moves nothing and emits the
list's front). It is a port-only kernel: it replaces a fori_loop, not a
pl.pallas_call.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build

CHUNK = 128  # literals per permutation chunk, as bz2tpu.ops.mtf_dec._CHUNK
WARP_CHUNKS = 2  # chunks a warp of csrc/mtf_dec.cu walks together

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"mtf_dec": 0}


def chunk_perms_ref(js: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the 128-step loop over all chunks of the batch at once."""
    B, m = js.shape
    dev = js.device
    n_chunks = m // CHUNK
    jc = js.long().view(B, n_chunks, CHUNK)
    k256 = torch.arange(256, device=dev)
    q = k256.to(torch.uint8).expand(B, n_chunks, 256).clone()
    emit = torch.zeros(B, n_chunks, CHUNK, dtype=torch.uint8, device=dev)
    for i in range(CHUNK):
        j = jc[:, :, i : i + 1]  # (B, n_chunks, 1)
        e = q.gather(2, j)
        emit[:, :, i : i + 1] = e
        q = torch.where(k256 == 0, e, torch.where(k256 <= j, torch.roll(q, 1, 2), q))
    return q, emit


def chunk_perms(js: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk permutations and local emits of a batch's literal move indices.

    js: (B, m) uint8, m a multiple of 128: row b holds block b's literals'
    move indices (symbol - 1) in order, then 0 (the identity) as padding.
    Returns q (B, m / 128, 256) uint8, each chunk's list after its 128
    moves starting from the identity, and emit (B, m / 128, 128) uint8,
    the entry each literal took from the list as its chunk found it.
    """
    if js.dtype != torch.uint8 or js.dim() != 2 or not js.is_contiguous():
        raise ValueError(f"js must be a contiguous (B, m) uint8 tensor, got {js.dtype} {tuple(js.shape)}")
    B, m = js.shape
    if m % CHUNK:
        raise ValueError(f"m={m} must be a multiple of {CHUNK}")
    dev = js.device
    if dev.type == "cpu":
        return chunk_perms_ref(js)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if js.data_ptr() % 16:
        raise ValueError("js must start on a 16-byte boundary (each lane reads four indices at once)")
    lib = _build.lib()
    n_chunks = m // CHUNK
    q = torch.empty(B, n_chunks, 256, dtype=torch.uint8, device=dev)
    emit = torch.empty(B, n_chunks, CHUNK, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.bz2t_mtf_dec(js.data_ptr(), B * n_chunks, q.data_ptr(), emit.data_ptr(), stream)
    _build.check(err, "mtf_dec")
    LAUNCHES["mtf_dec"] += 1
    return q, emit
