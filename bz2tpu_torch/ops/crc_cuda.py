"""crc_ranges: the CRC-32/BZIP2 of many byte ranges of one chunk (CUDA,
csrc/crc_ranges.cu).

The device intake's range CRCs (ops/crc.crc32_ranges) run in JAX as one
device program: a lax.fori_loop over the lanes' bytes, a Kogge-Stone fold
and the operator ladders' lax.fori_loop (bz2tpu/ops/crc.py:166, :176-183,
:111). In eager torch each step of them is a few ops issued from the
host, most of the 3,415 of an 8 MiB chunk's intake (tools/time_intake.py
on the H100), so the port runs the whole function in one
call of two kernels: every thread's 64 bytes through the byte table, the
states folded by scans, then each range's CRC from its endpoints'
states. It is a port-only kernel: it replaces device loops, not a
pl.pallas_call.

ops/crc.crc32_ranges checks the arguments and dispatches: the plain
version for a chunk on the CPU, this for one on a card.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"crc_ranges": 0}


def crc_ranges(chunk: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The kernel on chunk's card: (B,) int64 finalised CRCs of
    chunk[starts[b]:ends[b]] (arguments as ops/crc.crc32_ranges checks
    them; endpoints outside [0, N] are clamped into it)."""
    dev = chunk.device
    if dev.type != "cuda":
        raise ValueError(f"crc_ranges runs on a CUDA card, not {dev}")
    n, b = chunk.shape[0], starts.shape[0]
    crcs = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return crcs
    lib = _build.lib()
    words = lib.bz2t_crc_ranges_work(n, b)
    if words < 0:
        raise ValueError(f"a chunk of {n} bytes with {b} ranges is too large for crc_ranges")
    pts = torch.cat([starts, ends]).to(torch.int64)
    work = torch.empty(words, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.bz2t_crc_ranges(chunk.data_ptr(), n, pts.data_ptr(), b, work.data_ptr(), crcs.data_ptr(), stream)
    _build.check(err, "crc_ranges")
    LAUNCHES["crc_ranges"] += 1
    return crcs
