"""Multi-process initialisation on torch.distributed.

Port of bz2tpu/parallel/distributed.py. A multi-process bz2tpu_torch run
is plain SPMD: every process runs the same program on its own device,
feeds its rows of the block batch, and the stream assembles by collectives
(stitch.py). The collective backend is the caller's to name: NCCL (the
default) for one process per card; gloo where NCCL cannot run, as for two
processes that share one card.
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch.distributed as dist

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "nccl",
    timeout_s: float = 300,
) -> None:
    """Initialise the default process group.

    ``num_processes == 1`` returns at once. Explicit arguments
    (``coordinator_address`` as ``host:port``) initialise over TCP and let
    every error through, a coordinator that never answers included, after
    ``timeout_s``. With no arguments the group initialises from the
    environment where MASTER_ADDR, WORLD_SIZE and RANK are set (as torchrun
    sets them); where they are not, the run carries on in ONE process with
    a loud RuntimeWarning, so that a misconfigured job does not compress
    on a fraction of its hosts unnoticed.
    """
    if num_processes == 1:
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    if any(v is not None for v in (coordinator_address, num_processes, process_id)):
        dist.init_process_group(
            backend,
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
            timeout=timeout,
        )
        return
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        warnings.warn(
            f"torch.distributed environment not set ({', '.join(missing)} missing); "
            "continuing SINGLE-PROCESS. If this process is part of a multi-process "
            "run, launch it with torchrun or pass coordinator_address/num_processes/"
            "process_id explicitly.",
            RuntimeWarning,
            stacklevel=2,
        )
        return
    dist.init_process_group(backend, init_method="env://", timeout=timeout)


def is_primary() -> bool:
    """True on rank 0, and in a process with no group."""
    return not dist.is_initialized() or dist.get_rank() == 0
