"""The block mesh and the sharded block encode.

Port of bz2tpu/parallel/mesh.py onto torch.distributed. JAX shards the
block batch over a 1-D ("blocks",) device mesh with shard_map; here each
rank of a process group is one device of the mesh: every rank holds the
same global (B, cap) batch, encodes its contiguous B / S rows on its own
device (ops/pipeline.encode_blocks, which runs K1, K2, K3 and D2 on a
card) and keeps its shard, as a sharded jax.Array keeps one per device.
Encoding needs no communication. ``gather_blocks`` is the ordered gather
(rank order is block order); stitch.py assembles the stream from the
shards without it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from bz2tpu_torch.ops.pipeline import encode_blocks
from bz2tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class BlockMesh:
    """One rank's view of a 1-D mesh of ``size`` ranks, each with one
    device. ``group`` is None for a one-rank mesh with no process group."""

    group: dist.ProcessGroup | None
    rank: int
    size: int
    device: torch.device

    def rows(self, n_rows: int) -> slice:
        """This rank's contiguous rows of a batch of ``n_rows``."""
        if n_rows % self.size:
            raise ValueError(f"batch {n_rows} is not divisible by {self.size} ranks")
        per = n_rows // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def _rank_device(rank: int, device) -> torch.device:
    """``device`` when given; else cuda:{LOCAL_RANK} where the launcher
    sets it, and cuda:{rank % device count} where it does not. Raises
    where CUDA is missing."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None else rank % torch.cuda.device_count())


def block_mesh(n_devices: int | None = None, device=None) -> BlockMesh | None:
    """The 1-D mesh over the default process group, or over its first
    ``n_devices`` ranks (a new group, which every rank must create, so every
    rank calls this; ranks outside it get None). With no process group, a
    one-rank mesh, where ``n_devices`` must be None or 1."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs an initialised process group")
        return BlockMesh(None, 0, 1, _rank_device(0, device))
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        group = dist.group.WORLD
    elif 1 <= n_devices < world:
        group = dist.new_group(list(range(n_devices)))
    else:
        raise ValueError(f"a mesh of {n_devices} devices in a group of {world} ranks")
    rank = dist.get_rank()
    if rank >= (n_devices or world):
        return None
    return BlockMesh(group, rank, n_devices or world, _rank_device(rank, device))


def pad_batch(n_blocks: int, n_shards: int, batch_per_shard: int | None = None) -> int:
    """Smallest total batch >= n_blocks divisible by the shard count."""
    if batch_per_shard is not None:
        return n_shards * batch_per_shard
    return ((n_blocks + n_shards - 1) // n_shards) * n_shards


def encode_blocks_sharded(blocks, ns, crcs=None, *, mesh: BlockMesh, timings: dict | None = None) -> dict:
    """This rank's shard of a batch encode.

    blocks (B, cap) uint8, ns (B,) and crcs (B,) (uint32 values; zeros
    when omitted, which only suits callers that ignore the block CRC
    fields) are the same global batch on every rank, on any device or as
    arrays; B is divisible by the mesh size, and padding rows have ns = 1.
    The rank moves its ``mesh.rows(B)`` to ``mesh.device`` and returns
    ops/pipeline.encode_blocks of them (``timings`` as there).
    """
    rows = mesh.rows(len(blocks))
    if crcs is None:
        crcs = torch.zeros(len(blocks), dtype=torch.int64)
    return encode_blocks(
        torch.as_tensor(blocks)[rows].to(mesh.device),
        torch.as_tensor(ns)[rows].to(mesh.device, torch.int32),
        torch.as_tensor(crcs)[rows].to(mesh.device, torch.int64),
        timings=timings,
    )


def gather_ints(values: list[int], mesh: BlockMesh) -> list[list[int]]:
    """Every rank's short list of ints, in rank order (a small all-gather
    whose values size host-side buffers, so it is read on the host). Its
    tensor lives on the host, unless the group's backend takes only device
    tensors (NCCL)."""
    if mesh.group is None:
        return [list(values)]
    dev = mesh.device if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu")
    mine = torch.tensor(values, dtype=torch.int64, device=dev)
    every = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(every, mine, group=mesh.group)
    return [e.tolist() for e in every]


def all_gather_padded(t: torch.Tensor, mesh: BlockMesh, shapes: list[list[int]] | None = None):
    """Every rank's ``t`` in rank order, on ``t``'s device, and every
    rank's shape (gathered here unless the caller knows them). The list
    form of all_gather needs one shape on every rank, so each piece comes
    zero-padded in every dimension to the largest rank's. Bool travels as
    uint8."""
    if mesh.group is None:
        return [t], [list(t.shape)]
    if shapes is None:
        shapes = gather_ints(list(t.shape), mesh)
    big = [max(s[d] for s in shapes) for d in range(t.dim())]
    send = t.to(torch.uint8) if t.dtype == torch.bool else t
    pads = [p for d in reversed(range(t.dim())) for p in (0, big[d] - t.shape[d])]
    send = torch.nn.functional.pad(send, pads).contiguous()
    recv = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(recv, send, group=mesh.group)
    return [r.to(t.dtype) for r in recv], shapes


def gather_blocks(out: dict, mesh: BlockMesh) -> dict:
    """The ordered gather of every rank's shard (what np.asarray of JAX's
    sharded output is): each tensor all-gathered in rank order and
    concatenated along the rows, the words zero-padded to the widest
    rank's Wb. With one rank, ``out`` itself."""
    if mesh.group is None:
        return out
    gathered = {}
    for key, t in out.items():
        parts, shapes = all_gather_padded(t, mesh)
        gathered[key] = torch.cat([p[: s[0]] for p, s in zip(parts, shapes)])
    return gathered
