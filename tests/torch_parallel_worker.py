"""One rank of a bz2tpu_torch.parallel job on the CPU over gloo, started
by tests/test_torch_parallel.py (S of these form the group). It imports
torch and bz2tpu_torch only.

    python tests/torch_parallel_worker.py PORT S RANK OUT_DIR data FILE LEVEL
    python tests/torch_parallel_worker.py PORT S RANK OUT_DIR words NPZ
    python tests/torch_parallel_worker.py PORT S RANK OUT_DIR compress FILE LEVEL PARALLEL API

``data``: split FILE at LEVEL, encode the batch (padded to a multiple of
S) with encode_blocks_sharded, stitch this rank's rows with
stitch_stream_shard, gather the shards with gather_blocks and stitch them
again with stitch_stream_sharded on the whole mesh and on a mesh of its
first S // 2 ranks; every stream must agree. ``words``: stitch each case
of per-block words, bits and CRCs in NPZ (keys words_i, bits_i, crcs_i,
live_i, level_i) with stitch_stream_sharded. Each rank writes its streams
to OUT_DIR/stream_<case>.<rank>; rank 0 writes the gathered shards to
OUT_DIR/gathered.npz. ``compress``: the public entry point with
compressor._DEVICE_STITCH off, so that the block mesh is reached through
it: API ``compress`` calls compress(FILE's bytes, LEVEL, PARALLEL), API
``stream`` compress_stream of FILE, API ``fail`` raises on rank 1 before
compress (the other ranks must fail, not hang); each rank writes its
stream to OUT_DIR/stream_compress.<rank> and the number of
encode_blocks_sharded calls it made on the group's mesh (a one-rank mesh
has no group) to OUT_DIR/mesh_calls.<rank>.
"""

import io
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from bz2tpu_torch.format import constants as C
from bz2tpu_torch.parallel import block_mesh, encode_blocks_sharded, gather_blocks, pad_batch
from bz2tpu_torch.parallel.distributed import initialize, is_primary
from bz2tpu_torch.parallel.stitch import stitch_stream_shard, stitch_stream_sharded
from bz2tpu_torch.runtime.compressor import split_blocks


def encode_and_stitch(mesh, path: str, level: int, out_dir: Path) -> None:
    blocks = split_blocks(Path(path).read_bytes(), level)
    n_live = len(blocks)
    B = pad_batch(n_live, mesh.size)
    batch = np.zeros((B, C.block_capacity(level) + 4), np.uint8)
    ns = np.ones(B, np.int32)  # padding rows: one-byte blocks
    crcs = np.zeros(B, np.int64)
    for i, blk in enumerate(blocks):
        batch[i, : blk.data.size] = blk.data
        ns[i] = blk.data.size
        crcs[i] = blk.crc
    out = encode_blocks_sharded(batch, ns, crcs, mesh=mesh)
    rows = mesh.rows(B)
    live = max(0, min(rows.stop - rows.start, n_live - rows.start))
    bits = out["total_bits"].clone()
    bits[live:] = 0
    stream, _ = stitch_stream_shard(out["words"], bits, torch.as_tensor(crcs[rows]), live, level, mesh=mesh)

    gathered = gather_blocks(out, mesh)
    all_bits = gathered["total_bits"].clone()
    all_bits[n_live:] = 0
    again, _ = stitch_stream_sharded(gathered["words"], all_bits, crcs, n_live, level, mesh=mesh)
    assert again == stream, "stitch_stream_sharded of the gathered shards differs"
    half = block_mesh(max(1, mesh.size // 2), device="cpu")
    assert (half is None) == (mesh.rank >= max(1, mesh.size // 2))
    if half is not None:
        sub, _ = stitch_stream_sharded(gathered["words"], all_bits, crcs, n_live, level, mesh=half)
        assert sub == stream, "the stream stitched on the half mesh differs"
    (out_dir / f"stream_data.{mesh.rank}").write_bytes(stream)
    if is_primary():
        np.savez(out_dir / "gathered.npz", **{k: v.numpy() for k, v in gathered.items()})


def stitch_cases(mesh, path: str, out_dir: Path) -> None:
    cases = np.load(path)
    for i in range(len(cases.files) // 5):
        stream, _ = stitch_stream_sharded(
            cases[f"words_{i}"], cases[f"bits_{i}"], cases[f"crcs_{i}"],
            int(cases[f"live_{i}"]), int(cases[f"level_{i}"]), mesh=mesh,
        )
        (out_dir / f"stream_{i}.{mesh.rank}").write_bytes(stream)


def compress_through_the_entry_point(rank: int, path: str, level: int, parallel: int, api: str,
                                     out_dir: Path) -> None:
    from bz2tpu_torch.parallel import mesh as mesh_module
    from bz2tpu_torch.runtime import compressor, stream

    calls = []
    real = mesh_module.encode_blocks_sharded

    def counted(*a, mesh, **k):
        if mesh.group is not None:
            calls.append(1)
        return real(*a, mesh=mesh, **k)

    mesh_module.encode_blocks_sharded = counted
    compressor._DEVICE_STITCH = False
    data = Path(path).read_bytes()
    if api == "fail" and rank == 1:
        raise RuntimeError("rank 1 fails before compress")
    if api == "stream":
        sink = io.BytesIO()
        stream.compress_stream(io.BytesIO(data), sink, level=level, parallel=parallel, device="cpu")
        out = sink.getvalue()
    else:
        out = compressor.compress(data, level=level, parallel=parallel, device="cpu")
    (out_dir / f"stream_compress.{rank}").write_bytes(out)
    (out_dir / f"mesh_calls.{rank}").write_text(str(len(calls)))


def main(argv: list[str]) -> int:
    port, size, rank, out_dir, mode, path = argv[:6]
    torch.set_num_threads(1)
    initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=int(size),
               process_id=int(rank), backend="gloo", timeout_s=60)
    mesh = block_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (int(rank), int(size)), mesh
    if mode == "data":
        encode_and_stitch(mesh, path, int(argv[6]), Path(out_dir))
    elif mode == "compress":
        compress_through_the_entry_point(mesh.rank, path, int(argv[6]), int(argv[7]), argv[8], Path(out_dir))
    else:
        stitch_cases(mesh, path, Path(out_dir))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
