"""Mesh layer: block-data-parallel compression over torch.distributed.

Port of bz2tpu/parallel/. Each bzip2 block is self-contained, so a job of
S ranks, one per device, splits a batch of blocks by rank and encodes each
rank's rows on its own card with no communication (mesh.py); the only
collectives assemble the result: the ordered gather of per-block streams
(``gather_blocks``) and the stitch of the whole .bz2 stream from every
rank's segment (stitch.py). distributed.py starts the process group.
"""

from bz2tpu_torch.parallel.mesh import (  # noqa: F401
    BlockMesh,
    block_mesh,
    encode_blocks_sharded,
    gather_blocks,
    pad_batch,
)
