"""Stage state across the two packages.

The codec has no weights; what crosses between bz2tpu (JAX) and
bz2tpu_torch is each stage's state: the BWT output, the RLE2 plan dict and
the Huffman plan dict. ``from_jax`` takes such a tree as numpy arrays (as
``jax.device_get`` or ``np.asarray`` gives them) and returns the port's
tensors under the same keys; ``to_jax`` is its inverse.

Dtypes map one to one: int32, uint8 and bool stay as they are, and uint32
(CRCs, packed words) becomes int64, the port's carrier for 32-bit
unsigned values, and back.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax(tree: dict) -> dict[str, torch.Tensor]:
    out = {}
    for key, value in tree.items():
        arr = np.asarray(value)
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def to_jax(tree: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        arr = value.cpu().numpy()
        if arr.dtype == np.int64:
            arr = arr.astype(np.uint32)
        out[key] = arr
    return out
