"""Inputs of the decode kernels dec_symbols and mtf_dec shared by the CPU
tests (tests/test_torch_dec_redesign.py) and the card tests
(tests/test_torch_cuda.py): canonical Huffman tables whose codes reach 20
bits, the batch tensors decode_groups takes for them, and move-index rows
whose chunks end in zeros at every offset. Imports no JAX.
"""

import numpy as np
import torch

from bz2tpu_torch.ops import huffman_dec
from bz2tpu_torch.oracle.decoder import build_decode_tables


def deep_lengths(rng: np.random.Generator, alpha: int, max_len: int) -> np.ndarray:
    """Code lengths of a complete prefix code of ``alpha`` symbols whose
    longest codes have exactly ``max_len`` bits: a chain 1, 2, ...,
    max_len - 1, max_len, max_len, whose leaves are then split at random
    (never past max_len) until there are ``alpha``."""
    lengths = list(range(1, max_len)) + [max_len]
    lengths.append(max_len)
    while len(lengths) < alpha:
        short = [i for i, n in enumerate(lengths) if n < max_len]
        i = short[int(rng.integers(len(short)))]
        lengths[i] += 1
        lengths.append(lengths[i])
    return np.array(lengths[:alpha], np.int64)


def table_tensors(tables: list[np.ndarray], B: int, device) -> dict:
    """base (B, T, 21), perm (B, T, 258), lut (1 + T, 2^20) and lut_idx
    (B, T) for the code lengths ``tables``, every block using all T of them
    (LUT row 0 is the all-zero row of unused slots, as device_decode builds
    it)."""
    decoded = [build_decode_tables(lengths) for lengths in tables]
    _, base, perm, thr = huffman_dec.decode_tables_arrays(decoded)
    T = len(tables)
    thr_rows = np.concatenate([np.zeros((1, 21), np.int32), thr])
    lut = huffman_dec.build_len_luts(torch.from_numpy(thr_rows))

    def per_block(a):
        return torch.from_numpy(np.broadcast_to(a, (B, *a.shape)).copy()).to(device)

    return {
        "base": per_block(base),
        "perm": per_block(perm),
        "lut": lut.to(device),
        "lut_idx": per_block(np.arange(1, T + 1, dtype=np.int32)),
    }


def trailing_zero_rows(rng: np.random.Generator, n_chunks: int, hi: int = 256) -> np.ndarray:
    """(1, 128 n_chunks) uint8 move indices: chunk c holds random nonzero
    indices below ``hi`` up to offset c % 129 and zeros from there, so the
    chunks end in zeros at every offset 0..128 (128: no zero; 0: all zero)."""
    js = rng.integers(1, hi, (n_chunks, 128)).astype(np.uint8)
    for c in range(n_chunks):
        js[c, c % 129:] = 0
    return js.reshape(1, -1)
