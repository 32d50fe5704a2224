"""Block-size levels 2-8 through bz2tpu_torch.compress on the CPU path:
byte-identical to bz2tpu's NumPy oracle (and, at level 5, to
bz2tpu.compress on JAX-CPU), decoded by stdlib bz2. Levels 1 and 9 are
covered by tests/test_torch_compress.py; tests/test_torch_cuda.py holds
level 5 on the card against this path.

Each input is just over one block after RLE1: random picks from a
vocabulary of 3,000 random words, so repeats are short (few doubling
rounds in the BWT) and the BWT output has runs (a short MTF on the CPU);
the second block is small and the level's full block capacity is
exercised.
"""

import bz2 as stdlib_bz2

import numpy as np
import pytest
import torch

import bz2tpu_torch
from bz2tpu.oracle import compress as oracle_compress
from bz2tpu_torch import native
from bz2tpu_torch.format import constants as C



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs in several
    worker processes, and torch's default of one thread a core in each
    oversubscribes the machine and slows every worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def level_input(level: int) -> bytes:
    rng = np.random.default_rng(750 + level)
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)), dtype=np.uint8)) + b" " for _ in range(3000)]
    cap = C.block_capacity(level)
    return b"".join(vocab[i] for i in rng.integers(0, len(vocab), cap // 3))[: cap + 777]


@pytest.mark.parametrize("level", range(2, 9))
def test_level_matches_oracle(level):
    data = level_input(level)
    out = bz2tpu_torch.compress(data, level=level, device="cpu")
    assert out[:4] == b"BZh%d" % level
    assert out == oracle_compress(data, level=level)
    if level == 5:
        pytest.importorskip("jax")
        from bz2tpu.runtime.compressor import compress as jax_compress

        assert out == jax_compress(data, level=level)
    assert stdlib_bz2.decompress(out) == data
    if native.HAVE_NATIVE:
        headers, _ = native.scan_blocks(out)
        assert len(headers) == 2  # one full block and the tail
