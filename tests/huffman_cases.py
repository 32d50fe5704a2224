"""Symbol batches for the Huffman planning tests (no JAX, no conftest):
tests/test_torch_huffman.py holds the plain version of D2 against the JAX
package on them, tests/test_torch_cuda.py the kernel against the plain
version on the card.
"""

import numpy as np


def _synth_block(seed: int, kind: str, n: int, alpha: int) -> np.ndarray:
    """n RLE2-like symbols below alpha - 1, then the EOB alpha - 1."""
    rng = np.random.default_rng(seed)
    if kind == "zipf":
        x = np.minimum(rng.zipf(1.5, n) - 1, alpha - 2)
    elif kind == "mix":  # runs of 500 symbols, each from its own skewed law
        x = np.concatenate([rng.choice(alpha - 1, 500, p=rng.dirichlet(np.full(alpha - 1, 0.3)))
                            for _ in range(-(-n // 500))])[:n]
    else:
        x = rng.integers(0, alpha - 1, n)
    x = x.astype(np.int32)
    x[-1] = alpha - 1
    return x


def _deep_table_block() -> np.ndarray:
    """A block whose groups of symbols 0..19 (counts growing by 1.7x, dealt
    evenly over their groups) all fall to one table, five other regions
    of two symbols each holding the other tables: that table's tree is 19
    deep, so its refit needs cap retries."""
    rng = np.random.default_rng(7)
    a = np.repeat(np.arange(20), np.round(1.7 ** np.arange(20)).astype(int))
    a = a[np.argsort(np.arange(a.size) % -(-a.size // 50), kind="stable")]
    parts = [a] + [rng.integers(20 + 2 * j, 22 + 2 * j, 2500) for j in range(5)]
    return np.concatenate(parts + [[31]]).astype(np.int32)


def _deep_tables_block(regions: int = 3, k: int = 21) -> np.ndarray:
    """Regions of groups over one alphabet of k symbols, each region's
    counts growing by 1.7x a symbol (rotated, so each region's common
    symbols differ, and so does the seed table that takes its groups):
    each of `regions` tables gets one region's groups, a tree 21 deep that
    needs two cap retries."""
    w = np.round(1.7 ** np.arange(k)).astype(np.int64)
    parts = []
    for r in range(regions):
        counts = w[(np.arange(k) + k // regions * r) % k]
        counts[np.argmax(counts)] += -counts.sum() % 50  # whole groups
        a = np.repeat(np.arange(k), counts)
        parts.append(a[np.argsort(np.arange(a.size) % (a.size // 50), kind="stable")])
    return np.concatenate(parts + [[k]]).astype(np.int32)


# case -> (blocks as (symbols, alpha), iterations each block runs or None).
# No block stops at iteration 1: the fixed point needs i > 0.
_CASES = {
    "stops-at-2-3-4-5-and-32": lambda: (
        [(_synth_block(*a), a[3]) for a in [(1, "zipf", 3000, 60), (0, "mix", 3000, 20),
                                            (1, "mix", 3000, 20), (0, "zipf", 3000, 20),
                                            (96, "uniform", 26000, 258)]],
        [2, 3, 4, 5, 32]),
    # One group (n_sym < 50), alphabets 3 and 258, every table count 2..6.
    "table-counts-and-alphabets": lambda: (
        [(_synth_block(2, "zipf", 30, 3), 3), (_synth_block(3, "uniform", 199, 258), 258),
         (_synth_block(4, "mix", 200, 40), 40), (_synth_block(5, "zipf", 600, 258), 258),
         (_synth_block(6, "mix", 1200, 3), 3), (_synth_block(7, "uniform", 2400, 258), 258)],
        None),
    "cap-retries": lambda: ([(_deep_table_block(), 32)], None),
    "cap-retries-on-several-tables": lambda: ([(_deep_tables_block(), 22)], None),
    "alphabets-4-42-130-257": lambda: (
        [(_synth_block(8, "zipf", 3000, 4), 4), (_synth_block(9, "mix", 5000, 42), 42),
         (_synth_block(10, "uniform", 8000, 130), 130), (_synth_block(11, "zipf", 12000, 257), 257)],
        None),
}
PLAN_CASES = list(_CASES)


def plan_case(case: str):
    """(symbols (B, width) int32 padded with -1, n_sym, n_in_use (B,) int32,
    the iterations each block runs or None) of a case."""
    blocks, iters = _CASES[case]()
    width = max(x.size for x, _ in blocks) + 3
    sym = np.full((len(blocks), width), -1, np.int32)
    for i, (x, _) in enumerate(blocks):
        sym[i, : x.size] = x
    n_sym = np.array([x.size for x, _ in blocks], np.int32)
    n_in_use = np.array([a - 2 for _, a in blocks], np.int32)
    return sym, n_sym, n_in_use, iters
