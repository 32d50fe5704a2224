"""bz2tpu_torch emission (header elements, pack + concat) against
bz2tpu.ops.emit, fed the same JAX stage state through interop. Exact.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bz2tpu.ops import emit as jax_emit  # noqa: E402
from bz2tpu.ops import pipeline as jax_pipe  # noqa: E402
from bz2tpu.ops.huffman import huffman_assign as jax_huffman_assign  # noqa: E402
from bz2tpu.ops.mtf import _rle2_out as jax_rle2_out  # noqa: E402
from bz2tpu_torch import interop  # noqa: E402
from bz2tpu_torch.ops import emit, pipeline  # noqa: E402
from bz2tpu_torch.ops.huffman import max_selectors  # noqa: E402

from conftest import make_corpus  # noqa: E402

CAP = 4096


@pytest.fixture(scope="module")
def jax_state():
    """One JAX batch run up to the emission: blocks, plan, the output
    symbols at the batch's max n_sym and their Huffman plan."""
    rng = np.random.default_rng(7)
    kinds = ["text", "random", "runs", "zeros"]
    blocks = np.zeros((len(kinds), CAP), np.uint8)
    ns = np.zeros(len(kinds), np.int32)
    for i, kind in enumerate(kinds):
        d = np.frombuffer(make_corpus(rng, kind, CAP - 300 * i), np.uint8)
        blocks[i, : d.size] = d
        ns[i] = d.size
    crcs = rng.integers(0, 1 << 32, len(kinds), dtype=np.uint64).astype(np.uint32)
    last, orig_ptr = jax_pipe.bwt_stage(jnp.asarray(blocks), jnp.asarray(ns))
    plan = jax_pipe.mtf_plan_stage(last, jnp.asarray(ns))
    width = int(jnp.max(plan["n_sym"]))
    maxsel = max_selectors(width - 2)
    sym = jax.vmap(lambda p: jax_rle2_out(p, width, with_freqs=False)[0])(plan)
    hp = jax.vmap(
        lambda s, p: jax_huffman_assign(s, p["n_sym"], None, p["n_in_use"], maxsel=maxsel)
    )(sym, plan)
    return {
        "plan": jax.device_get(plan), "hp": jax.device_get(hp), "sym": np.asarray(sym),
        "orig_ptr": np.asarray(orig_ptr), "crcs": crcs, "width": width, "maxsel": maxsel,
    }


def _jax_args(s):
    hp, plan = s["hp"], s["plan"]
    return (
        s["sym"], hp["selectors"], hp["lengths"], hp["codes"], s["crcs"], s["orig_ptr"],
        plan["used"], hp["n_groups"], hp["n_selectors"], hp["selector_mtf"],
    )


def _port_args(s):
    return tuple(
        interop.from_jax({"x": a})["x"] for a in _jax_args(s)
    )


def _words_equal(got, want_words, want_total):
    total = int(got[1])
    assert total == int(want_total)
    nw = (total + 31) // 32
    np.testing.assert_array_equal(got[0][:nw].numpy().astype(np.uint32), np.asarray(want_words)[:nw])
    assert not got[0][nw:].any()


def test_header_parts_match_jax(jax_state):
    s = jax_state
    args = _port_args(s)
    got = emit.block_header_parts(args[4], args[5], args[6], args[7], args[8], args[9], args[2], maxsel=s["maxsel"])
    want = jax.vmap(
        lambda *a: jax_emit.block_header_parts(*a, maxsel=s["maxsel"])
    )(*(jnp.asarray(_jax_args(s)[i]) for i in (4, 5, 6, 7, 8, 9, 2)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_pack_blocks_concat_matches_jax(jax_state):
    s = jax_state
    got = emit.pack_blocks_concat(*_port_args(s), maxsel=s["maxsel"])
    live = jnp.ones(s["sym"].shape[0], bool)
    want = jax_emit.pack_blocks_concat(
        *(jnp.asarray(a) for a in _jax_args(s)), live, maxsel=s["maxsel"]
    )
    _words_equal(got, want[0], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_emit_stage_matches_jax(jax_state):
    # The port's RLE2 emission + Huffman + pack on the JAX plan.
    s = jax_state
    plan = interop.from_jax(s["plan"])
    got = pipeline.emit_huff_pack_concat_stage(
        plan, torch.from_numpy(s["orig_ptr"].copy()), torch.from_numpy(s["crcs"].astype(np.int64)),
        width=s["width"],
    )
    want = jax_pipe.emit_huff_pack_concat_stage(
        s["plan"], jnp.asarray(s["orig_ptr"]), jnp.asarray(s["crcs"]),
        jnp.ones(s["sym"].shape[0], bool), width=s["width"],
    )
    _words_equal(got, want[0], want[1])


def test_emit_at_max_nsym_equals_full_width(jax_state):
    s = jax_state
    plan = interop.from_jax(s["plan"])
    args = (torch.from_numpy(s["orig_ptr"].copy()), torch.from_numpy(s["crcs"].astype(np.int64)))
    tight = pipeline.emit_huff_pack_concat_stage(plan, *args, width=int(plan["n_sym"].max()))
    full = pipeline.emit_huff_pack_concat_stage(plan, *args, width=CAP + 2)
    assert int(tight[1]) == int(full[1])
    nw = (int(full[1]) + 31) // 32
    torch.testing.assert_close(tight[0][:nw], full[0][:nw], rtol=0, atol=0)
    torch.testing.assert_close(tight[2], full[2], rtol=0, atol=0)
