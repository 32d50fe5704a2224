"""The decode's inverse RLE1 and block CRCs (ops/rle1_dec.py) on the CPU,
where the op takes its plain torch version: each family of rows in
tests/rle1_dec_cases.py against the C core (native.inverse_rle1), the
NumPy oracle (oracle.decoder.inverse_rle1) and a literal copy of the C
core's loop, bytes and CRC-32/BZIP2; the rows a decode of stdlib streams
at levels 1 and 9 hands the op; the output bound; the wrappers' argument
checks, and no launch counted on the CPU. Every comparison is exact. The
kernel (D7) runs in tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

from bz2tpu_torch import native
from bz2tpu_torch.format.crc32 import crc32
from bz2tpu_torch.oracle import decoder as od
from bz2tpu_torch.ops import crc_cuda, rle1_dec, rle1_dec_cuda

from rle1_dec_cases import FAMILIES, as_batch, decode_rows, serial, stdlib_stream

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (see test_torch_cli)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(rows: torch.Tensor, n: torch.Tensor) -> list[bytes]:
    """The op on a batch against the C core, the serial loop and the
    oracle, row by row; the rows' outputs."""
    flat, ends, crcs = rle1_dec.inverse_rle1_crc(rows, n)
    got = flat.numpy().tobytes()
    assert len(got) == ends[-1] and ends[0] == 0
    outs = []
    for r in range(rows.shape[0]):
        row = rows[r, : int(n[r])].numpy().tobytes()
        out = got[ends[r] : ends[r + 1]]
        want, want_crc = native.inverse_rle1(row)
        assert out == (want or b"")
        assert int(crcs[r]) == want_crc == crc32(out)
        literal, state = serial(row)
        assert out == literal
        if state == 4:
            # Four equal data bytes and no count: the C core (and bzip2)
            # write the four, the oracle refuses the row.
            with pytest.raises(od.Bz2FormatError, match="missing count byte"):
                od.inverse_rle1(np.frombuffer(row, np.uint8))
        else:
            assert od.inverse_rle1(np.frombuffer(row, np.uint8)).tobytes() == out
        outs.append(out)
    return outs


@pytest.mark.parametrize("family", list(FAMILIES))
def test_inverse_rle1_rows_match_the_c_core_and_the_oracle(family):
    rows = FAMILIES[family]()
    _check(*as_batch(rows, CPU))  # the family as one batch
    if family != "unequal_rows":
        for row in rows:  # each row alone
            _check(*as_batch([row], CPU))


@pytest.mark.parametrize("level", [1, 9])
def test_inverse_rle1_of_the_rows_a_stdlib_decode_hands_it(level):
    stream = stdlib_stream(level)
    seen = decode_rows(stream, CPU)
    assert sum(rows.shape[0] for rows, _ in seen) == len(native.scan_blocks(stream)[0]) == (3 if level == 1 else 1)
    for rows, n in seen:
        _check(rows, n)


def test_a_row_past_its_length_and_n_outside_the_width():
    rows, n = as_batch([b"aaaa\x03" * 10, b"bbbb\x05" * 10, b"cc"], CPU, width=50)
    rows[2, 2:] = ord("c")  # bytes past n are not read
    n = torch.tensor([50, 200, -3], dtype=torch.int32)  # n is clamped into [0, W]
    flat, ends, _ = rle1_dec.inverse_rle1_crc(rows, n)
    assert flat.numpy().tobytes() == b"a" * 70 + b"b" * 90 and ends == [0, 70, 160, 160]


def test_the_output_bound_is_reached():
    rows, n = as_batch(FAMILIES["at_the_bound"](), CPU)
    flat, ends, _ = rle1_dec.inverse_rle1_crc(rows, n)
    assert ends[-1] == rle1_dec.out_bound(1, int(n[0])) == 259 * 20_000
    # A level-9 batch of 8 blocks of 900,000 bytes: under 400 MB.
    assert rle1_dec.out_bound(8, 900_000) == 372_960_000


def test_cpu_crc_lanes_are_a_power_of_two_in_range():
    for total in (0, 1, 255, 4_096, 200_001, 7_200_000, 10**9):
        lanes = rle1_dec._cpu_lanes(total)
        assert lanes & (lanes - 1) == 0 and 256 <= lanes <= 1 << 16


def test_wrappers_check_their_arguments_and_count_no_launch_on_the_cpu():
    before = (dict(rle1_dec_cuda.LAUNCHES), dict(crc_cuda.LAUNCHES))
    rows, n = as_batch([b"abcc", b"dddd\x01"], CPU)
    plan, offsets = rle1_dec.parse(rows, n)
    rle1_dec.expand(rows, n, plan, offsets, int(offsets[-1]))
    rle1_dec.inverse_rle1_crc(rows, n)
    assert (dict(rle1_dec_cuda.LAUNCHES), dict(crc_cuda.LAUNCHES)) == before
    bad = [
        (rows.to(torch.int32), n),  # not uint8
        (rows[0], n),  # not (B, W)
        (rows[:, ::2], n),  # rows not contiguous
        (rows[:0], n[:0]),  # no rows
        (rows, n.to(torch.int64)),  # n not int32
        (rows, n[:1]),  # n not (B,)
        (rows, torch.stack([n, n], 1)[:, 0]),  # n not contiguous
        (rows.to("meta"), n.to("meta")),  # no such device
    ]
    for r, k in bad:
        with pytest.raises(ValueError):
            rle1_dec.parse(r, k)
        with pytest.raises(ValueError):
            rle1_dec.expand(r, k, plan, offsets, 8)
    # The kernel's wrappers take only a card's tensors: no fallback.
    with pytest.raises(ValueError, match="CUDA card"):
        rle1_dec_cuda.parse(rows, n)
    with pytest.raises(ValueError, match="CUDA card"):
        rle1_dec_cuda.expand(rows, n, plan, offsets, torch.empty(16, dtype=torch.uint8))
