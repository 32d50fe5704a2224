"""The control and the planted faults that a cell's check must catch.

Each is a context manager that breaks one thing under the timed path for
the calls inside it, and puts it back after:

- ``control``: breaks one guarantee the configuration states, the step a
  later change could be tempted to take. Compress: block CRCs left out (0
  in every block header), so the stream no longer checks. Decompress: the
  host C decoder in the card's place (faster, and off the card).
- ``unchanged_state``: a step returns its input unchanged. Compress: the
  BWT hands back the block as its last column. Decompress: the inverse
  BWT hands back the last column.
- ``half_batch``: half of each batch left out, the larger half (so a
  batch of one block loses it). Compress: only the rest of a batch's
  blocks reaches the encoder. Decompress: only the rest is decoded.
- ``altered_answer``: one byte of an answer altered where it is made, on
  an object's first, third, ... call, so that an object's answers also
  differ from one another.
- ``host_fallback``: the call's answer comes from the host, right, after
  the card was asked. Compress: the standard library's bz2 in the port's
  place. Decompress: the device decode's first batch is decoded and then
  fails validation (``_decode_batch`` returns None after D1 ran), so
  ``decompress_device`` hands the stream to its host decoder.

The one-card cells have no exchange between chips to leave out.
``python -m portbench.control`` runs them on the card; the CPU tests in
``portbench/tests`` run them at a small size.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

FAULTS = ("control", "unchanged_state", "half_batch", "altered_answer", "host_fallback")


@contextmanager
def _patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _flip(out: bytes) -> bytes:
    b = bytearray(out)
    if b:
        b[len(b) // 2] ^= 0x5A
    return bytes(b)


@contextmanager
def planted(fault: str, op: str, port):
    """``fault`` in place for the calls made inside, on ``port`` (a
    portbench.run.Port) and the modules under it."""
    import torch

    from bz2tpu_torch.runtime import compressor, device_decode

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "control" and op == "compress":
        split = compressor.split_blocks

        def no_crc(data, level):
            return [dataclasses.replace(blk, crc=0) for blk in split(data, level)]

        with _patched(compressor, "split_blocks", no_crc):
            yield
    elif fault == "control":
        from bz2tpu_torch.runtime.decompressor import decompress as host_decompress

        with _patched(port, "decompress", lambda stream, timings=None: host_decompress(stream)):
            yield
    elif fault == "unchanged_state" and op == "compress":
        from bz2tpu_torch.ops import pipeline

        def same(blocks, ns):
            return blocks.clone(), torch.zeros(blocks.shape[0], dtype=torch.int32, device=blocks.device)

        with _patched(pipeline, "bwt_stage", same):
            yield
    elif fault == "unchanged_state":
        with _patched(device_decode, "ibwt", lambda last, n, orig_ptr: last):
            yield
    elif fault == "half_batch" and op == "compress":
        tensors = compressor._batch_tensors

        def half(chunk, device, n_rows=None):
            return tensors(chunk[: len(chunk) // 2], device)

        with _patched(compressor, "_batch_tensors", half):
            yield
    elif fault == "half_batch":
        batches = device_decode.batches

        def half(parsed):
            return [(nbc, idxs[: len(idxs) // 2]) for nbc, idxs in batches(parsed)]

        with _patched(device_decode, "batches", half):
            yield
    elif fault == "host_fallback" and op == "compress":
        import bz2

        with _patched(port, "compress", lambda data, timings=None: bz2.compress(data, port.level)):
            yield
    elif fault == "host_fallback":
        decode_batch = device_decode._decode_batch

        def fails(*a, **k):
            decode_batch(*a, **k)
            return None  # the call's first batch, D1 run, fails: the rest goes to the host

        with _patched(device_decode, "_decode_batch", fails):
            yield
    else:
        name = "compress" if op == "compress" else "decompress"
        call = getattr(port, name)
        calls: dict[int, int] = {}

        def altered(data, timings=None):
            calls[id(data)] = calls.get(id(data), 0) + 1
            out = call(data, timings)
            return _flip(out) if calls[id(data)] % 2 else out

        with _patched(port, name, altered):
            yield
