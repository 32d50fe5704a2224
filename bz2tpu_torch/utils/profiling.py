"""Tracing / profiling hooks.

Port of bz2tpu/utils/profiling.py on torch.profiler: a context manager
that records a Chrome trace of the run (host activity, plus the card's
kernels and copies when the run is on CUDA), and the port's own spans and
counters.

``span(name)`` marks a stretch of host code as a profiler range while a
profiler runs (``torch.profiler.profile``, or the CLI's ``--trace DIR``),
so that it lies on the same clock as the card's kernels and copies; with
no profiler running it is a shared ``nullcontext``, well under a
microsecond. The range is a plain function-scope one, not a user
annotation (``torch.profiler.record_function``): a user annotation is
mirrored on the card's timeline over the kernels it encloses, where a
reader that takes every device interval for busy time would count the
idle gaps inside it as busy. Every span name is in ``SPANS``:

  bz2.split     compress: the host RLE1 split and block CRCs of a batch
                (split_blocks); after a call's first batch it runs on the
                split worker, where torch.profiler, whose state is per
                thread, does not record it
  bz2.upload    compress: a batch's padded buffer and its copy to the card
  bz2.encode    compress: every launch of a batch (ops/pipeline.encode_batch)
  bz2.bwt, bz2.mtf, bz2.rle2_out, bz2.huffman, bz2.pack
                inside bz2.encode: the stretches its stage laps close
  bz2.wait      compress: a blocking read of a value from the card
  bz2.fetch     compress: a batch's copy back and byte swap
  bz2.stitch    compress: end marker, stream CRC and the bit stitch
  bz2.parse     decode: the block scan and the header parse
  bz2.members   inside bz2.parse: the member walk (parse_blocks)

``StageClock(timings, device)`` adds each stage's seconds to
``timings[name]`` at each ``lap(clock, name)``, waiting for the device
first; ``lap`` with no clock does nothing.

``count(name)`` adds to ``COUNTERS``, plain ints that run whether or not
a profiler does (unlocked: calls on several threads at once may lose an
increment); ``counters()`` is a snapshot of them with each kernel's
launches. Every counter name is in ``COUNTER_NAMES``:

  batches               compress batches through the card
  split_ahead           compress batches after a call's first whose split on
                        the worker had finished when the calling thread took
                        the batch (compressor._split_ahead)
  split_waits           such batches whose split had not finished: the
                        calling thread waited for it
  bwt_rounds            BWT sort-and-rerank rounds (round 0 and each doubling)
  host_syncs            blocking reads of a value from the card (bz2.wait)
  decode_headers        block headers parsed by the C core for streams the
                        card goes on to decode (parse_blocks)
  decode_members        members of the streams the card goes on to decode
                        (parse_blocks): one a stream of one member
  decode_rle1_device    blocks whose inverse RLE1 and CRC ran on the device
                        (device_decode._decode_batch, ops/rle1_dec.py): equal
                        to decode_headers on a stream the card decodes whole
  decode_fallbacks.*    streams decompress_device handed to the host decoder,
                        by reason: no_native (no native scanner built),
                        header (no BZh magic), scan (the block scan found no
                        block right after the header, or no end marker),
                        members (members that do not chain: an empty member,
                        junk between members, a member-like magic after the
                        last member or off the chain; or a block CRC that does
                        not match in a later member), block (a block header
                        that does not parse, or an empty block), validate (a
                        decoded batch failed its exact checks), stream_crc (a
                        member's stream CRC missing, or not matching)
"""

from __future__ import annotations

import contextlib
import os
import time
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _autograd_profiler

SPANS = (
    "bz2.split", "bz2.upload", "bz2.encode", "bz2.bwt", "bz2.mtf", "bz2.rle2_out", "bz2.huffman",
    "bz2.pack", "bz2.wait", "bz2.fetch", "bz2.stitch", "bz2.parse", "bz2.members",
)
FALLBACK_REASONS = ("no_native", "header", "scan", "members", "block", "validate", "stream_crc")
COUNTER_NAMES = (
    "batches", "split_ahead", "split_waits", "bwt_rounds", "host_syncs", "decode_headers", "decode_members", "decode_rle1_device",
    *(f"decode_fallbacks.{r}" for r in FALLBACK_REASONS),
)
COUNTERS: dict[str, int] = dict.fromkeys(COUNTER_NAMES, 0)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A host-side profiler range ``name`` while a profiler runs, else a
    shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


class StageClock:
    """Adds each stage's seconds to ``timings[name]``. Every lap waits for
    the device, so a clocked run is slightly slower than an unclocked one."""

    def __init__(self, timings: dict, device: torch.device):
        self.timings = timings
        self.device = device
        self.t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        t = self._now()
        self.timings[name] = self.timings.get(name, 0.0) + (t - self.t)
        self.t = t


def lap(clock: StageClock | None, name: str) -> None:
    """``clock.lap(name)``, where there is a clock."""
    if clock is not None:
        clock.lap(name)


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] += n


def wait():
    """The span of a blocking read of a value from the card, counted in
    ``host_syncs``."""
    COUNTERS["host_syncs"] += 1
    return span("bz2.wait")


def counters() -> dict[str, int]:
    """A copy of ``COUNTERS``, with each kernel's launches so far as
    ``launches.<kernel>``."""
    from bz2tpu_torch.ops import (
        bwt_cuda, crc_cuda, dec_cuda, huffman_cuda, mtf_cuda, mtf_dec_cuda, rle1_cuda, rle1_dec_cuda,
    )

    snap = dict(COUNTERS)
    for mod in (bwt_cuda, mtf_cuda, huffman_cuda, dec_cuda, mtf_dec_cuda, crc_cuda, rle1_cuda, rle1_dec_cuda):
        snap.update((f"launches.{k}", v) for k, v in mod.LAUNCHES.items())
    return snap


@contextmanager
def device_trace(trace_dir: str | None):
    """Record a torch.profiler trace into ``trace_dir`` as
    ``trace-<pid>-<ns>.json`` (a no-op when ``trace_dir`` is None): host
    activity with the port's ``bz2.*`` spans, and the card's kernels and
    copies where CUDA is available. The trace opens in chrome://tracing or
    Perfetto.
    """
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
