"""Tracing / profiling hooks.

Port of bz2tpu/utils/profiling.py on torch.profiler: a context manager
that records a Chrome trace of the run (host activity, plus the card's
kernels and copies when the run is on CUDA), and a fence that waits for
the card before a stage's clock is read.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


@contextmanager
def device_trace(trace_dir: str | None):
    """Record a torch.profiler trace into ``trace_dir`` as
    ``trace-<pid>-<ns>.json`` (a no-op when ``trace_dir`` is None): host
    activity, and the card's kernels and copies where CUDA is available.
    The trace opens in chrome://tracing or Perfetto.
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


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fence(tree) -> None:
    """Wait until the work behind every CUDA tensor in the (nested list,
    tuple or dict) ``tree`` has finished (honest timing); CPU tensors are
    ready already."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
