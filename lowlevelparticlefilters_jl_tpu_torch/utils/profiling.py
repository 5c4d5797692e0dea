"""Tracing and profiling helpers (counterpart of ``utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler.profile`` (CPU
  and, where there is a card, CUDA activities) that writes a
  Chrome/Perfetto trace into ``logdir``;
- :func:`annotate`: a named region, a ``torch.profiler.record_function``
  and, on the card, an NVTX range as well;
- :func:`step_timer`: the median wall time of a call, the device of its
  outputs synchronized before the clock is read.

The per-step callbacks of ``forward_trajectory`` (trajectory.py) remain
the in-loop observability hooks.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable

import torch

from .struct import tree_leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; its trace is written to
    ``logdir/trace_<pid>_<n>.json`` (Chrome trace format, readable by
    Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, acc_events=True) as prof:
        yield prof
    n = sum(1 for f in os.listdir(logdir) if f.startswith("trace_"))
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{n}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region that appears in profiler traces (and, on the card,
    in NVTX-aware tools)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _sync(out) -> None:
    """Wait for every card that holds a tensor of ``out``."""
    for d in {t.device for t in tree_leaves(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(d)


def step_timer(fn: Callable, *args, repeats: int = 3, warmup: bool = True):
    """Median wall-clock seconds of one synchronized call of ``fn``."""
    if warmup:
        _sync(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)
