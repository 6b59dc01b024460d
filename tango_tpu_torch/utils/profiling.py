"""Timing and tracing, port of tango_tpu/utils/profiling.py (its names,
signatures and return keys).

  * `sync`: wait for the device work that made a result;
  * `device_timer`: median / mean / min wall times of a call, each ended by
    `sync`;
  * `trace`: a `torch.profiler` context over the CPU and, where there is a
    card, CUDA activities, written as a chrome trace (host ops and device
    kernels on one timeline, so a step's host and device time can be split);
  * `realtime_factor`: audio seconds per wall second per card.

JAX's `setup_compilation_cache` has no counterpart: it points XLA at a
persistent compilation cache, and the port compiles nothing at run time but
its CUDA kernels, which `ops/_build.py` builds once into `build/` (keyed by
the sources' hash) and reuses.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch


def _first_tensor(tree):
    """The first tensor leaf of a (nested dict / list / tuple) tree, or None."""
    if isinstance(tree, torch.Tensor):
        return tree
    children = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for child in children:
        t = _first_tensor(child)
        if t is not None:
            return t
    return None


def sync(tree) -> None:
    """Wait for the device work that made `tree`: `torch.cuda.synchronize`
    on the card of its first tensor leaf. A CPU tensor (eager: done when
    its op returns) or a tree without tensors needs no wait."""
    x = _first_tensor(tree)
    if x is not None and x.is_cuda:
        torch.cuda.synchronize(x.device)


def device_timer(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> dict:
    """Median/percentile wall times of fn(*args), each call ended by `sync`
    of its result."""
    for _ in range(warmup):
        sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {
        "p50_s": float(np.median(times)),
        "mean_s": float(times.mean()),
        "min_s": float(times.min()),
        "iters": iters,
    }


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """A torch.profiler trace of the block (CPU activities, and CUDA ones
    where a card is present), written on exit as a chrome trace
    `trace_<pid>_<ns>.json` in `logdir` (default: `tango_tpu_torch_trace`
    under the temporary directory); yields `logdir`. Device work still
    queued at the block's end is waited for first, so its kernels are in
    the trace."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "tango_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield logdir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def realtime_factor(audio_seconds: float, wall_seconds: float, chips: int = 1) -> float:
    return audio_seconds / wall_seconds / chips
