"""Profiling and timing helpers.

Port of the JAX package's ``utils/profiling.py``:

- ``PhaseTimers``: wall-clock phase timers accumulated by name, reported
  as a dict;
- ``trace(logdir)``: a ``torch.profiler`` trace of the block (host and, on
  the card, device activity), written to ``logdir/trace.json`` for
  ``chrome://tracing`` or Perfetto;
- ``device_time(fn, *args)``: the best of a few CUDA-event timings of a call.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Dict


class PhaseTimers:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in sorted(self.totals)
        }


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block (CPU and, with a card, CUDA
    activity); the profiler is yielded (``key_averages()``) and its trace
    written to ``logdir/trace.json``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_time(fn: Callable, *args, repeats: int = 5) -> float:
    """Best of ``repeats`` CUDA-event timings of ``fn(*args)`` in seconds,
    after one warm-up call. Needs a CUDA card: a time from the host's clock
    would not be the device's."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("device_time times the CUDA card, and there is none")
    fn(*args)
    best = float("inf")
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best
