"""Tracing / profiling utilities (port of
``fashionvisualexpl_tpu/utils/profiling.py``).

The reference's only observability is printed wall-clock deltas
(src/recommender/Evaluator.py:171,195-200).  Here:

- ``trace(logdir)``: a ``torch.profiler`` capture of the enclosed block
  (host, and the card's kernels when it is there), written into ``logdir``
  as a Chrome / Perfetto trace file;
- ``annotate(name)``: a ``torch.profiler.record_function`` range, so
  framework phases (sample / lookup / score / update / eval) are labelled
  in traces;
- ``StepTimer``: rolling wall-clock stats for step / epoch loops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed block into
    ``logdir/trace-<pid>-<ns>.json``; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Label the enclosed work in profiler traces."""
    from torch.profiler import record_function

    with record_function(name):
        yield


class StepTimer:
    """Rolling wall-clock stats; ``lap(name)`` accumulates named phases."""

    def __init__(self):
        self._t0 = time.time()
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def lap(self, name: str) -> float:
        now = time.time()
        dt = now - self._t0
        self._t0 = now
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return dt

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_s": self.totals[k] / self.counts[k],
            }
            for k in self.totals
        }
