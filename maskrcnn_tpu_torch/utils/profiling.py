"""Tracing and profiling, port of `maskrcnn_tpu/utils/profiling.py`:

  * `stage(name)`: a `torch.profiler.record_function` range, so a stage
    shows by name in profiler traces;
  * `trace(logdir)`: a `torch.profiler.profile` of the host and the card
    around any region, written to `logdir` as a Chrome trace;
  * `StageTimer`: a host wall-clock phase timer with a report, used by the
    evaluate CLI for its per-phase breakdown.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


def stage(name: str):
    """Named range for a pipeline stage (shows up in profiler traces)."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace (host, and the card where there is
    one) into `logdir/trace.json`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimer:
    """Accumulating wall-clock timer: `with timer.phase("nms"): ...`."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in self.totals:
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(
                f"  {name:<24} {tot*1000:9.1f} ms total"
                f"  ({tot/n*1000:8.2f} ms avg over {n})")
        return "\n".join(lines)
