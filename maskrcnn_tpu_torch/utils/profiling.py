"""Tracing and profiling, port of `maskrcnn_tpu/utils/profiling.py`:

  * `stage(name, **args)`: a named span of the program on the profiler's
    timeline. Spans are gated on the profiler: with none recording,
    `stage` returns a shared no-op context and costs one attribute read;
    under `torch.profiler.profile` it opens a RecordFunction range, which
    the profiler keeps in memory with its other events until the capture
    ends. There is no flag: the profiler being on is the switch;
  * `StageTimer`: a host wall-clock phase timer with a report, used by the
    evaluate CLI for its per-phase breakdown; each phase is also a
    `stage`, so the phases land on the same timeline.

A span is a RecordFunction of function scope, as an aten op is: the
profiler files it with the host's operations and does not mirror it onto
the device timeline, where a user annotation (`torch.profiler.
record_function`) would show as a device event stretching from the first
to the last kernel launched inside it, idle gaps included. `args` (ints or
strings) are recorded beside the span when the profiler records shapes.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_OFF = contextlib.nullcontext()


def stage(name: str, **args):
    """Named range for a pipeline stage (shows up in profiler traces)."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name, (), args)


class StageTimer:
    """Accumulating wall-clock timer: `with timer.phase("nms"): ...`."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with stage(name):
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
