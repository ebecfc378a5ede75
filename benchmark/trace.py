"""The traced sub-window: torch.profiler over a few steps of the cell's own
traffic, reduced to what the per-layer readers and the result line need.

Only the profiler's event summary is kept in memory; no chrome trace is
written. Kernel families and their CUDA kernel names come from
`kernels.json` (`chip_smoke.py::KERNEL_GROUPS`); a `roi_align_kernel` that
runs as the pool pass of a fused head (the next kernel on the device is
that head's) is counted with the head.
"""

from __future__ import annotations

import heapq
import json
import os
from collections import defaultdict

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW = "benchmark.traced_window"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch")
PROFILER_OWN = "Activity Buffer Request"
FUSED_POOL_OWNERS = ("roi_classifier_head", "roi_mask_head")


def kernel_families() -> dict[str, list[str]]:
    with open(os.path.join(HERE, "kernels.json")) as f:
        return json.load(f)


def _is_device(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


class TraceView:
    """What one traced sub-window shows: its wall time, the device's busy
    time (union of every device operation's interval), host launch calls,
    device seconds by kernel family, the top device operations and the
    idle time by what the host was doing."""

    def __init__(self, prof, images: int):
        events = list(prof.events())
        window = [e for e in events if e.name == WINDOW]
        if not window:
            raise RuntimeError("the traced window's marker is missing")
        t0 = window[0].time_range.start
        t1 = window[0].time_range.end
        self.window_s = (t1 - t0) / 1e6
        self.images = images
        dev = sorted((e for e in events if _is_device(e)
                      and e.name != WINDOW
                      and e.time_range.end > t0 and e.time_range.start < t1),
                     key=lambda e: e.time_range.start)
        cpu = [e for e in events if not _is_device(e)
               and e.name not in (WINDOW, PROFILER_OWN)
               and e.time_range.start >= t0 and e.time_range.end <= t1]
        self.launches = sum(1 for e in cpu if e.name in LAUNCHES)
        self.device_ops = len(dev)
        # busy time: union of intervals, clipped to the window
        spans = []
        for e in dev:
            s, t = max(e.time_range.start, t0), min(e.time_range.end, t1)
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], t)
            else:
                spans.append([s, t])
        busy = sum(t - s for s, t in spans)
        self.busy_s = busy / 1e6
        # device seconds by op name and by kernel family
        by_name: dict[str, float] = defaultdict(float)
        for e in dev:
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        self.top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        fams = kernel_families()
        fam_of = lambda name: next((f for f, ks in fams.items()
                                    if any(k in name for k in ks)), None)
        self.family_s: dict[str, float] = defaultdict(float)
        for i, e in enumerate(dev):
            fam = fam_of(e.name)
            if fam == "roi_align" and i + 1 < len(dev):
                nxt = fam_of(dev[i + 1].name)
                if nxt in FUSED_POOL_OWNERS:
                    fam = nxt
            if fam:
                self.family_s[fam] += (e.time_range.end
                                       - e.time_range.start) / 1e6
        # idle time by the host's innermost operation at each gap's middle
        gaps, prev = [], t0
        for s, t in spans + [[t1, t1]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        idle: dict[str, float] = defaultdict(float)
        cpu.sort(key=lambda e: e.time_range.start)
        active: list = []          # (duration, end, name), shortest first
        j = 0
        for s, t in gaps:
            mid = 0.5 * (s + t)
            while j < len(cpu) and cpu[j].time_range.start <= mid:
                e = cpu[j]
                heapq.heappush(active, (e.time_range.end - e.time_range.start,
                                        e.time_range.end, e.name))
                j += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            name = active[0][2] if active else "host between operations"
            idle[name] += (t - s) / 1e6
        self.idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]

    def breakdown(self) -> dict:
        return {"device_ops": [[n[:160], s] for n, s in self.top_ops],
                "idle_gaps": [[n[:160], s] for n, s in self.idle]}


def capture(step, n: int):
    """Profile `n` calls of `step()` (each returns the images it completed)
    after a synchronize; the calls' work must end on the host."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    images = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                images += step()
            torch.cuda.synchronize()
    return TraceView(prof, images)


def launches_per_image(measured):
    """Launch calls per image of the traced window; None without any."""
    t = measured.trace
    if not t.launches or not t.images:
        return None
    return t.launches / t.images


def idle_percent(measured):
    return 100.0 * (1.0 - measured.trace.busy_s / measured.trace.window_s)
