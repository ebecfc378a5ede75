#!/usr/bin/env python3
"""The program's spans (`maskrcnn_tpu_torch/utils/profiling.stage`) in a
traced window, put beside the device's work: each span's host time and
self time, the device time launched inside it and the idle time that falls
inside it.

    python3 benchmark/spans.py --workload r101.batch8 --seed 7

runs the cell's set-up, warm-up and `--seconds` of its traffic as
`run.py` does, then `--trace-seconds` more of the cell's own traffic
(`Traffic.window`: its batch size, its calls) under torch.profiler, and
prints one JSON line: the `TraceView` readings of that window, the span
readings, and what one `stage` costs on the host with the profiler off
and on. A first stretch of traffic runs under the profiler before the
window opens, so that what the profiler's start costs (module loading on
the first launches) falls outside it. Over a program without spans the
span readings are empty.

`main()` is a stand-in until `trace.capture` keeps the profiler's events
and `SpanView` is read there (`ROADMAP.md`, Queue B item 4): the
benchmark's own `--trace 1` window is `trace_steps` calls of
`Traffic.trace_step`, not this one.

A span is a RecordFunction of function scope: a host event, told from the
aten ops by its name (`SPANS`). A device operation goes to the spans open
on the host when it was launched: its `id` is the CUDA correlation id of
the runtime call that launched it (`cudaLaunchKernel`, `cudaMemcpyAsync`,
...), a host event with the same id (the profiler's events carry no
`linked_correlation_id` in torch 2.11). An idle gap of the device goes to
the spans open at its midpoint, the rule `TraceView.idle` names gaps by.
Device user annotations (the profiler's mirror of a `record_function`,
such as the window's marker) are not device work.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.trace import WINDOW, TraceView, _is_device  # noqa: E402

FORWARD_STAGES = ("preprocess", "backbone_fpn", "rpn", "proposals",
                  "roi_align_classifier", "classifier_head", "detection",
                  "roi_align_mask", "mask_head", "roi_align_mask_fused",
                  "paste")
SPANS = ("detector.run_batch", "mesh.copy_in", "forward") \
    + FORWARD_STAGES + ("stream.quantize", "stream.dispatch", "stream.sync")
NO_SPAN = ""


def _merge(intervals) -> list[list]:
    """(start, end) intervals merged where they touch or overlap, in
    order."""
    out: list[list] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _union_s(intervals) -> float:
    """Seconds covered by (start, end) intervals in microseconds."""
    return sum(t - s for s, t in _merge(intervals)) / 1e6


def _open_at(spans, times) -> list[tuple]:
    """For each time (ascending), the spans open then, outermost first."""
    out, active, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j].time_range.start <= t:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s.time_range.end >= t]
        out.append(tuple(active))
    return out


class SpanView:
    """What the program's spans show in one traced window: per span name
    `count`, `host_s` (union of its intervals), `self_s` (its intervals
    less its child spans'), `device_s` (union of the device operations
    whose innermost launching span it is; `NO_SPAN` for those launched
    outside every span), `device_under_s` (launched inside it at any
    depth), `idle_s` and `idle_under_s` (idle gaps by the same rules);
    `unlinked_s`, device time whose launch was not found; and each
    `stream.dispatch`'s time to the end of the first `stream.sync` after
    it (`dispatch_to_sync_s`)."""

    def __init__(self, events, images: int):
        events = list(events)
        window = [e for e in events if e.name == WINDOW
                  and not _is_device(e)]
        if not window:
            raise RuntimeError("the traced window's marker is missing")
        t0 = window[0].time_range.start
        t1 = window[0].time_range.end
        self.window_s = (t1 - t0) / 1e6
        self.images = images
        host = [e for e in events if not _is_device(e)
                and e.time_range.start >= t0 and e.time_range.end <= t1]
        spans = sorted((e for e in host if e.name in SPANS),
                       key=lambda e: (e.time_range.start, -e.time_range.end))
        self.count: dict[str, int] = defaultdict(int)
        own: dict[str, list] = defaultdict(list)
        children: dict[int, list] = defaultdict(list)
        stack: list = []
        for s in spans:
            while stack and stack[-1].time_range.end <= s.time_range.start:
                stack.pop()
            if stack and s.time_range.end <= stack[-1].time_range.end:
                children[id(stack[-1])].append(
                    (s.time_range.start, s.time_range.end))
            stack.append(s)
            self.count[s.name] += 1
            own[s.name].append((s.time_range.start, s.time_range.end))
        self.host_s = {n: _union_s(iv) for n, iv in own.items()}
        self.self_s: dict[str, float] = defaultdict(float)
        for s in spans:
            self.self_s[s.name] += (
                (s.time_range.end - s.time_range.start) / 1e6
                - _union_s(children[id(s)]))

        launch = {e.id: e.time_range.start for e in host
                  if e.name.startswith("cu")}
        dev = sorted((e for e in events if _is_device(e)
                      and e.name != WINDOW
                      and not getattr(e, "is_user_annotation", False)
                      and e.time_range.end > t0 and e.time_range.start < t1),
                     key=lambda e: e.time_range.start)
        clip = [(max(e.time_range.start, t0), min(e.time_range.end, t1))
                for e in dev]
        linked = sorted((launch[e.id], iv) for e, iv in zip(dev, clip)
                        if e.id in launch)
        self.unlinked_s = _union_s(iv for e, iv in zip(dev, clip)
                                   if e.id not in launch)
        inner: dict[str, list] = defaultdict(list)
        under: dict[str, list] = defaultdict(list)
        for (_, iv), opened in zip(linked,
                                   _open_at(spans, [t for t, _ in linked])):
            inner[opened[-1].name if opened else NO_SPAN].append(iv)
            for name in {s.name for s in opened}:
                under[name].append(iv)
        self.device_s = {n: _union_s(iv) for n, iv in inner.items()}
        self.device_under_s = {n: _union_s(iv) for n, iv in under.items()}

        gaps, prev = [], t0
        for s, t in _merge(clip) + [[t1, t1]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        self.idle_s: dict[str, float] = defaultdict(float)
        self.idle_under_s: dict[str, float] = defaultdict(float)
        for (s, t), opened in zip(gaps, _open_at(
                spans, [0.5 * (s + t) for s, t in gaps])):
            self.idle_s[opened[-1].name if opened else NO_SPAN] += \
                (t - s) / 1e6
            for name in {o.name for o in opened}:
                self.idle_under_s[name] += (t - s) / 1e6

        syncs = [s for s in spans if s.name == "stream.sync"]
        dispatches = [s for s in spans if s.name == "stream.dispatch"]
        self.dispatch_s = [(d.time_range.end - d.time_range.start) / 1e6
                           for d in dispatches]
        self.dispatch_to_sync_s = []
        for d in dispatches:
            end = next((s.time_range.end for s in syncs
                        if s.time_range.start >= d.time_range.end), None)
            if end is not None:
                self.dispatch_to_sync_s.append(
                    (end - d.time_range.start) / 1e6)

    def readings(self) -> dict:
        """The six per-layer quantities the spans give, each where its
        span ran in the window, and the cover of the spans (host shares
        of a span's time its child spans take; the share of the device
        time launched inside `detector.run_batch` that no stage
        encloses)."""
        h, per_image = self.host_s, 1e3 / max(self.images, 1)
        out = {}
        if "forward" in h:
            out["forward.host_ms_per_image"] = h["forward"] * per_image
            out["forward.dispatch_idle"] = 100.0 * self.idle_under_s.get(
                "forward", 0.0) / self.window_s
            out["cover.forward_host"] = 1.0 - self.self_s["forward"] \
                / h["forward"]
        if "mesh.copy_in" in h:
            out["detector.copy_in_ms_per_image"] = \
                h["mesh.copy_in"] * per_image
        if "backbone_fpn" in h:
            out["backbone_fpn.device_ms_per_image"] = self.device_s.get(
                "backbone_fpn", 0.0) * per_image
        if "detector.run_batch" in h:
            out["cover.run_batch_host"] = 1.0 - \
                self.self_s["detector.run_batch"] / h["detector.run_batch"]
            inside = self.device_under_s.get("detector.run_batch", 0.0)
            if inside:
                out["unstaged.run_batch_device"] = sum(
                    self.device_s.get(n, 0.0)
                    for n in ("detector.run_batch", "forward")) / inside
        if "stream.dispatch" in h:
            out["stream.dispatch_ms_per_frame"] = \
                h["stream.dispatch"] * per_image
        if "stream.sync" in h:
            out["stream.sync_wait"] = 100.0 * h["stream.sync"] \
                / self.window_s
        if self.dispatch_to_sync_s:
            ms = [1e3 * s for s in self.dispatch_to_sync_s]
            out["stream.dispatch_to_sync_ms_median"] = statistics.median(ms)
            out["stream.dispatch_to_sync_ms_max"] = max(ms)
        return out

    def report(self) -> dict:
        by_name = ("count", "host_s", "self_s", "device_s", "device_under_s",
                   "idle_s", "idle_under_s")
        out = {"readings": self.readings(), "unlinked_s": self.unlinked_s,
               **{k: dict(getattr(self, k)) for k in by_name}}
        if self.dispatch_s:
            ms = [1e3 * s for s in self.dispatch_s]
            out["stream.dispatch_ms"] = {"first": ms[0],
                                         "median": statistics.median(ms),
                                         "max": max(ms)}
        return out


def span_cost_us(n: int = 5000) -> dict:
    """Host microseconds per `with stage(...)`, profiler off and on."""
    from maskrcnn_tpu_torch.utils.profiling import stage

    def per_span() -> float:
        t = time.perf_counter()
        for _ in range(n):
            with stage("span_cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    off = per_span()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        on = per_span()
    return {"off": off, "on": on}


def main(argv=None) -> int:
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace-seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    ctx = harness.make_context(cell, args.seed, "cuda")
    traffic = harness.make_traffic(ctx)
    traffic.warm()
    traffic.window(args.seconds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traffic.window(0.5)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            images = traffic.window(args.trace_seconds)["images"]
            torch.cuda.synchronize()
    view = TraceView(prof, images)
    spans = SpanView(prof.events(), images)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0), "images": images,
        "window_s": view.window_s, "busy_s": view.busy_s,
        "launches": view.launches, "family_s": dict(view.family_s),
        **view.breakdown(), "spans": spans.report(),
        "span_cost_us": span_cost_us()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
