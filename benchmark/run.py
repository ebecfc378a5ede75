#!/usr/bin/env python3
"""Run one cell of the benchmark of `maskrcnn_tpu_torch` once.

    python3 benchmark/run.py --workload r101.batch8 --seed 7 --seconds 10 \
        --trace 0

Set-up (weights and inputs from the seed, the program built and warmed on
the cell's shapes) counts as `setup_s`; then the cell's traffic runs for
`--seconds`. With `--trace 1` a short traced window of the same traffic
follows and the per-layer metrics are reported instead of the end-to-end
ones. Last, the plain reference judges a sample of the window's outputs,
drawn from the seed. The last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with a trace
`breakdown`, and `checks` last: each number compared, beside its limit);
the checks are also the last lines of standard error. Exits 2 without a
result where the card (or as many cards as the cell asks for) is missing,
and 4 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness, roofline  # noqa: E402

T_IMPORTED = time.perf_counter()


@contextlib.contextmanager
def record_nms(calls: list):
    """Keep each K1 call's inputs and keep flags (the name
    `ops/nms.py` calls) while the traced window runs."""
    from maskrcnn_tpu_torch.ops import nms as nms_mod
    original = nms_mod.nms_keep

    def recorded(boxes, cand, threshold, max_out):
        keep = original(boxes, cand, threshold, max_out)
        calls.append((boxes, cand, keep, threshold, max_out))
        return keep

    nms_mod.nms_keep = recorded
    try:
        yield
    finally:
        nms_mod.nms_keep = original


class Measured:
    """What a per-layer reader gets."""

    def __init__(self, cfg, window: dict, trace, work: dict):
        self.cfg, self.window, self.trace, self.work = cfg, window, trace, \
            work


def per_layer(cell, traffic, ctx, window) -> tuple[dict, object]:
    from benchmark import trace as tr
    calls: list = []
    with record_nms(calls):
        view = tr.capture(traffic.trace_step, traffic.trace_steps)
    work = traffic.work()
    work["nms"] = [roofline.nms_call(*c) for c in calls]
    measured = Measured(ctx.cfg, window, view, work)
    metrics = {}
    for m in cell.per_layer():
        value = harness.load_module("metrics", m["name"]).read(measured)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics, view


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             cfg=None, t_start: float = T_START) -> dict:
    """One run; the result object (without printing it)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = {"imports": T_IMPORTED - t_start}
    t = time.perf_counter()
    ctx = harness.make_context(cell, seed, device, cfg)
    sync()
    phases["weights"], t = time.perf_counter() - t, time.perf_counter()
    traffic = harness.make_traffic(ctx)
    phases["inputs_and_program"], t = time.perf_counter() - t, \
        time.perf_counter()
    traffic.warm()
    sync()
    phases["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    print("setup phases (s): " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in phases.items()),
          file=sys.stderr)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window = traffic.window(seconds)
    sync()
    dev_info = (harness.device_info(cell.chips) if cuda else
                {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0})
    result = {"correct": False, "attempted": window["attempted"],
              "failed": window["failed"]}
    if trace:
        metrics, view = per_layer(cell, traffic, ctx, window)
        dev_info.update(busy_s=view.busy_s, window_s=view.window_s)
        result.update(metrics=metrics, device=dev_info,
                      breakdown=view.breakdown())
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        result.update(metrics={m["name"]: {"value": values[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end()},
                      device=dev_info)
    images, got = traffic.judged()
    traffic.release()
    del traffic
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, ok = harness.judge(ctx, cell, images, got)
    result["correct"] = bool(ok and window["failed"] == 0)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
