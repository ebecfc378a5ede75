#!/usr/bin/env python3
"""Readings that set a cell's comparison limits (run on the card).

    python3 benchmark/control.py --workload r101.batch8 \
        --program-seeds 11 12 13 ... --control-seeds 21 22 23 \
        --seconds 3 --out limits_r101.batch8.json

For each program seed: the cell's own set-up, a short window of its own
traffic, and the reference's numbers for the sampled outputs, as
`run.py` judges them (the lower readings). For each control seed: the
reference itself in the program's place, computed one precision below the
configuration's bfloat16 (float8 e4m3 operands, one scale per tensor,
float32 sums), on as many of the cell's inputs as a run judges, batched
as the cell batches them, judged the same way (the upper readings). For
each fault (`faults.py`) and fault seed: a program reading with the fault
planted (the upper readings of the numbers that follow the program's
discrete choices). One process for every seed: the kernels build once.
Prints one JSON object.

    python3 benchmark/control.py --workload r101.batch8 \
        --faults no_suppression second_class --fault-seeds 31 32 33
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import faults, harness  # noqa: E402
from benchmark.reference import check  # noqa: E402
from benchmark.reference import model as R  # noqa: E402


def _explained(worst: list) -> dict:
    gaps = [w for w in worst if "gap" in w]
    return {"worst_proposal": max(gaps, key=lambda w: w["gap"])
            if gaps else None,
            "counts": [w["counts"] for w in worst if "counts" in w],
            "eligible": [w["eligible"] for w in worst if "eligible" in w],
            "uncovered": [w["uncovered"] for w in worst if "uncovered" in w],
            "far": [w["far"] for w in worst if "far" in w]}


def program_reading(cell, seed, seconds, device="cuda", cfg=None,
                    fault=None) -> dict:
    ctx = harness.make_context(cell, seed, device, cfg)
    with (faults.planted(fault, ctx.cfg) if fault
          else contextlib.nullcontext()):
        traffic = harness.make_traffic(ctx)
        traffic.warm()
        window = traffic.window(seconds)
        images, got = traffic.judged()
    traffic.release()
    worst: list = []
    numbers = check.judge(ctx.params, ctx.cfg, images, got,
                          cell.check["limits"]["class_gap"], explain=worst)
    return {"seed": seed, "fault": fault,
            "images_judged": int(images.shape[0]),
            "window_images": window["images"], **numbers,
            **_explained(worst)}


def control_outputs(ctx, images, batch: int, paste_size=None) -> dict:
    """The reference in float8 where the program would run, `batch` images
    a call."""
    nx = R.Numerics("fp8")
    parts = []
    with check.no_tf32(), torch.no_grad():
        for s in range(0, images.shape[0], batch):
            parts.append(R.detect(ctx.params, images[s:s + batch], ctx.cfg,
                                  nx, paste_size=paste_size))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def control_reading(cell, seed, device="cuda", cfg=None) -> dict:
    ctx = harness.make_context(cell, seed, device, cfg)
    traffic = harness.make_traffic(ctx)
    images = torch.as_tensor(traffic.pool[:ctx.sample_images]).to(device)
    traffic.release()
    mix = cell.mix
    got = control_outputs(ctx, images, int(mix.get("batch",
                                                   mix.get("micro_batch", 1))),
                          mix.get("paste_size"))
    worst: list = []
    numbers = check.judge(ctx.params, ctx.cfg, images, got,
                          cell.check["limits"]["class_gap"], explain=worst)
    return {"seed": seed, "images_judged": int(images.shape[0]), **numbers,
            **_explained(worst)}


def summarize(program: list, control: list, broken: list) -> dict:
    """Per number: the program's largest, the control's smallest, and each
    fault's smallest."""
    keys = [k for k in program[0] if k in check.NUMBERS
            or k.endswith("_far")] if program else []
    out = {}
    for k in keys:
        lower = max(r[k] for r in program)
        upper = min(r[k] for r in control) if control else None
        out[k] = {"lower": lower, "upper": upper,
                  "ratio": (upper / lower if upper is not None and lower
                            else None)}
        for kind in sorted({r["fault"] for r in broken}):
            out[k][kind] = min(r[k] for r in broken if r["fault"] == kind)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=faults.KINDS)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    program, control, broken = [], [], []
    for seed in args.program_seeds:
        program.append(program_reading(cell, seed, args.seconds))
        print(json.dumps({"program": program[-1]}), file=sys.stderr,
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for kind in args.faults:
        for seed in args.fault_seeds:
            broken.append(program_reading(cell, seed, args.seconds,
                                          fault=kind))
            print(json.dumps({"fault": broken[-1]}), file=sys.stderr,
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    for seed in args.control_seeds:
        control.append(control_reading(cell, seed))
        print(json.dumps({"control": control[-1]}), file=sys.stderr,
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    report = {"workload": args.workload,
              "device": torch.cuda.get_device_name(0),
              "program": program, "control": control, "faults": broken,
              "readings": summarize(program, control, broken)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report["readings"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
