"""Fold per-seed flagship proofs into a seed band: the port's copy of
`tools/flagship_seed_band.py`, plus a band over `proof_numerics` reports.

Each seed redraws both the synthetic train set and the disjoint val set
(the seed feeds `flagship_proof.make_dataset` and the train loader), so
a band is the seed and val-resample spread together.

    python3 -m maskrcnn_tpu_torch.tools.flagship_seed_band \\
        --inputs proof_seed0.json proof_seed1.json \\
        [--numerics numerics_seed0.json numerics_seed1.json ...] \\
        --out band.json

`--inputs` are `flagship_proof.py` reports (in seed order); the output's
`ap`, `deltas` and `cross_mode` sections are the JAX tool's, key for key.
A mode missing from any report (`tf_oracle` where TensorFlow is absent)
is skipped. `--numerics` are `proof_numerics.py` reports; they add a
`numerics` section: for each variant present in every report, its AP,
AP50 and AP75 over the proof's first 64 val images and over every val
image (`first_64`, `all_<n>`), its AP minus `exact_fp32`'s over the same
images, and its per-detection `n_matched` and `pairwise_mask_iou_mean`
against `exact_fp32`. A numerics report's seed is its `seed` key or, for
a report without one, the `_seed<N>` in its file name.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

MODES = ("production", "exact_fp32", "tf_oracle")
METRICS = ("AP", "AP50", "AP75")


def band(vals):
    a = np.asarray(vals, np.float64)
    return {"values": [round(float(v), 4) for v in a],
            "mean": round(float(a.mean()), 4),
            "min": round(float(a.min()), 4),
            "max": round(float(a.max()), 4),
            "spread": round(float(a.max() - a.min()), 4)}


def _seed(report, path):
    if report.get("seed") is not None:
        return report["seed"]
    m = re.search(r"_seed(\d+)", os.path.basename(path))
    if m is None:
        raise ValueError(f"{path}: no `seed` key and no _seed<N> in its name")
    return int(m.group(1))


def numerics_band(reports, paths):
    """The `numerics` section over `proof_numerics` reports."""
    from maskrcnn_tpu_torch.tools.proof_numerics import VARIANTS

    variants = [v for v in VARIANTS if all(v in r for r in reports)]
    subsets = [s for s in reports[0]["exact_fp32"]
               if s.startswith(("first_", "all_"))
               and all(s in r["exact_fp32"] for r in reports)]
    out = {"seeds": [_seed(r, p) for r, p in zip(reports, paths)],
           "sources": list(paths), "variants": variants,
           "ap": {}, "deltas_vs_exact_fp32": {}, "cross_mode": {}}
    for v in variants:
        for s in subsets:
            for iou_type in ("bbox", "segm"):
                for met in METRICS:
                    out["ap"][f"{v}.{s}.{iou_type}.{met}"] = band(
                        [r[v][s][iou_type][met] for r in reports])
                if v != "exact_fp32":
                    out["deltas_vs_exact_fp32"][f"{v}.{s}.{iou_type}.AP"] = \
                        band([r[v][s][iou_type]["AP"]
                              - r["exact_fp32"][s][iou_type]["AP"]
                              for r in reports])
        if v != "exact_fp32":
            rows = [r["deltas_vs_exact_fp32"][v][f"{v}_vs_exact_fp32"]
                    for r in reports]
            out["cross_mode"][v] = {
                "n_matched": [r["n_matched"] for r in rows],
                "pairwise_mask_iou_mean": band(
                    [r["pairwise_mask_iou_mean"] for r in rows])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", nargs="+", required=True,
                    help="per-seed flagship_proof JSONs (seed order)")
    ap.add_argument("--numerics", nargs="+", default=[],
                    help="per-seed proof_numerics JSONs (seed order)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    reports = []
    for p in args.inputs:
        with open(p) as f:
            reports.append(json.load(f))
    seeds = [r["seed"] for r in reports]

    out = {
        "comment": (
            "Flagship proof (train->calibrate->evaluate, resnet101 @ 1024^2, "
            "64 disjoint val images) repeated across seeds; each seed "
            "re-draws train AND val data, so spreads are seed + "
            "val-resample variability combined."),
        "seeds": seeds,
        "per_seed_sources": args.inputs,
        "ap": {}, "deltas": {}, "cross_mode": {},
    }

    for mode in MODES:
        if not all(mode in r for r in reports):
            continue
        for iou_type in ("bbox", "segm"):
            for met in METRICS:
                key = f"{mode}.{iou_type}.{met}"
                out["ap"][key] = band(
                    [r[mode][iou_type][met] for r in reports])

    # the headline deltas, per seed and banded
    for iou_type in ("bbox", "segm"):
        out["deltas"][f"production_vs_exact.{iou_type}.AP"] = band(
            [r["production"][iou_type]["AP"] - r["exact_fp32"][iou_type]["AP"]
             for r in reports])
        if all("tf_oracle" in r for r in reports):
            out["deltas"][f"exact_vs_tf_oracle.{iou_type}.AP50"] = band(
                [r["exact_fp32"][iou_type]["AP50"]
                 - r["tf_oracle"][iou_type]["AP50"] for r in reports])
            out["deltas"][f"production_vs_tf_oracle.{iou_type}.AP"] = band(
                [r["production"][iou_type]["AP"]
                 - r["tf_oracle"][iou_type]["AP"] for r in reports])

    # cross-mode per-detection stability across seeds
    for pair in ("production_vs_exact_fp32", "exact_fp32_vs_tf_oracle",
                 "production_vs_tf_oracle"):
        rows = [r.get("cross_mode_deltas", {}).get(pair) for r in reports]
        if not all(rows):
            continue
        out["cross_mode"][pair] = {
            "n_matched": [r["n_matched"] for r in rows],
            "pairwise_mask_iou_mean": band(
                [r["pairwise_mask_iou_mean"] for r in rows]),
            "gt_iou_crossings_at_0.5": [r["gt_iou_crossings_at_0.5"]
                                        for r in rows],
        }

    if args.numerics:
        numerics = []
        for p in args.numerics:
            with open(p) as f:
                numerics.append(json.load(f))
        out["numerics"] = numerics_band(numerics, args.numerics)

    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out["deltas"].items()}, indent=1))
    if args.numerics:
        print(json.dumps(out["numerics"]["deltas_vs_exact_fp32"], indent=1))
    print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
