"""Flagship-scale end-to-end proof on the card, port of
`tools/flagship_proof.py`: from-scratch train -> calibrate -> evaluate at
resnet101 @ 1024^2 with 81-class heads.

It draws a synthetic COCO set from `--seed` (PIL-drawn colored shapes with
polygon segmentations, 4 categories; the val split is DISJOINT from train:
fresh scenes from the same generator), trains R101-FPN from scratch with
`cli train` (batch-statistic BN, then BN calibration), and scores the SAME
trained checkpoint under production numerics (bf16 + analytic anchors;
the config's approx top-k recall names a TPU mechanism, and the port's
top-k is always exact) and exact numerics (float32 + exact top-k + table
anchors; TF32 off on the card for that run, so float32 means float32).
With trained weights the scores saturate and the decision margins are
wide: the AP delta between the modes is what production numerics cost a
deployment. A proof of the machinery at flagship scale on synthetic data,
not a natural-image claim.

Beyond the AP tables, the report carries PER-DETECTION cross-mode deltas
(production vs exact vs TF oracle on the same trained weights): matched
box L-inf, score absdiff, pairwise mask IoU histogram, and each
detection's best same-class GT segm IoU per mode with 0.5/0.75-crossing
counts -- the statistics that attribute a segm AP spread to a named cause.
The report has the JAX tool's keys, so the two compare field by field,
plus `device` (the card's nvidia-smi name and power limit), `kernels` (the
port's kernel launches, `ops/cuda_lib.launches`, in training and in each
evaluate), `peak_memory_gb`, `train_steps_run`, `train_step_seconds` and
`train_log` (the logged losses).

Usage (on the card; training checkpoints to `<root>/ckpts` every 200 steps
and resumes from there, so a run cut short continues when it is run again
with the same `--root`):
  python3 -m maskrcnn_tpu_torch.tools.flagship_proof --root DIR --out FILE
  ... --skip-train      # reuse an existing trained checkpoint
  ... --tf-oracle       # also score the TF oracle (exits 2 without TF)
CPU smoke (plain PyTorch path):
  ... --tiny --arch resnet50 --image-size 128 --steps 2 --batch 1 \\
      --train-images 2 --val-images 1 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


# ---------------------------------------------------------------------------
# synthetic COCO dataset (flagship-sized images)
# ---------------------------------------------------------------------------

CATEGORIES = [
    {"id": 1, "name": "red_box"},
    {"id": 2, "name": "green_disk"},
    {"id": 3, "name": "blue_tri"},
    {"id": 4, "name": "gold_box"},
]
_FILL = {1: (205, 40, 30), 2: (40, 185, 60), 3: (35, 70, 215),
         4: (230, 200, 40)}


def _shape_polygon(cat, cx, cy, w, h):
    if cat in (1, 4):  # rectangle
        x0, y0, x1, y1 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
        return [x0, y0, x1, y0, x1, y1, x0, y1]
    if cat == 2:  # ellipse as a 24-gon
        pts = []
        for i in range(24):
            a = 2 * math.pi * i / 24
            pts += [cx + w / 2 * math.cos(a), cy + h / 2 * math.sin(a)]
        return pts
    # triangle
    return [cx, cy - h / 2, cx + w / 2, cy + h / 2, cx - w / 2, cy + h / 2]


def _poly_area(poly):
    xs, ys = poly[0::2], poly[1::2]
    s = 0.0
    for i in range(len(xs)):
        j = (i + 1) % len(xs)
        s += xs[i] * ys[j] - xs[j] * ys[i]
    return abs(s) / 2.0


def make_dataset(root, n_train, n_val, size, seed=0):
    """PIL-drawn scenes: 2-4 non-overlapping colored shapes on a textured
    background. val2017 is images n_train+1 .. n_train+n_val -- DISJOINT
    from train (same generator, fresh draws)."""
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(seed)
    img_dir_t = os.path.join(root, "data/coco/train2017")
    img_dir_v = os.path.join(root, "data/coco/val2017")
    os.makedirs(img_dir_t, exist_ok=True)
    os.makedirs(img_dir_v, exist_ok=True)

    images, anns = [], []
    ann_id = 1
    for img_id in range(1, n_train + n_val + 1):
        bg = rng.integers(150, 200, (size, size, 3), dtype=np.uint8)
        bg += rng.integers(0, 12, (size, size, 3), dtype=np.uint8)
        im = Image.fromarray(bg)
        draw = ImageDraw.Draw(im)
        placed = []  # (cx, cy, r) for overlap rejection
        for _ in range(int(rng.integers(2, 5))):
            cat = int(rng.integers(1, 5))
            w = float(rng.uniform(0.15, 0.37)) * size
            h = float(rng.uniform(0.15, 0.37)) * size
            r = max(w, h) / 2
            for _try in range(20):
                cx = float(rng.uniform(r + 10, size - r - 10))
                cy = float(rng.uniform(r + 10, size - r - 10))
                if all((cx - px) ** 2 + (cy - py) ** 2 > (r + pr + 20) ** 2
                       for px, py, pr in placed):
                    break
            else:
                continue
            placed.append((cx, cy, r))
            poly = _shape_polygon(cat, cx, cy, w, h)
            if cat == 2:
                draw.ellipse([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                             fill=_FILL[cat])
            else:
                draw.polygon(list(zip(poly[0::2], poly[1::2])),
                             fill=_FILL[cat])
            xs, ys = poly[0::2], poly[1::2]
            bbox = [min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)]
            anns.append({"id": ann_id, "image_id": img_id,
                         "category_id": cat, "bbox": bbox,
                         "segmentation": [poly], "area": _poly_area(poly),
                         "iscrowd": 0})
            ann_id += 1
        fname = f"{img_id:012d}.jpg"
        if img_id <= n_train:
            im.save(os.path.join(img_dir_t, fname), quality=92)
        else:
            im.save(os.path.join(img_dir_v, fname), quality=92)
        images.append({"id": img_id, "width": size, "height": size,
                       "file_name": fname})

    train = {"images": images[:n_train],
             "annotations": [a for a in anns if a["image_id"] <= n_train],
             "categories": CATEGORIES}
    val = {"images": images[n_train:],
           "annotations": [a for a in anns if a["image_id"] > n_train],
           "categories": CATEGORIES}
    ann_dir = os.path.join(root, "data/coco")
    with open(os.path.join(ann_dir, "instances_train2017.json"), "w") as f:
        json.dump(train, f)
    with open(os.path.join(ann_dir, "instances_val2017.json"), "w") as f:
        json.dump(val, f)
    return ann_dir


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def score(root, results_json, n_val):
    from maskrcnn_tpu_torch.evalkit.coco import COCODataset
    from maskrcnn_tpu_torch.evalkit.cocoeval import COCOEvaluator
    from maskrcnn_tpu_torch.evalkit.results import load_coco_results

    ds = COCODataset.from_dir(os.path.join(root, "data/coco"), "val", "2017")
    rows = load_coco_results(results_json)
    ids = [im.id for im in ds.iter_images(limit=n_val, sort_by_id=True)]
    out = {}
    for iou_type in ("bbox", "segm"):
        st = COCOEvaluator(ds, rows, iou_type, img_ids=ids).summarize(
            verbose=False)
        out[iou_type] = {"AP": round(float(st[0]), 4),
                         "AP50": round(float(st[1]), 4),
                         "AP75": round(float(st[2]), 4),
                         "AR100": round(float(st[8]), 4)}
    return out


def _box_iou_xywh(a, b):
    ax0, ay0, aw, ah = a
    bx0, by0, bw, bh = b
    ix = max(0.0, min(ax0 + aw, bx0 + bw) - max(ax0, bx0))
    iy = max(0.0, min(ay0 + ah, by0 + bh) - max(ay0, by0))
    inter = ix * iy
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


def cross_mode_deltas(root, results_by_mode, n_val):
    """Per-detection deltas between modes on the SAME trained weights.

    For every mode pair: greedy same-class box-IoU>=0.5 matching per image,
    then matched box L-inf (px), score absdiff, pairwise MASK IoU histogram;
    plus, per mode, each detection's best same-class GT segm IoU and the
    number of matched pairs whose GT IoU crosses the 0.5 / 0.75 protocol
    thresholds between modes (the detections that actually move AP50/AP75
    -- if the histogram is tight and crossings are few, a segm AP spread is
    threshold jitter on a handful of masks, not mask-path divergence)."""
    from maskrcnn_tpu_torch.evalkit import mask_rle as M
    from maskrcnn_tpu_torch.evalkit.coco import COCODataset
    from maskrcnn_tpu_torch.evalkit.results import load_coco_results

    ds = COCODataset.from_dir(os.path.join(root, "data/coco"), "val", "2017")

    def prep(path):
        rows = load_coco_results(path)
        by_img = {}
        for r in rows:
            im = ds.images[int(r["image_id"])]
            rle = M.from_coco_segmentation(r["segmentation"], im.height,
                                           im.width)
            # best same-class GT segm IoU (crowd-free synthetic data)
            best = 0.0
            for g in ds.annotations_for(int(r["image_id"])):
                if g["category_id"] != r["category_id"]:
                    continue
                g_rle = M.from_coco_segmentation(g["segmentation"],
                                                 im.height, im.width)
                best = max(best, float(M.iou_masks([rle], [g_rle],
                                                   [False])[0, 0]))
            r["_rle"], r["_gt_iou"] = rle, best
            by_img.setdefault(int(r["image_id"]), []).append(r)
        return by_img

    prepped = {m: prep(p) for m, p in results_by_mode.items()}
    out = {}
    names = list(prepped)
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a_name, b_name = names[i], names[j]
            pair_mask_ious, pair_box_linf, pair_score_d = [], [], []
            gt_cross_05, gt_cross_075 = 0, 0
            n_a = n_b = n_matched = 0
            for img_id in sorted(set(prepped[a_name]) |
                                 set(prepped[b_name])):
                da = prepped[a_name].get(img_id, [])
                db = prepped[b_name].get(img_id, [])
                n_a += len(da)
                n_b += len(db)
                cand = []
                for ai, ra in enumerate(da):
                    for bi, rb in enumerate(db):
                        if ra["category_id"] != rb["category_id"]:
                            continue
                        iou = _box_iou_xywh(ra["bbox"], rb["bbox"])
                        if iou >= 0.5:
                            cand.append((iou, ai, bi))
                used_a, used_b = set(), set()
                for iou, ai, bi in sorted(cand, reverse=True):
                    if ai in used_a or bi in used_b:
                        continue
                    used_a.add(ai)
                    used_b.add(bi)
                    n_matched += 1
                    ra, rb = da[ai], db[bi]
                    pair_box_linf.append(max(
                        abs(x - y) for x, y in zip(ra["bbox"], rb["bbox"])))
                    pair_score_d.append(abs(ra["score"] - rb["score"]))
                    pair_mask_ious.append(float(M.iou_masks(
                        [ra["_rle"]], [rb["_rle"]], [False])[0, 0]))
                    if (ra["_gt_iou"] >= 0.5) != (rb["_gt_iou"] >= 0.5):
                        gt_cross_05 += 1
                    if (ra["_gt_iou"] >= 0.75) != (rb["_gt_iou"] >= 0.75):
                        gt_cross_075 += 1
            mi = np.asarray(pair_mask_ious)
            buckets = [0.0, 0.5, 0.8, 0.9, 0.95, 0.99, 1.0 + 1e-9]
            hist = np.histogram(mi, buckets)[0].tolist() if mi.size else []
            out[f"{a_name}_vs_{b_name}"] = {
                "n_detections": [n_a, n_b],
                "n_matched": n_matched,
                "box_linf_px_mean": (float(np.mean(pair_box_linf))
                                     if pair_box_linf else None),
                "box_linf_px_max": (float(np.max(pair_box_linf))
                                    if pair_box_linf else None),
                "score_absdiff_max": (float(np.max(pair_score_d))
                                      if pair_score_d else None),
                "pairwise_mask_iou_mean": (float(mi.mean())
                                           if mi.size else None),
                "pairwise_mask_iou_min": (float(mi.min())
                                          if mi.size else None),
                "pairwise_mask_iou_hist": {
                    "buckets": "[0,.5) [.5,.8) [.8,.9) [.9,.95) "
                               "[.95,.99) [.99,1]",
                    "counts": hist},
                "gt_iou_crossings_at_0.5": gt_cross_05,
                "gt_iou_crossings_at_0.75": gt_cross_075,
            }
    return out


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def device_line(device) -> str:
    """nvidia-smi's name and power limit of the card, or the device."""
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    # the card this process runs on (CUDA_VISIBLE_DEVICES aside: card 0)
    return out.splitlines()[device.index or 0] if out else "nvidia-smi: none"


def exact_config(base):
    """The exact numerics of `base`: float32, exact top-k, table anchors."""
    return base.replace(compute_dtype="float32", proposal_topk_recall=None,
                        analytic_anchors=False)


class NoTF32:
    """float32 means float32 on the card: TF32 off in cuDNN and matmuls
    for the exact run, the previous setting back after it."""

    def __enter__(self):
        import torch

        b = torch.backends
        self._saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        b = torch.backends
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = self._saved


def run_counted(cli, argv, device, exact=False):
    """`cli(argv)` with the kernel launch counts zeroed just before and
    read just after, under `NoTF32` when `exact`; -> (rc, launches, peak
    device GB or None)."""
    import torch

    from maskrcnn_tpu_torch.ops import cuda_lib

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    cuda_lib.reset_launches()
    with NoTF32() if exact else contextlib.nullcontext():
        rc = cli(argv)
    if on_card:
        torch.cuda.synchronize(device)
    launches = dict(cuda_lib.launches)
    peak = (round(torch.cuda.max_memory_allocated(device) / 1e9, 3)
            if on_card else None)
    return rc, launches, peak


def _read_log(path):
    """The rows of a metrics JSONL file ([] before the first)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "flagship_proof"))
    ap.add_argument("--arch", default="resnet101")
    ap.add_argument("--image-size", type=int, default=1024)
    ap.add_argument("--train-images", type=int, default=32)
    ap.add_argument("--val-images", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--eval-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--tf-oracle", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink proposal/ROI counts (CPU smoke test)")
    ap.add_argument("--out", help="report path (default: "
                                  "<root>/flagship_proof.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    from maskrcnn_tpu_torch.cli.main import main as cli
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    from maskrcnn_tpu_torch.models.mask_rcnn import resolve_device
    from maskrcnn_tpu_torch.train.checkpoint import CheckpointManager

    device = resolve_device(args.device)   # raises without a card
    on = [] if args.device is None else ["--device", args.device]
    root = os.path.abspath(args.root)
    out_path = args.out or os.path.join(root, "flagship_proof.json")
    os.makedirs(root, exist_ok=True)
    ann_dir = make_dataset(root, args.train_images, args.val_images,
                           args.image_size, args.seed)
    print(f"# dataset at {root}: {args.train_images} train imgs "
          f"(val = first {args.val_images})", file=sys.stderr)

    base = MaskRCNNConfig(
        architecture=args.arch,
        input_image_shape=(args.image_size, args.image_size, 3))
    if args.tiny:
        base = base.replace(
            pre_nms_max_proposals=256, max_proposals=64, max_detections=16,
            train_rois_per_image=32, rpn_train_anchors_per_image=64)
    cfg_prod = os.path.join(root, "config_production.json")
    base.to_json(cfg_prod)
    cfg_exact = os.path.join(root, "config_exact.json")
    exact_config(base).to_json(cfg_exact)
    ckpt = os.path.join(root, "checkpoint.npz")
    ckpt_dir = os.path.join(root, "ckpts")
    metrics = os.path.join(root, "metrics.jsonl")

    report = {
        "architecture": args.arch, "image_size": args.image_size,
        "num_classes": base.num_classes,
        "train_images": args.train_images, "val_images": args.val_images,
        "steps": args.steps, "batch": args.batch, "seed": args.seed,
        "device": device_line(device),
    }
    kernels, peak = {}, {}

    if not args.skip_train or not os.path.exists(ckpt):
        found = CheckpointManager(ckpt_dir).latest_step_path()
        start_step = found[0] if found else 0
        logged = len(_read_log(metrics))
        t0 = time.time()
        # cache the (small) train set decoded, and checkpoint periodically
        # so an interrupted run resumes instead of retraining from scratch
        rc, kernels["train"], peak["train"] = run_counted(cli, [
            "train", "proof", "--config", cfg_prod,
            "--annotations", os.path.join(ann_dir, "instances_train2017.json"),
            "--images_dir", os.path.join(ann_dir, "train2017"),
            "--steps", str(args.steps), "--batch", str(args.batch),
            "--seed", str(args.seed), "--log-every", "50",
            "--output", ckpt,
            "--cache-images", str(2 * args.train_images),
            "--checkpoint-dir", ckpt_dir,
            "--checkpoint-every", "200", "--resume",
            "--metrics-log", metrics] + on, device)
        if rc != 0:
            print("train failed", file=sys.stderr)
            return rc
        report["train_seconds"] = round(time.time() - t0, 1)
        end = CheckpointManager(ckpt_dir).latest_step_path()
        report["train_steps_run"] = (end[0] if end else 0) - start_step
        rows = _read_log(metrics)[logged:]   # this run's rows
        if len(rows) >= 2 and rows[-1]["step"] > rows[0]["step"]:
            # steady state: from the first logged step to the last
            report["train_step_seconds"] = round(
                (rows[-1]["wall_s"] - rows[0]["wall_s"])
                / (rows[-1]["step"] - rows[0]["step"]), 4)
        report["train_log"] = [
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in r.items()} for r in rows]

    for mode, cfg in (("production", cfg_prod), ("exact_fp32", cfg_exact)):
        res_dir = os.path.join(root, f"results_{mode}")
        t0 = time.time()
        cmd = ["evaluate", "proof", "coco",
               "--limit", str(args.val_images),
               "--batch", str(args.eval_batch),
               "--config", cfg, "--weights", ckpt,
               "--annotations_dir", ann_dir,
               "--images_dir", os.path.join(ann_dir, "val2017"),
               "--results_dir", res_dir] + on
        if args.tf_oracle and mode == "production":
            cmd.append("--compare-tf")
        rc, kernels[mode], peak[mode] = run_counted(
            cli, cmd, device, exact=mode == "exact_fp32")
        if rc != 0:
            print(f"evaluate ({mode}) failed", file=sys.stderr)
            return rc
        stats = score(root, os.path.join(res_dir, "results.json"),
                      args.val_images)
        stats["eval_seconds_incl_compile"] = round(time.time() - t0, 1)
        report[mode] = stats
        print(f"# {mode}: {stats}", file=sys.stderr)
        tf_json = os.path.join(res_dir, "results_tf.json")
        if mode == "production" and args.tf_oracle and os.path.exists(
                tf_json):
            # same trained weights through the independent TF implementation
            report["tf_oracle"] = score(root, tf_json, args.val_images)
            print(f"# tf_oracle: {report['tf_oracle']}", file=sys.stderr)

    report["ap_delta_production_vs_exact"] = {
        t: round(report["production"][t]["AP"]
                 - report["exact_fp32"][t]["AP"], 4)
        for t in ("bbox", "segm")}

    # per-detection cross-mode deltas: statistics, not adjectives, for the
    # segm spread
    results_by_mode = {
        "production": os.path.join(root, "results_production/results.json"),
        "exact_fp32": os.path.join(root, "results_exact_fp32/results.json"),
    }
    if "tf_oracle" in report:
        results_by_mode["tf_oracle"] = os.path.join(
            root, "results_production/results_tf.json")
    report["cross_mode_deltas"] = cross_mode_deltas(root, results_by_mode,
                                                    args.val_images)
    for k, v in report["cross_mode_deltas"].items():
        print(f"# {k}: matched {v['n_matched']}, mask IoU mean "
              f"{v['pairwise_mask_iou_mean']}, GT-IoU 0.5 crossings "
              f"{v['gt_iou_crossings_at_0.5']}", file=sys.stderr)
    report["kernels"] = kernels
    report["peak_memory_gb"] = peak
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"# wrote {out_path}", file=sys.stderr)
    print(json.dumps({k: report[k] for k in
                      ("production", "exact_fp32",
                       "ap_delta_production_vs_exact") if k in report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
