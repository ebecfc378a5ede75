"""Time the segm results leg of `evaluate` at val2017 scale: paste ->
RLE -> score. The port's copy of `tools/bench_results_leg.py`.

`cli evaluate` builds segm results by pasting each detection's 28x28
soft mask into its image (`pipeline/detector.py::paste_mask_region`, or
`paste_mask` onto a full canvas), RLE-encoding it and scoring the rows
(`evalkit/results.py::detections_to_coco_results`, `COCOEvaluator`).
This tool times those three legs on a synthetic val2017-shaped workload
(5k images x 20 detections, 480x640). Host only: no card is used.

    python3 -m maskrcnn_tpu_torch.tools.bench_results_leg [--images 5000]
        [--dets 20] [--full-canvas] [--json FILE]

Default: the region path (`paste_masks="rle"`: region paste and an
O(box area) encode, no full canvas). `--full-canvas`: full-canvas paste
and a whole-canvas encode, every mask held live. Both modes write the
same RLE strings. The report keeps the JAX tool's keys, and what
`paste_s` and `encode_s` time differs between the modes: in region mode
`paste_s` is paste and encode, `encode_s` only the building of the
rows; with `--full-canvas`, `paste_s` is the paste alone and `encode_s`
the encode and the rows. `total_s` is the same leg in both.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from maskrcnn_tpu_torch.evalkit import mask_rle as M
from maskrcnn_tpu_torch.evalkit.coco import COCODataset
from maskrcnn_tpu_torch.evalkit.cocoeval import COCOEvaluator
from maskrcnn_tpu_torch.evalkit.results import detections_to_coco_results
from maskrcnn_tpu_torch.pipeline.detector import (Detection, paste_mask,
                                                  paste_mask_region)

H, W = 480, 640


def synth_detections(rng, n_dets, H, W):
    """n_dets plausible detections: soft disk masks + boxes, a few classes."""
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    dets = []
    for _ in range(n_dets):
        cy, cx = rng.uniform(8, 20, 2)
        r = rng.uniform(6, 12)
        soft = np.clip(1.2 - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r,
                       0, 1)
        y1 = rng.uniform(0, H * 0.7)
        x1 = rng.uniform(0, W * 0.7)
        bh = rng.uniform(12, H * 0.4)
        bw = rng.uniform(12, W * 0.4)
        dets.append((soft.astype(np.float32),
                     (y1, x1, min(y1 + bh, H), min(x1 + bw, W)),
                     int(rng.integers(1, 81)),
                     float(rng.random())))
    return dets


def synth(n_images, n_dets):
    """(dataset with ~7 rectangle gts an image, [(image id, soft mask,
    box, class, score)]), drawn from seed 0."""
    rng = np.random.default_rng(0)
    images, anns = [], []
    ann_id = 1
    raw = []
    for i in range(1, n_images + 1):
        images.append({"id": i, "width": W, "height": H,
                       "file_name": f"{i}.jpg"})
        for soft, box, cls, score in synth_detections(rng, n_dets, H, W):
            raw.append((i, soft, box, cls, score))
        for _ in range(7):
            x, y = rng.uniform(0, W * 0.8), rng.uniform(0, H * 0.8)
            w_, h_ = rng.uniform(8, 90), rng.uniform(8, 90)
            m = np.zeros((H, W), np.uint8)
            m[int(y):int(y + h_), int(x):int(x + w_)] = 1
            r_ = M.encode(m)
            anns.append({"id": ann_id, "image_id": i,
                         "category_id": int(rng.integers(1, 81)),
                         "bbox": [x, y, w_, h_], "area": float(m.sum()),
                         "iscrowd": 0,
                         "segmentation": {"size": [H, W],
                                          "counts": M.to_coco_counts(r_)}})
            ann_id += 1
    ds = COCODataset({"images": images, "annotations": anns,
                      "categories": [{"id": c, "name": f"c{c}"}
                                     for c in range(1, 81)]})
    return ds, raw


def results_rows(ds, raw, full_canvas):
    """Paste and encode every detection, then build its COCO rows, the
    way `cli evaluate` does: -> (rows, paste s, encode s)."""
    t0 = time.perf_counter()
    pasted = {}
    for img_id, soft, box, cls, score in raw:
        if full_canvas:
            det = Detection(box=box, class_id=cls, score=score,
                            mask=paste_mask(soft, box, (H, W)))
        else:
            region, ry, rx = paste_mask_region(soft, box, (H, W))
            rle = M.encode_region(region, ry, rx, H, W)
            det = Detection(box=box, class_id=cls, score=score,
                            rle={"size": [H, W],
                                 "counts": M.to_coco_counts(rle)})
        pasted.setdefault(img_id, []).append(det)
    t1 = time.perf_counter()
    rows = []
    for img_id, dets in pasted.items():
        rows.extend(detections_to_coco_results(img_id, dets, ds))
    t2 = time.perf_counter()
    return rows, t1 - t0, t2 - t1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=5000)
    ap.add_argument("--dets", type=int, default=20)
    ap.add_argument("--json")
    ap.add_argument("--full-canvas", action="store_true",
                    help="full-canvas paste + whole-canvas RLE encode "
                         "(default: the region path)")
    args = ap.parse_args(argv)

    ds, raw = synth(args.images, args.dets)
    rows, paste_s, encode_s = results_rows(ds, raw, args.full_canvas)
    t2 = time.perf_counter()
    ev = COCOEvaluator(ds, rows, "segm")
    stats = ev.summarize(verbose=False)
    score_s = time.perf_counter() - t2
    total_s = paste_s + encode_s + score_s

    n = len(raw)
    print(f"{args.images} images x {args.dets} dets = {n} detections")
    print(f"paste:   {paste_s:7.2f}s  ({paste_s / n * 1e3:.3f} ms/det)")
    print(f"encode:  {encode_s:7.2f}s  ({encode_s / n * 1e3:.3f} ms/det)")
    print(f"score:   {score_s:7.2f}s")
    print(f"TOTAL:   {total_s:7.2f}s   segm AP={stats[0]:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "metric": "segm_results_leg_seconds_val2017_scale",
                "images": args.images, "dets_per_image": args.dets,
                "mode": "full_canvas" if args.full_canvas else "region_rle",
                "paste_s": round(paste_s, 2),
                "encode_s": round(encode_s, 2),
                "score_s": round(score_s, 2),
                "total_s": round(total_s, 2),
            }, f, indent=1)
        print(f"# wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
