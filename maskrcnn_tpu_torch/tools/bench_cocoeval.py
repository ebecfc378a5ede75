"""Time the in-process COCO evaluator at val2017 scale: the port's copy of
`tools/bench_cocoeval.py`, over the port's `evalkit`.

It draws a synthetic val2017-shaped workload (5k images, 80 categories,
~7 gts and ~20 detections an image, jittered boxes) and times
evaluate / accumulate / summarize for bbox or segm. Segm mode attaches
rectangle COCO-RLE segmentations (built analytically in the encoder's
column-major convention, equal to `mask_rle.encode` of the rasterized
rectangle), so the run takes the RLE parse and mask-IoU path at full
scale. Host only: no card is used.

    python3 -m maskrcnn_tpu_torch.tools.bench_cocoeval [--images 5000]
        [--numpy] [--iou-type {bbox,segm}] [--json FILE]

`--numpy` switches off the native matcher
(`evalkit/cocoeval.py::get_evalmatch_lib`) for the run.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from maskrcnn_tpu_torch.evalkit import cocoeval as ce
from maskrcnn_tpu_torch.evalkit import mask_rle as M
from maskrcnn_tpu_torch.evalkit.coco import COCODataset
from maskrcnn_tpu_torch.evalkit.cocoeval import COCOEvaluator


def rect_rle(x: float, y: float, w: float, h: float, H: int, W: int):
    """COCO-RLE counts string for an axis-aligned rectangle, analytically.

    Column-major runs starting with zeros (pycocotools convention): lead
    zeros to the rect's first column/row, then (h ones, H-h zeros) per
    column. Matches `mask_rle.encode` of the rasterized rect bit-exactly
    (a rect touching the bottom-right pixel would otherwise differ by a
    trailing zero run, which encode omits — dropped below).
    """
    x0, y0 = max(0, int(x)), max(0, int(y))
    x1 = min(W, max(x0 + 1, int(np.ceil(x + w))))
    y1 = min(H, max(y0 + 1, int(np.ceil(y + h))))
    rw, rh = x1 - x0, y1 - y0
    counts = [x0 * H + y0, rh] + [H - rh, rh] * (rw - 1)
    counts.append(H * W - sum(counts))
    if counts[-1] == 0:
        counts.pop()
    return M.to_coco_counts(M.RLE(H, W, np.asarray(counts, np.uint32)))


def rect_pixel_area(x: float, y: float, w: float, h: float,
                    H: int, W: int) -> int:
    """Pixel area of the clipped integer rect rect_rle rasterizes — the
    mask area a real COCO segm GT would carry (not the float bbox area)."""
    x0, y0 = max(0, int(x)), max(0, int(y))
    x1 = min(W, max(x0 + 1, int(np.ceil(x + w))))
    y1 = min(H, max(y0 + 1, int(np.ceil(y + h))))
    return (x1 - x0) * (y1 - y0)


def synth(n_images: int, seed: int = 0, iou_type: str = "bbox"):
    rng = np.random.default_rng(seed)
    images, anns, results = [], [], []
    ann_id = 1
    H, W = 480, 640

    def seg(bbox):
        if iou_type != "segm":
            return None
        return {"size": [H, W], "counts": rect_rle(*bbox, H, W)}

    for img in range(1, n_images + 1):
        images.append({"id": img, "width": 640, "height": 480,
                       "file_name": f"{img}.jpg"})
        n_gt = int(rng.poisson(7))
        cats = rng.integers(1, 81, size=n_gt)
        for c in cats:
            x, y = rng.uniform(0, 560), rng.uniform(0, 400)
            w, h = rng.uniform(4, 80), rng.uniform(4, 80)
            gt = {"id": ann_id, "image_id": img,
                  "category_id": int(c), "bbox": [x, y, w, h],
                  "area": w * h,
                  "iscrowd": int(rng.random() < 0.02)}
            if (s := seg(gt["bbox"])) is not None:
                gt["segmentation"] = s
                # real COCO segm GTs carry the mask's area: area ranges
                # bin by it
                gt["area"] = rect_pixel_area(x, y, w, h, H, W)
            anns.append(gt)
            # ~2 detections near each gt + noise below
            for _ in range(2):
                dt = {
                    "image_id": img, "category_id": int(c),
                    "bbox": [x + rng.normal(0, 4), y + rng.normal(0, 4),
                             w * rng.uniform(0.8, 1.2),
                             h * rng.uniform(0.8, 1.2)],
                    "score": float(rng.random())}
                if (s := seg(dt["bbox"])) is not None:
                    dt["segmentation"] = s
                results.append(dt)
            ann_id += 1
        for _ in range(6):  # pure false positives
            dt = {
                "image_id": img, "category_id": int(rng.integers(1, 81)),
                "bbox": [rng.uniform(0, 560), rng.uniform(0, 400),
                         rng.uniform(4, 80), rng.uniform(4, 80)],
                "score": float(rng.random() * 0.5)}
            if (s := seg(dt["bbox"])) is not None:
                dt["segmentation"] = s
            results.append(dt)
    cats = [{"id": i, "name": f"c{i}"} for i in range(1, 81)]
    ds = COCODataset({"images": images, "annotations": anns,
                      "categories": cats})
    return ds, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=5000)
    ap.add_argument("--numpy", action="store_true",
                    help="force the numpy fallback matcher")
    ap.add_argument("--json", help="write a stats JSON artifact here")
    ap.add_argument("--iou-type", choices=("bbox", "segm"), default="bbox")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    ds, results = synth(args.images, iou_type=args.iou_type)
    t1 = time.perf_counter()
    print(f"synth: {args.images} images, {len(ds.anns)} gts, "
          f"{len(results)} dts in {t1 - t0:.1f}s")

    native = ce.get_evalmatch_lib
    if args.numpy:
        ce.get_evalmatch_lib = lambda: None
    try:
        ev = COCOEvaluator(ds, results, args.iou_type)
        t2 = time.perf_counter()
        ev.evaluate()
        t3 = time.perf_counter()
        ev.accumulate()
        t4 = time.perf_counter()
        stats = ev.summarize(verbose=False)
        t5 = time.perf_counter()
    finally:
        ce.get_evalmatch_lib = native
    print(f"evaluate:   {t3 - t2:7.2f}s")
    print(f"accumulate: {t4 - t3:7.2f}s")
    print(f"summarize:  {t5 - t4:7.2f}s")
    print(f"TOTAL:      {t5 - t2:7.2f}s   AP={stats[0]:.4f} "
          f"AR100={stats[8]:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "metric":
                    f"cocoeval_{args.iou_type}_seconds_val2017_scale",
                "images": args.images,
                "gts": len(ds.anns),
                "dts": len(results),
                "matcher": "numpy" if args.numpy else "native",
                "evaluate_s": round(t3 - t2, 2),
                "accumulate_s": round(t4 - t3, 2),
                "total_s": round(t5 - t2, 2),
                "ap": round(float(stats[0]), 4),
                "ar100": round(float(stats[8]), 4),
            }, f, indent=1)
        print(f"# wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
