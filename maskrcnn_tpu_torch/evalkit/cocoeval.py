"""COCO-style AP/AR evaluation (bbox + segm), pycocotools-compatible.
Port of `maskrcnn_tpu/evalkit/cocoeval.py`. The matching hot loop runs in
native code (`native/src/evalmatch.cpp`, one call per (category, image)
covering all areas x thresholds); a vectorised numpy path gives the same
semantics without a toolchain (`match_all_areas(..., force_numpy=True)`).

Protocol details matched exactly:
  * area-range bounds are INCLUSIVE on both ends (a gt of area 32² is
    in-range for both "small" and "medium");
  * gt ignore = explicit ``ignore`` flag OR ``iscrowd`` OR area out of range;
  * equal-IoU ties go to the later-scanned gt; crowds can be matched by
    multiple detections; an ignored match never displaces a non-ignored one;
  * detection "area" is bbox area for bbox eval and MASK area for segm eval.

Detection results use the standard COCO results-list format:
    {"image_id", "category_id", "bbox": [x,y,w,h], "score",
     "segmentation": {"size": [h,w], "counts": str}}   # segm only
"""

from __future__ import annotations

import numpy as np

from maskrcnn_tpu_torch.evalkit import mask_rle as M
from maskrcnn_tpu_torch.evalkit.coco import COCODataset
from maskrcnn_tpu_torch.native import get_evalmatch_lib, p_f64, p_i64, p_u8

IOU_THRS = np.round(np.arange(0.5, 0.951, 0.05), 2)      # 10 thresholds
REC_THRS = np.round(np.arange(0.0, 1.001, 0.01), 2)      # 101 recall points
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _ann_area(g):
    b = g.get("bbox", [0, 0, 0, 0])
    return float(b[2] * b[3])


def _img_ious(dataset: COCODataset, gts, dts, img_id, iou_type: str):
    """IoU matrix (D,G) + detection areas. Detection area follows
    pycocotools' loadRes convention: bbox area for bbox eval, MASK area for
    segm eval (a segm-only results file need not carry a bbox at all)."""
    if not gts or not dts:
        return np.zeros((len(dts), len(gts))), [
            (float(d["bbox"][2]) * float(d["bbox"][3])) if iou_type == "bbox"
            else float(M.area(M.from_coco_segmentation(
                d["segmentation"], dataset.images[img_id].height,
                dataset.images[img_id].width)))
            for d in dts]
    iscrowd = [bool(g.get("iscrowd", 0)) for g in gts]
    if iou_type == "bbox":
        dt_areas = [float(d["bbox"][2]) * float(d["bbox"][3]) for d in dts]
        ious = M.iou_boxes(
            np.asarray([d["bbox"] for d in dts], float).reshape(-1, 4),
            np.asarray([g["bbox"] for g in gts], float).reshape(-1, 4),
            iscrowd)
    else:
        im = dataset.images[img_id]
        g_rle = [M.from_coco_segmentation(g["segmentation"], im.height,
                                          im.width) for g in gts]
        d_rle = [M.from_coco_segmentation(d["segmentation"], im.height,
                                          im.width) for d in dts]
        dt_areas = [float(M.area(r)) for r in d_rle]
        ious = M.iou_masks(d_rle, g_rle, iscrowd)
    return np.asarray(ious, np.float64), dt_areas


def match_all_areas(ious, g_areas, g_crowd, g_ignore_flag, d_areas,
                    area_rngs, iou_thrs=IOU_THRS, *, force_numpy=False):
    """Greedy matching for one (category, image) over every (area range,
    IoU threshold) pair.

    Args:
      ious: (D, G) float IoU matrix, detections pre-sorted by -score.
      g_areas / g_crowd / g_ignore_flag: per-gt area, iscrowd, ignore.
      d_areas: per-detection area (bbox or mask).
      area_rngs: (A, 2) inclusive [lo, hi] bounds.

    Returns dict with dtm (A,T,D) matched-gt indices (-1 unmatched),
    d_ignore (A,T,D) bool, n_gt (A,) non-ignored gt counts.
    """
    ious = np.ascontiguousarray(ious, np.float64)
    D, G = ious.shape
    area_rngs = np.asarray(area_rngs, np.float64).reshape(-1, 2)
    A, T = len(area_rngs), len(iou_thrs)
    g_areas = np.asarray(g_areas, np.float64).reshape(G)
    g_crowd = np.asarray(g_crowd, bool).reshape(G)
    g_ignore_flag = np.asarray(g_ignore_flag, bool).reshape(G)
    d_areas = np.asarray(d_areas, np.float64).reshape(D)

    lo, hi = area_rngs[:, :1], area_rngs[:, 1:]           # (A,1) each
    # INCLUSIVE bounds on both ends, as pycocotools checks them.
    g_ign = (g_ignore_flag | g_crowd)[None, :] | (
        (g_areas[None, :] < lo) | (g_areas[None, :] > hi))     # (A,G)
    d_out = (d_areas[None, :] < lo) | (d_areas[None, :] > hi)  # (A,D)

    lib = None if force_numpy else get_evalmatch_lib()
    if lib is not None:
        dtm = np.full((A, T, D), -1, np.int64)
        d_ignore = np.zeros((A, T, D), np.uint8)
        n_gt = np.zeros(A, np.int64)
        lib.eval_match(
            ious.ctypes.data_as(p_f64), D, G,
            np.ascontiguousarray(g_ign, np.uint8).ctypes.data_as(p_u8),
            np.ascontiguousarray(g_crowd, np.uint8).ctypes.data_as(p_u8),
            np.ascontiguousarray(d_out, np.uint8).ctypes.data_as(p_u8), A,
            np.ascontiguousarray(iou_thrs, np.float64).ctypes.data_as(p_f64),
            T,
            dtm.ctypes.data_as(p_i64),
            d_ignore.ctypes.data_as(p_u8),
            n_gt.ctypes.data_as(p_i64))
        return {"dtm": dtm, "d_ignore": d_ignore.astype(bool),
                "n_gt": n_gt}

    # Vectorized numpy path: loop over detections (score order is the
    # sequential dependency), broadcast over (A, T, G).
    thr = np.minimum(np.asarray(iou_thrs, np.float64), 1 - 1e-10)
    gtm = np.full((A, T, G), -1, np.int64)
    dtm = np.full((A, T, D), -1, np.int64)
    g_ign_at = np.broadcast_to(g_ign[:, None, :], (A, T, G))
    for di in range(D if G else 0):
        iou_row = ious[di]                                   # (G,)
        ok = iou_row[None, None, :] >= thr[None, :, None]    # (1,T,G)
        avail = (gtm < 0) | g_crowd[None, None, :]           # (A,T,G)
        cand = ok & avail
        cand_non = cand & ~g_ign_at
        use_ign = ~cand_non.any(-1, keepdims=True)
        cand_eff = np.where(use_ign, cand & g_ign_at, cand_non)
        iou_eff = np.where(cand_eff, iou_row[None, None, :], -1.0)
        best = iou_eff.max(-1)                               # (A,T)
        has = best >= 0
        if not has.any():
            continue
        # equal-IoU ties go to the LAST gt in scan order; within each
        # ignore class the scan is stable, so last = highest index.
        winner = G - 1 - np.argmax(iou_eff[..., ::-1] >= best[..., None],
                                   axis=-1)                  # (A,T)
        a_idx, t_idx = np.nonzero(has)
        w = winner[a_idx, t_idx]
        gtm[a_idx, t_idx, w] = di
        dtm[a_idx, t_idx, di] = w

    d_unmatched = np.broadcast_to(d_out[:, None, :], (A, T, D))
    if G == 0:
        d_ignore = d_unmatched.copy()
    else:
        d_ignore = np.where(
            dtm >= 0,
            np.take_along_axis(g_ign_at, np.maximum(dtm, 0), axis=-1),
            d_unmatched)
    return {"dtm": dtm, "d_ignore": d_ignore, "n_gt": (~g_ign).sum(-1)}


class COCOEvaluator:
    """evaluate() -> accumulate() -> summarize(), like pycocotools."""

    def __init__(self, dataset: COCODataset, results: list[dict],
                 iou_type: str = "bbox",
                 img_ids: list[int] | None = None):
        assert iou_type in ("bbox", "segm")
        self.dataset = dataset
        self.iou_type = iou_type
        self.img_ids = sorted(img_ids if img_ids is not None
                              else dataset.images)
        self.cat_ids = dataset.sorted_category_ids
        self.results_by_img: dict[int, list[dict]] = {}
        for r in results:
            self.results_by_img.setdefault(int(r["image_id"]), []).append(r)
        self._evals = None
        self.stats: np.ndarray | None = None
        self.precision = None
        self.recall = None

    def _grouped(self):
        """{(cat, img): (gts, dts)} for pairs with any content; dts sorted
        by descending score (stable) and capped at max(MAX_DETS)."""
        img_set = set(self.img_ids)
        by_pair: dict[tuple[int, int], tuple[list, list]] = {}

        def slot(cat, img):
            key = (int(cat), int(img))
            if key not in by_pair:
                by_pair[key] = ([], [])
            return by_pair[key]

        for img in self.img_ids:
            for g in self.dataset.annotations_for(img):
                slot(g["category_id"], img)[0].append(g)
        for img, dts in self.results_by_img.items():
            if img not in img_set:
                continue
            for d in dts:
                slot(d["category_id"], img)[1].append(d)
        cap = max(MAX_DETS)
        for key, (gts, dts) in by_pair.items():
            dts.sort(key=lambda d: -d["score"])
            del dts[cap:]
        return by_pair

    def evaluate(self):
        area_rngs = np.asarray(list(AREA_RNG.values()))
        evals = {}
        for (cat, img), (gts, dts) in self._grouped().items():
            ious, dt_areas = _img_ious(self.dataset, gts, dts, img,
                                       self.iou_type)
            m = match_all_areas(
                ious,
                [g.get("area", _ann_area(g)) for g in gts],
                [bool(g.get("iscrowd", 0)) for g in gts],
                [bool(g.get("ignore", 0)) for g in gts],
                dt_areas, area_rngs)
            m["scores"] = np.asarray([d["score"] for d in dts], float)
            evals[(cat, img)] = m
        self._evals = evals
        return self

    def accumulate(self):
        if self._evals is None:
            self.evaluate()
        t_n, r_n = len(IOU_THRS), len(REC_THRS)
        k_n, a_n, m_n = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((t_n, r_n, k_n, a_n, m_n))
        recall = -np.ones((t_n, k_n, a_n, m_n))

        # Concatenate per-image results in image-id order (pycocotools'
        # evalImgs order) so stable score-tie-breaking is reproduced.
        by_cat: dict[int, list] = {}
        for (cat, img) in sorted(self._evals):
            by_cat.setdefault(cat, []).append(self._evals[(cat, img)])

        for ki, cat in enumerate(self.cat_ids):
            per_img = by_cat.get(cat)
            if not per_img:
                continue
            for ai in range(a_n):
                n_gt = sum(int(e["n_gt"][ai]) for e in per_img)
                if n_gt == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [e["scores"][:max_det] for e in per_img])
                    order = np.argsort(-scores, kind="mergesort")
                    m = np.concatenate(
                        [e["dtm"][ai, :, :max_det] for e in per_img],
                        axis=1)[:, order]
                    ig = np.concatenate(
                        [e["d_ignore"][ai, :, :max_det] for e in per_img],
                        axis=1)[:, order]
                    tp_cum = np.cumsum((m >= 0) & ~ig, axis=1).astype(float)
                    fp_cum = np.cumsum((m < 0) & ~ig, axis=1).astype(float)
                    if tp_cum.shape[1] == 0:
                        recall[:, ki, ai, mi] = 0.0
                        precision[:, :, ki, ai, mi] = 0.0
                        continue
                    rc = tp_cum / n_gt                           # (T, N)
                    pr = tp_cum / np.maximum(tp_cum + fp_cum,
                                             np.spacing(1))
                    recall[:, ki, ai, mi] = rc[:, -1]
                    # monotone-decreasing interpolation from the right
                    pr = np.maximum.accumulate(pr[:, ::-1],
                                               axis=1)[:, ::-1]
                    for ti in range(t_n):
                        inds = np.searchsorted(rc[ti], REC_THRS,
                                               side="left")
                        valid = inds < pr.shape[1]
                        q = np.zeros(r_n)
                        q[valid] = pr[ti][inds[valid]]
                        precision[ti, :, ki, ai, mi] = q
        self.precision = precision
        self.recall = recall
        return self

    def _summary(self, ap=True, iou_thr=None, area="all", max_det=100):
        ai = list(AREA_RNG).index(area)
        mi = MAX_DETS.index(max_det)
        if ap:
            s = self.precision
            if iou_thr is not None:
                ti = np.where(np.isclose(IOU_THRS, iou_thr))[0]
                s = s[ti]
            s = s[:, :, :, ai, mi]
        else:
            s = self.recall
            if iou_thr is not None:
                ti = np.where(np.isclose(IOU_THRS, iou_thr))[0]
                s = s[ti]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self, verbose: bool = True) -> np.ndarray:
        if self.precision is None:
            self.accumulate()
        stats = np.array([
            self._summary(True),
            self._summary(True, iou_thr=0.5),
            self._summary(True, iou_thr=0.75),
            self._summary(True, area="small"),
            self._summary(True, area="medium"),
            self._summary(True, area="large"),
            self._summary(False, max_det=1),
            self._summary(False, max_det=10),
            self._summary(False, max_det=100),
            self._summary(False, area="small"),
            self._summary(False, area="medium"),
            self._summary(False, area="large"),
        ])
        self.stats = stats
        if verbose:
            names = [
                "AP @[0.50:0.95]", "AP @0.50", "AP @0.75",
                "AP small", "AP medium", "AP large",
                "AR maxDets=1", "AR maxDets=10", "AR maxDets=100",
                "AR small", "AR medium", "AR large",
            ]
            t = self.iou_type
            for n, v in zip(names, stats):
                print(f"  [{t}] {n:<16} = {v:.3f}")
        return stats
