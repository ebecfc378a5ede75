"""Judge the program's outputs with the plain reference.

Random weights put near-ties everywhere (81 class probabilities near
1/81, RPN scores in runs of equal values over the letterbox padding), so
the discrete choices of a bfloat16 program and a float32 reference part
on rounding. The judge therefore follows the program's own choices and
compares the continuous values behind them, computed again in float32
from the same canvases and raw weights:

  proposal_box    each proposal against the nearest box the reference
                  decodes from any anchor: L-inf gap over the box's size
  det_box         each detection against the nearest box the reference
                  refines from any proposal for the detection's class
  score           relative gap of the detection's score to the
                  reference's probability of its class
  mask            largest gap of a 28x28 mask value to the reference's
                  mask at the program's box and class
  paste           (pasted masks only) pasted pixels that disagree with
                  the reference's paste of the program's own masks at its
                  boxes, outside a band of PASTE_BAND around the
                  threshold: exact, limit 0 (the masks' precision is
                  `mask`'s to judge)
  left_out        images for which the program returned no proposal or
                  no detection where the reference's own pipeline has
                  some: exact, limit 0 (counts themselves are discrete
                  choices: a run of tied RPN scores over the letterbox
                  padding moves the proposal count across the 6000 cut)

and, of the program's discrete choices, what greedy NMS and the class
argmax guarantee, in float32 at the program's own boxes:

  proposal_iou    largest IoU of two kept proposals (K1's keep flags;
                  the configuration's proposal NMS threshold bounds it)
  det_iou         largest IoU of two kept detections of one class (the
                  detection NMS threshold bounds it)
  proposal_cover  each of the reference's top pre-NMS candidates that
                  the program certainly processed (its RPN score SCORE_BAND
                  standard deviations above the reference's score at the
                  last rank the program processed: the pre-NMS count, or
                  the kept count where the program kept the maximum) must
                  overlap a kept proposal above the threshold: the largest
                  shortfall, threshold - IoU, over candidates at least
                  MIN_SIDE_PX on each side
  det_cover       the same for the detections: each valid proposal whose
                  reference class is foreground and clear (its logit leads
                  the runner-up by the cell's `class_gap` limit), scoring
                  SCORE_REL above the lowest kept detection where the
                  program kept the maximum, must overlap a kept detection
                  of its class
  class_gap       the reference's best logit less the logit of the class
                  the program reports, at the detection's proposal

Each is the largest over every proposal, detection and image judged;
`proposal_box_far` is the share of the same values above FAR (the widest
proposal gap swings with single proposals from seed to seed, and their
mean with the seed's weights). `explain` collects, per image, the program's and the
reference's counts of proposals and detections, how many proposals lie
far off, the worst proposal, and how many candidates the two cover
numbers judged, with the worst of each.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference import model as R

PASTE_BAND = 1e-4
FAR = 0.05          # a proposal this far off, over its size, is far
SCORE_BAND = 0.25   # standard deviations of the image's RPN scores
SCORE_REL = 0.1     # relative, against the lowest kept detection's score
MIN_SIDE_PX = 2     # thinner candidates may have no area in the program
NUMBERS = ("proposal_box", "det_box", "score", "mask", "paste", "left_out",
           "proposal_iou", "det_iou", "proposal_cover", "det_cover",
           "class_gap")
SHARES = ("proposal_box",)


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _linf(a, b):
    """(N, 4) x (M, 4) -> (N, M) largest coordinate gap."""
    d = (a[:, None, 0] - b[None, :, 0]).abs()
    for k in (1, 2, 3):
        d = torch.maximum(d, (a[:, None, k] - b[None, :, k]).abs())
    return d


def _nearest(q, table, chunk=16384):
    """For each row of q (N, 4), the smallest L-inf gap to a row of table
    and the row's index."""
    best = torch.full((q.shape[0],), float("inf"), device=q.device)
    idx = torch.zeros((q.shape[0],), dtype=torch.long, device=q.device)
    for s in range(0, table.shape[0], chunk):
        d, i = _linf(q, table[s:s + chunk]).min(1)
        better = d < best
        best = torch.where(better, d, best)
        idx = torch.where(better, i + s, idx)
    return best, idx


def _size(boxes, floor):
    return torch.maximum(torch.maximum(boxes[:, 2] - boxes[:, 0],
                                       boxes[:, 3] - boxes[:, 1]),
                         torch.full_like(boxes[:, 0], floor))


def _iou(a, b):
    """(N, 4) x (M, 4) -> (N, M) IoU in float32; 0 where the union is 0."""
    iy = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp_min(0)
    ix = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp_min(0)
    inter = iy * ix
    union = R.area(a)[:, None] + R.area(b)[None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-30),
                       torch.zeros_like(inter))


def _max_pair_iou(boxes, same=None):
    """Largest IoU of two different rows (of one class, with `same`)."""
    if boxes.shape[0] < 2:
        return torch.zeros(())
    iou = _iou(boxes, boxes)
    iou.fill_diagonal_(0)
    if same is not None:
        iou = torch.where(same, iou, torch.zeros_like(iou))
    return iou.max()


def _shortfall(threshold, iou, eligible, why=None):
    """Largest `threshold - best IoU` over the eligible rows of (N, K),
    and how many rows were eligible; `why` (a dict) gets the worst row's
    index and best IoU."""
    n = int(eligible.sum())
    if not n:
        return torch.zeros(()), 0
    best = (iou.amax(1) if iou.shape[1]
            else torch.zeros(iou.shape[0], device=iou.device))
    short = torch.where(eligible, (threshold - best).clamp_min(0),
                        torch.full_like(best, -1.0))
    w = int(short.argmax())
    if why is not None:
        why.update(row=w, best_iou=float(best[w]))
    return short[w], n


def _min_side(boxes):
    return torch.minimum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])


def _proposal_cover(fg, boxes, kept, cfg, min_side, why=None):
    """`proposal_cover` for one image: fg (A,) reference RPN scores, boxes
    (A, 4) the reference's decoded boxes, kept (P, 4) the program's.

    The program processed at least its top `pre_nms_max_proposals`
    candidates, or, where it stopped at `max_proposals` kept, its top
    `max_proposals`: a candidate SCORE_BAND standard deviations above the
    reference's score at that rank was among them."""
    k = min(cfg.pre_nms_max_proposals, fg.numel())
    s, order = torch.sort(fg, descending=True, stable=True)
    seen = min(kept.shape[0], k) if kept.shape[0] >= cfg.max_proposals else k
    cut = (s[seen - 1] + SCORE_BAND * fg.std() if seen < fg.numel()
           else s[-1] - 1)
    s, cb = s[:k], boxes[order[:k]]
    eligible = (s > cut) & (_min_side(cb) > min_side)
    iou = _iou(cb, kept)
    short, n = _shortfall(cfg.proposal_nms_threshold, iou, eligible, why)
    if why is not None and n:
        w = why["row"]
        why.update(rank=w, score=float(s[w]), cut=float(cut),
                   sigma=float(fg.std()), box=cb[w].tolist())
    return short, n


def _det_cover(lg, dl, rois, dets, cfg, std, min_side, class_band,
               why=None):
    """`det_cover` for one image: lg (R, K) and dl (R, K, 4) the
    reference's head at the program's valid proposals rois (R, 4), dets
    (D, 6) the program's kept detections. A proposal's class is clear when
    its best logit leads the next by `class_band`."""
    top = lg.topk(2, dim=-1)
    cls = top.indices[:, 0]
    p = torch.softmax(lg, -1).amax(-1)
    boxes = R.apply_deltas(
        rois, dl[torch.arange(rois.shape[0], device=rois.device), cls]
        * std).clamp(0, 1)
    eligible = ((cls > 0) & (top.values[:, 0] - top.values[:, 1] > class_band)
                & (R.area(rois) > 0) & (_min_side(boxes) > min_side)
                & (p >= cfg.detection_score_threshold * (1 + SCORE_REL)))
    if dets.shape[0] >= cfg.max_detections:
        eligible &= p > dets[:, 5].min() * (1 + SCORE_REL)
    iou = _iou(boxes, dets[:, :4])
    iou = torch.where(cls[:, None] == dets[None, :, 4].long(), iou,
                      torch.zeros_like(iou))
    short, n = _shortfall(cfg.detection_nms_threshold, iou, eligible, why)
    if why is not None and n:
        w = why["row"]
        why.update(cls=int(cls[w]), p=float(p[w]), box=boxes[w].tolist(),
                   margin=float(top.values[w, 0] - top.values[w, 1]))
    return short, n


def _clean(values: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(values.float(), nan=float("inf"))


def _own_counts(params, pyramid, logits, deltas, anc, cfg, nx):
    """The reference's own proposal and detection counts per image."""
    std = torch.tensor(cfg.bbox_std_dev, device=anc.device)
    counts = []
    for i in range(logits.shape[0]):
        fg = logits[i, :, 1] - logits[i, :, 0]
        top = torch.sort(fg, descending=True, stable=True).indices[
            :cfg.pre_nms_max_proposals]
        boxes = R.apply_deltas(anc[top], deltas[i, top] * std).clamp(0, 1)
        keep = R.greedy_nms(boxes, torch.ones_like(top, dtype=torch.bool),
                            cfg.proposal_nms_threshold, cfg.max_proposals)
        rois = boxes[keep]
        lv = [p[i:i + 1] for p in pyramid[:4]]
        pooled = R.roi_align(lv, rois[None], cfg.pool_size, cfg)[0]
        lg, dl = R.classifier_head(params, pooled, nx)
        probs = torch.softmax(lg, -1)
        cid, score = probs.argmax(-1), probs.amax(-1)
        refined = R.apply_deltas(
            rois, dl[torch.arange(len(keep), device=anc.device), cid]
            * std).clamp(0, 1)
        cand = ((score >= cfg.detection_score_threshold) & (cid > 0)
                & (R.area(rois) > 0))
        order = torch.argsort(-score, stable=True)
        kept = R.greedy_nms(refined[order] + cid[order, None].float() * 2.0,
                            cand[order], cfg.detection_nms_threshold,
                            cfg.max_detections)
        counts.append((len(keep), len(kept)))
    return counts


@torch.no_grad()
def judge_block(params, cfg, images_u8, got, class_band, explain=None
                ) -> dict[str, torch.Tensor]:
    """The numbers for one block of images: (B, H, W, 3) uint8 canvases
    on the reference's device and the program's outputs for them (same
    keys as `model.detect`, on that device); `class_band` as in
    `judge`."""
    nx = R.Numerics("float32")
    dev = images_u8.device
    std = torch.tensor(cfg.bbox_std_dev, device=dev)
    floor = min(cfg.anchor_scales) / (cfg.image_height - 1)
    min_side = MIN_SIDE_PX / (cfg.image_height - 1)
    out: dict[str, list] = {k: [] for k in NUMBERS}
    with no_tf32():
        pyramid = R.backbone_fpn(params, images_u8, cfg, nx)
        logits, deltas = R.rpn(params, pyramid, nx)
        anc = R.anchors(cfg, dev)
        counts = _own_counts(params, pyramid, logits, deltas, anc, cfg, nx)
        for i in range(images_u8.shape[0]):
            rv = got["roi_valid"][i].bool()
            dv = got["valid"][i].bool()
            n_rois, n_dets = counts[i]
            out["left_out"].append(torch.tensor(float(
                (n_rois > 0 and not rv.any()) or (n_dets > 0
                                                  and not dv.any()))))
            if explain is not None:
                explain.append({"counts": [int(rv.sum()), int(dv.sum()),
                                           n_rois, n_dets]})
            # proposals
            rois = got["rois"][i].float()
            ref_boxes = R.apply_deltas(anc, deltas[i] * std).clamp(0, 1)
            gap, a_idx = _nearest(rois[rv], ref_boxes)
            rel = gap / _size(rois[rv], floor)
            out["proposal_box"].append(rel)
            out["proposal_iou"].append(_max_pair_iou(rois[rv]))
            why_p: dict = {}
            cover, n_cover = _proposal_cover(
                logits[i, :, 1] - logits[i, :, 0], ref_boxes, rois[rv], cfg,
                min_side, why_p)
            out["proposal_cover"].append(cover)
            if explain is not None and rel.numel():
                explain.append({"far": [int((rel > t).sum())
                                        for t in (0.02, 0.05, 0.2, 1.0)]})
                w = int(rel.argmax())
                explain.append({"gap": float(rel[w]), "anchor": int(a_idx[w]),
                                "box": rois[rv][w].tolist(),
                                "ref_delta": deltas[i, a_idx[w]].tolist()})
            # classifier head at the program's proposals
            lv = [p[i:i + 1] for p in pyramid[:4]]
            pooled = R.roi_align(lv, rois[None], cfg.pool_size, cfg)[0]
            lg, dl = R.classifier_head(params, pooled, nx)
            dets = got["detections"][i].float()[dv]
            cls = dets[:, 4].long()
            roi_ok = rv.nonzero().flatten()
            out["det_iou"].append(_max_pair_iou(
                dets[:, :4], cls[:, None] == cls[None, :]))
            why_d: dict = {}
            cover, n_det_cover = _det_cover(lg[roi_ok], dl[roi_ok],
                                            rois[roi_ok], dets, cfg, std,
                                            min_side, class_band, why_d)
            out["det_cover"].append(cover)
            if explain is not None:
                explain.append({"eligible": [n_cover, n_det_cover],
                                "uncovered": [why_p, why_d]})
            if dets.shape[0]:
                refined = R.apply_deltas(
                    rois[roi_ok][None], dl[roi_ok][:, cls].permute(1, 0, 2)
                    * std).clamp(0, 1)                       # (D, R, 4)
                d = (refined - dets[:, None, :4]).abs().amax(-1)
                best, r = d.min(1)
                r = roi_ok[r]
                out["det_box"].append(best / _size(dets[:, :4], floor))
                p_ref = torch.softmax(lg[r], -1).gather(1, cls[:, None])[:, 0]
                out["score"].append((dets[:, 5] - p_ref).abs() / p_ref)
                out["class_gap"].append(lg[r].amax(-1) - lg[r].gather(
                    1, cls[:, None])[:, 0])
            # mask head at the program's detections
            det_all = got["detections"][i].float()
            mpool = R.roi_align(lv, det_all[None, :, :4], cfg.mask_pool_size,
                                cfg)[0]
            ref_masks = R.mask_head(params, mpool, det_all[:, 4].long(), nx)
            out["mask"].append(
                (got["masks"][i].float()[dv] - ref_masks[dv]).abs())
            if "pasted" in got:
                s = got["pasted"].shape[-1]
                masks = got["masks"][i].float()
                wrong = torch.zeros((), dtype=torch.long, device=dev)
                for j in dv.nonzero().flatten().split(10):
                    soft = R.paste_soft(masks[j], det_all[j, :4], s)
                    off = (got["pasted"][i, j].bool() != (soft >= 0.5)) & \
                        ((soft - 0.5).abs() > PASTE_BAND)
                    wrong += off.sum()
                out["paste"].append(wrong.float())
    return {k: torch.cat([v.flatten().cpu() for v in vals])
            for k, vals in out.items() if vals}


def judge(params, cfg, images_u8, got, class_band: float, block: int = 2,
          explain=None) -> dict[str, float]:
    """`judge_block` over blocks of `block` images: each number's largest
    value, and for `SHARES` the share above FAR. `got` holds the program's outputs
    for the images, batch first; `paste` is left out where the outputs
    carry no pasted masks. `class_band`: the logits by which a class must
    lead to count as clear in `det_cover`. `explain` (a list) collects
    each image's counts, worst proposal and worst uncovered candidates."""
    values: dict[str, list] = {}
    for s in range(0, images_u8.shape[0], block):
        part = {k: v[s:s + block] for k, v in got.items()}
        for k, v in judge_block(params, cfg, images_u8[s:s + block], part,
                                class_band, explain).items():
            values.setdefault(k, []).append(v)
    numbers = {}
    for k in NUMBERS:
        if k == "paste" and "pasted" not in got:
            continue
        v = _clean(torch.cat(values[k])) if k in values else torch.zeros(1)
        numbers[k] = float(v.max()) if v.numel() else 0.0
        if k in SHARES:
            numbers[k + "_far"] = (float((v > FAR).float().mean())
                                   if v.numel() else 0.0)
    return numbers
