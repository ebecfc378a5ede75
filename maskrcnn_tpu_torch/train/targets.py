"""Static-shape training target assignment, port of
`maskrcnn_tpu/train/targets.py`, one image per call.

Ground truth arrives padded: boxes (G, 4) normalized y1x1y2x2, class ids
(G,) int32 (0 = padding slot, NEGATIVE = crowd region: excluded from
matching, and anchors or proposals overlapping a crowd are neutral rather
than negatives, the Matterport convention), instance masks as (G, M, M)
mini-masks in box-relative coordinates.

"Sampling" is fixed-size index selection: the top k of uniform random
scores masked to -1 where a slot is not eligible. The uniform scores are
arguments (`rand_p`, `rand_n`), so a caller draws them from its own
generator (`train/step.py::draw_uniforms`) and a test can hand in the JAX
package's `jax.random` draws. The top k is the stable one of
`ops/proposals.py::top_k_indices`: ties, which the -1 mask makes common
whenever positives are scarce, go to the lower index as in `lax.top_k`
(the JAX package's `approx_max_k` is that exact top k off a TPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maskrcnn_tpu_torch.ops.boxes import box_iou
from maskrcnn_tpu_torch.ops.proposals import top_k_indices


def encode_box_deltas(boxes: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Inverse of `apply_box_deltas`: the (dy, dx, log dh, log dw) that maps
    `boxes` onto `gt`. Shapes (..., 4)."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    cy = boxes[..., 0] + 0.5 * h
    cx = boxes[..., 1] + 0.5 * w
    gh = gt[..., 2] - gt[..., 0]
    gw = gt[..., 3] - gt[..., 1]
    gcy = gt[..., 0] + 0.5 * gh
    gcx = gt[..., 1] + 0.5 * gw
    h = h.clamp_min(1e-8)
    w = w.clamp_min(1e-8)
    return torch.stack([(gcy - cy) / h, (gcx - cx) / w,
                        torch.log(gh.clamp_min(1e-8) / h),
                        torch.log(gw.clamp_min(1e-8) / w)], dim=-1)


class RPNTargets(NamedTuple):
    labels: torch.Tensor      # (A,) int32: 1 pos, -1 neg, 0 neutral/unsampled
    pos_idx: torch.Tensor     # (K,) int64: sampled positive anchor slots
    pos_valid: torch.Tensor   # (K,) bool: which pos_idx rows are real
    pos_deltas: torch.Tensor  # (K, 4) f32, zero where not pos_valid


def rpn_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_class_ids: torch.Tensor, rand_p: torch.Tensor,
                rand_n: torch.Tensor, *, train_anchors: int = 256,
                positive_fraction: float = 0.5, pos_iou: float = 0.7,
                neg_iou: float = 0.3, crowd_iou: float = 0.001,
                bbox_std_dev=(0.1, 0.1, 0.2, 0.2)) -> RPNTargets:
    """Label (A, 4) anchors against one image's GT and subsample a balanced
    set; `rand_p`, `rand_n` (A,) uniform scores.

    Positive: IoU >= pos_iou with a real GT, or the best anchor of some GT
    (every anchor within 1e-7 of that GT's best IoU, where it is > 0).
    Negative: max IoU < neg_iou, not positive, and no crowd overlap.
    At most train_anchors * positive_fraction positives are kept and
    negatives fill the rest of train_anchors; the box targets exist at the
    K sampled positive slots only."""
    a = anchors.shape[0]
    dev = anchors.device
    full_iou = box_iou(anchors, gt_boxes)                          # (A, G)
    fg = (gt_class_ids > 0)[None, :]
    crowd = (gt_class_ids < 0)[None, :]
    iou = full_iou * fg.to(full_iou.dtype)
    crowd_overlap = (full_iou * crowd.to(full_iou.dtype)).max(dim=1).values

    max_iou = iou.max(dim=1).values
    argmax_gt = iou.argmax(dim=1)          # first maximum, as jnp.argmax

    per_gt_best = iou.max(dim=0, keepdim=True).values               # (1, G)
    is_best_for_gt = ((iou >= per_gt_best - 1e-7)
                      & (per_gt_best > 0.0)).any(dim=1)

    pos = (max_iou >= pos_iou) | is_best_for_gt
    neg = (max_iou < neg_iou) & ~pos & (crowd_overlap < crowd_iou)

    k_pos = int(train_anchors * positive_fraction)
    minus1 = torch.full_like(rand_p, -1.0)
    pos_idx = top_k_indices(torch.where(pos, rand_p, minus1), min(k_pos, a))
    pos_sampled = torch.zeros(a, dtype=torch.bool, device=dev)
    pos_sampled[pos_idx] = True
    pos_sampled &= pos
    n_pos = pos_sampled.sum()

    k_neg_max = min(train_anchors, a)
    neg_idx = top_k_indices(torch.where(neg, rand_n, minus1), k_neg_max)
    take = torch.arange(k_neg_max, device=dev) < (train_anchors - n_pos)
    neg_sampled = torch.zeros(a, dtype=torch.bool, device=dev)
    neg_sampled[neg_idx] = take
    neg_sampled &= neg

    labels = torch.where(pos_sampled, 1, torch.where(neg_sampled, -1, 0))

    pos_valid = pos_sampled[pos_idx]
    sel_anchors = anchors[pos_idx]
    sel_gt = gt_boxes[argmax_gt[pos_idx]]
    std = torch.tensor(bbox_std_dev, dtype=torch.float32, device=dev)
    pos_deltas = encode_box_deltas(sel_anchors, sel_gt) / std
    pos_deltas = pos_deltas * pos_valid[:, None]
    return RPNTargets(labels.to(torch.int32), pos_idx, pos_valid,
                      pos_deltas.to(torch.float32))


class ProposalTargets(NamedTuple):
    rois: torch.Tensor        # (T, 4) sampled proposals, zero where invalid
    roi_valid: torch.Tensor   # (T,) bool: real sampled rois
    class_ids: torch.Tensor   # (T,) int64 target class (0 = background/pad)
    deltas: torch.Tensor      # (T, 4), zero unless positive
    masks: torch.Tensor       # (T, m, m) {0, 1}, zero unless positive
    positive: torch.Tensor    # (T,) bool


def _crop_minimask(minimask: torch.Tensor, rel_box: torch.Tensor,
                   out_size: int) -> torch.Tensor:
    """Bilinear samples of (N, M, M) mini-masks at (N, 4) ROI boxes in
    GT-box-relative coordinates -> (N, out, out): the crop_and_resize grid
    with ZERO outside the GT box (not an edge clamp, which would smear the
    box's foreground border over any ROI overhang)."""
    n, m = minimask.shape[0], minimask.shape[1]
    dev = minimask.device
    steps = (torch.arange(out_size, dtype=torch.float32, device=dev)
             / max(out_size - 1, 1))
    y1, x1, y2, x2 = rel_box.unbind(-1)
    ys = (y1[:, None] + steps * (y2 - y1)[:, None]) * (m - 1)
    xs = (x1[:, None] + steps * (x2 - x1)[:, None]) * (m - 1)
    y_in = (ys >= 0.0) & (ys <= m - 1.0)
    x_in = (xs >= 0.0) & (xs <= m - 1.0)
    ys = ys.clamp(0.0, m - 1.0)
    xs = xs.clamp(0.0, m - 1.0)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1i = (y0 + 1).clamp(max=m - 1)
    x1i = (x0 + 1).clamp(max=m - 1)
    wy = (ys - y0)[:, :, None]
    wx = (xs - x0)[:, None, :]
    g = minimask.to(torch.float32)
    bi = torch.arange(n, device=dev)[:, None, None]

    def at(yi, xi):
        return g[bi, yi[:, :, None], xi[:, None, :]]

    top = at(y0, x0) * (1 - wx) + at(y0, x1i) * wx
    bot = at(y1i, x0) * (1 - wx) + at(y1i, x1i) * wx
    out = top * (1 - wy) + bot * wy
    return out * (y_in[:, :, None] & x_in[:, None, :])


def proposal_targets(proposals: torch.Tensor, proposal_valid: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_class_ids: torch.Tensor,
                     gt_minimasks: torch.Tensor, rand_p: torch.Tensor,
                     rand_n: torch.Tensor, *, num_rois: int = 200,
                     positive_fraction: float = 0.33, pos_iou: float = 0.5,
                     mask_size: int = 28,
                     bbox_std_dev=(0.1, 0.1, 0.2, 0.2)) -> ProposalTargets:
    """Sample (P, 4) proposals into a fixed-size training set with targets;
    `rand_p`, `rand_n` (P,) uniform scores.

    Positives (IoU >= pos_iou with some real GT) up to
    round(num_rois * positive_fraction), negatives (IoU < pos_iou, no
    crowd overlap) fill the rest. A positive gets the matched GT's class,
    its encoded deltas and the GT mini-mask cropped to the ROI,
    thresholded at 0.5."""
    dev = proposals.device
    gt_valid = gt_class_ids > 0
    full_iou = box_iou(proposals, gt_boxes)
    iou = full_iou * gt_valid[None, :]
    crowd = (gt_class_ids < 0)[None, :]
    crowd_overlap = (full_iou * crowd.to(full_iou.dtype)).max(dim=1).values
    max_iou = iou.max(dim=1).values
    argmax_gt = iou.argmax(dim=1)

    pos = (max_iou >= pos_iou) & proposal_valid
    neg = (max_iou < pos_iou) & proposal_valid & (crowd_overlap < 0.001)

    k_pos = int(round(num_rois * positive_fraction))
    k_neg = num_rois - k_pos
    p = proposals.shape[0]
    minus1 = torch.full_like(rand_p, -1.0)
    pos_idx = top_k_indices(torch.where(pos, rand_p, minus1), min(k_pos, p))
    neg_idx = top_k_indices(torch.where(neg, rand_n, minus1), min(k_neg, p))

    pos_ok = pos[pos_idx]
    neg_ok = neg[neg_idx]
    idx = torch.cat([pos_idx, neg_idx])
    ok = torch.cat([pos_ok, neg_ok])
    is_pos = torch.cat([pos_ok, torch.zeros_like(neg_ok)])

    rois = proposals[idx] * ok[:, None]
    gt_idx = argmax_gt[idx]
    matched_box = gt_boxes[gt_idx]
    matched_class = gt_class_ids[gt_idx]

    class_ids = torch.where(is_pos, matched_class.to(torch.int64), 0)
    std = torch.tensor(bbox_std_dev, dtype=torch.float32, device=dev)
    deltas = encode_box_deltas(rois, matched_box) / std
    deltas = deltas * is_pos[:, None]

    gh = (matched_box[:, 2] - matched_box[:, 0]).clamp_min(1e-8)
    gw = (matched_box[:, 3] - matched_box[:, 1]).clamp_min(1e-8)
    rel = torch.stack([(rois[:, 0] - matched_box[:, 0]) / gh,
                       (rois[:, 1] - matched_box[:, 1]) / gw,
                       (rois[:, 2] - matched_box[:, 0]) / gh,
                       (rois[:, 3] - matched_box[:, 1]) / gw], dim=1)
    masks = _crop_minimask(gt_minimasks[gt_idx], rel, mask_size)
    masks = (masks >= 0.5).to(torch.float32) * is_pos[:, None, None]
    return ProposalTargets(rois=rois.to(torch.float32), roi_valid=ok,
                           class_ids=class_ids,
                           deltas=deltas.to(torch.float32), masks=masks,
                           positive=is_pos)
