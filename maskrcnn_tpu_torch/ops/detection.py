"""Second-stage detection filtering: threshold -> refine -> per-class NMS ->
top-k, port of `maskrcnn_tpu/ops/detection.py`, batched over images.

  * class = argmax over all classes (first maximum on ties), score = max;
  * keep score >= threshold (inclusive), drop background class 0 and
    zero-area ROIs;
  * scale deltas by bbox_std_dev, apply, clip to [0, 1];
  * per-class greedy NMS as one NMS on boxes shifted by class_id * 2.0
    (classes never overlap), in descending score order with ties in ROI
    order (a stable sort, as `jnp.argsort`);
  * keep the first `max_detections`, zero-padded.
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.ops.boxes import apply_box_deltas, clip_boxes
from maskrcnn_tpu_torch.ops.common import device_constant
from maskrcnn_tpu_torch.ops.nms import nms_padded

_CLASS_STRIDE = 2.0


def refine_detections(rois: torch.Tensor, class_probs: torch.Tensor,
                      class_deltas: torch.Tensor, *,
                      bbox_std_dev=(0.1, 0.1, 0.2, 0.2),
                      score_threshold: float = 0.7,
                      nms_threshold: float = 0.3,
                      max_detections: int = 100):
    """(B, R, 4) rois, (B, R, K) probs, (B, R, K, 4) deltas ->
    detections (B, D, 6) rows (y1, x1, y2, x2, class_id, score) zero-padded,
    valid (B, D) bool, roi_indices (B, D) int64 (sentinel R for padding)."""
    b, r, _ = class_probs.shape
    rois = rois.to(torch.float32)
    class_probs = class_probs.to(torch.float32)
    class_id = torch.argmax(class_probs, dim=-1)                   # (B, R)
    score = torch.amax(class_probs, dim=-1)
    delta = torch.take_along_dim(
        class_deltas.to(torch.float32), class_id[..., None, None],
        dim=2)[:, :, 0, :]                                         # (B, R, 4)
    std = device_constant(tuple(map(float, bbox_std_dev)), torch.float32,
                          rois.device)
    refined = clip_boxes(apply_box_deltas(rois, delta * std))

    roi_area = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    cand = (score >= score_threshold) & (class_id > 0) & (roi_area > 0.0)

    order = torch.argsort(-score, dim=-1, stable=True)
    s_boxes = torch.take_along_dim(refined, order[..., None], dim=1)
    s_cand = torch.take_along_dim(cand, order, dim=1)
    s_class = torch.take_along_dim(class_id, order, dim=1)
    offset = s_class.to(torch.float32)[..., None] * _CLASS_STRIDE
    nms_idx, valid = nms_padded(s_boxes + offset, s_cand, nms_threshold,
                                max_detections)

    roi_indices = torch.take_along_dim(order, nms_idx.clamp(max=r - 1), dim=1)
    roi_indices = torch.where(valid, roi_indices,
                              torch.full_like(roi_indices, r))
    safe = roi_indices.clamp(max=r - 1)
    vf = valid.to(torch.float32)
    out_boxes = torch.take_along_dim(refined, safe[..., None], dim=1)
    out_class = torch.take_along_dim(class_id, safe, dim=1).to(torch.float32)
    out_score = torch.take_along_dim(score, safe, dim=1)
    detections = torch.cat([out_boxes * vf[..., None],
                            (out_class * vf)[..., None],
                            (out_score * vf)[..., None]], dim=-1)
    return detections, valid, roi_indices
