"""Box geometry ops on (..., 4) = (y1, x1, y2, x2) tensors, port of
`maskrcnn_tpu/ops/boxes.py`.

Same float32 operation order as the JAX package, so decisions made on these
values (NMS, level choice) agree exactly:
  * delta decode: center += d_yx * size; size *= exp(d_hw); y2 = y1 + h;
  * clip to [0, 1];
  * IoU is 0 when either box has non-positive area (zero padding is inert).
"""

from __future__ import annotations

import torch


def apply_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Refine (..., 4) y1x1y2x2 boxes by (dy, dx, log dh, log dw) deltas."""
    y1, x1, y2, x2 = boxes.unbind(-1)
    dy, dx, dh, dw = deltas.unbind(-1)
    height = y2 - y1
    width = x2 - x1
    center_y = y1 + 0.5 * height + dy * height
    center_x = x1 + 0.5 * width + dx * width
    height = height * torch.exp(dh)
    width = width * torch.exp(dw)
    ny1 = center_y - 0.5 * height
    nx1 = center_x - 0.5 * width
    return torch.stack([ny1, nx1, ny1 + height, nx1 + width], dim=-1)


def clip_boxes(boxes: torch.Tensor, lo: float = 0.0,
               hi: float = 1.0) -> torch.Tensor:
    return boxes.clamp(lo, hi)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...,) signed area (h * w); padding rows give 0."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _intersection(a: torch.Tensor, b: torch.Tensor):
    """(N, 4) x (M, 4) -> (inter, area_a[:, None], area_b[None, :])."""
    area_a = box_area(a)[:, None]
    area_b = box_area(b)[None, :]
    iy = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp_min(0.0)
    ix = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp_min(0.0)
    return iy * ix, area_a, area_b


def box_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, (N, 4) x (M, 4) -> (N, M); degenerate boxes give 0."""
    inter, area_a, area_b = _intersection(boxes_a, boxes_b)
    union = area_a + area_b - inter
    iou = inter / torch.where(union > 0.0, union, torch.ones_like(union))
    valid = (area_a > 0.0) & (area_b > 0.0)
    return torch.where(valid, iou, torch.zeros_like(iou))


def box_overlap_mask(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                     threshold: float) -> torch.Tensor:
    """Pairwise `IoU > threshold` without the division: (N, 4) x (M, 4) ->
    (N, M) bool. `inter > t * union` for union > 0; degenerate boxes never
    overlap anything. This is the exact comparison of the NMS kernel
    (`csrc/nms.cu::hit`), operation for operation."""
    inter, area_a, area_b = _intersection(boxes_a, boxes_b)
    union = area_a + area_b - inter
    valid = (area_a > 0.0) & (area_b > 0.0)
    return (inter > threshold * union) & valid
