"""Padded greedy non-max suppression, port of `maskrcnn_tpu/ops/nms.py`.

Result is exactly the sequential greedy selection on score-sorted boxes:

  select box i  iff  valid(i) and no selected j < i has IoU(j, i) > threshold

with zero-area boxes never selected and never suppressing, and selection
stopping after `max_out` boxes. Keep flags come from `nms_cuda.nms_keep`
(kernel K1 on a CUDA tensor, its plain tile walk on a CPU tensor).
Functions take one image (N, 4) or a batch (B, N, 4).
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.ops.boxes import box_area
from maskrcnn_tpu_torch.ops.nms_cuda import nms_keep


def nms_padded(boxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, max_out: int):
    """Greedy NMS over score-sorted boxes.

    Returns:
      indices: (..., max_out) int64 indices of kept rows in selection order;
        slots past the kept count hold N (an out-of-range sentinel).
      valid_out: (..., max_out) bool.
    """
    single = boxes.dim() == 2
    if single:
        boxes, valid = boxes[None], valid[None]
    n = boxes.shape[1]
    boxes = boxes.to(torch.float32)
    cand = valid.to(torch.bool) & (box_area(boxes) > 0.0)
    keep = nms_keep(boxes, cand, iou_threshold, max_out)
    indices, valid_out = _compact(keep, n, max_out)
    if single:
        return indices[0], valid_out[0]
    return indices, valid_out


def _compact(keep: torch.Tensor, n: int, max_out: int):
    """First max_out kept indices in selection order + validity mask."""
    b = keep.shape[0]
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    slot = torch.where(keep & (rank < max_out), rank,
                       torch.full_like(rank, max_out))
    indices = torch.full((b, max_out + 1), n, dtype=torch.int64,
                         device=keep.device)
    src = torch.arange(n, device=keep.device).expand(b, n)
    indices = indices.scatter(1, slot, src)[:, :max_out]
    # The scatter's sink slot max_out takes any of the dropped indices; the
    # kept slots are written once each.
    return indices, indices < n


def nms_gather(boxes: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather (..., N, 4) rows by NMS output indices; sentinel rows (== N)
    become zeros."""
    pad = torch.zeros_like(boxes[..., :1, :])
    table = torch.cat([boxes, pad], dim=-2)
    idx = indices.clamp(max=boxes.shape[-2])
    return torch.take_along_dim(table, idx[..., None], dim=-2)
