"""RPN proposal generation: top-k -> decode -> clip -> NMS, port of
`maskrcnn_tpu/ops/proposals.py`, batched over images.

Top-k is exact: a stable descending sort, so equal scores rank in index
order, as `lax.top_k` ranks them (the JAX package's `approx_max_k` is exact
off the TPU). Letterbox padding gives runs of exactly equal RPN scores, so
the order among ties decides which anchors survive the cut.
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.core.anchors import anchors_at
from maskrcnn_tpu_torch.ops.boxes import apply_box_deltas, clip_boxes
from maskrcnn_tpu_torch.ops.common import device_constant
from maskrcnn_tpu_torch.ops.nms import nms_gather, nms_padded


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties to the lower
    index (`lax.top_k` order)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def generate_proposals(fg_scores: torch.Tensor, deltas: torch.Tensor,
                       anchors: torch.Tensor | None, *,
                       bbox_std_dev=(0.1, 0.1, 0.2, 0.2),
                       pre_nms_max_proposals: int = 6000,
                       max_proposals: int = 1000,
                       nms_threshold: float = 0.7, anchor_spec=None):
    """(B, A) fg scores + (B, A, 4) deltas + (A, 4) anchors -> rois
    (B, max_proposals, 4) zero-padded, valid (B, max_proposals) bool.

    With `anchor_spec` the selected anchors are computed from the top-k
    indices (`anchors_at`) and `anchors` may be None."""
    a = fg_scores.shape[-1]
    k = min(a, pre_nms_max_proposals)
    top_idx = top_k_indices(fg_scores.to(torch.float32), k)      # (B, k)
    sel_deltas = torch.take_along_dim(
        deltas.to(torch.float32), top_idx[..., None], dim=1)
    if anchor_spec is not None:
        sel_anchors = anchors_at(top_idx, anchor_spec)
    else:
        sel_anchors = anchors.to(torch.float32)[top_idx]
    std = device_constant(tuple(map(float, bbox_std_dev)), torch.float32,
                          fg_scores.device)
    boxes = clip_boxes(apply_box_deltas(sel_anchors, sel_deltas * std))
    idx, valid = nms_padded(boxes, torch.ones_like(top_idx, dtype=torch.bool),
                            nms_threshold, max_proposals)
    return nms_gather(boxes, idx), valid
