"""Pyramid ROIAlign, port of `maskrcnn_tpu/ops/roi_align.py` with the
semantics of `pyramid_roi_align_flat` (and of the TPU kernel's plain mode).

Sampling follows `tf.image.crop_and_resize` (bilinear, samples outside the
level give 0); each ROI pools from one FPN level,

    level = floor(log2(sqrt(w*h) / (224/sqrt(image_area))) + 4 + 0.5),

clamped to [2, 5], with zero-area ROIs treated as padding (zero output).

The level and the sample positions are computed here once, in torch, for
the kernels (K2, and K5/K6 with a head fused behind the pool,
`roi_align_cuda`) and their plain versions: they then agree on every level
choice, whatever the device's `log2`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from maskrcnn_tpu_torch.ops.roi_align_cuda import (RoiAlignDiff, roi_align,
                                                   roi_classifier_head,
                                                   roi_mask_head)


def roi_levels(rois: torch.Tensor, image_shape: tuple[int, int],
               canonical_scale: float = 224.0, min_level: int = 2,
               max_level: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 4) normalized ROIs -> (level index relative to P_min_level,
    valid); valid is False for degenerate (<= 0 area) ROIs."""
    h = rois[..., 2] - rois[..., 0]
    w = rois[..., 3] - rois[..., 1]
    area = w * h
    image_area = float(image_shape[0]) * float(image_shape[1])
    ratio = canonical_scale / torch.sqrt(
        torch.tensor(image_area, dtype=torch.float32, device=rois.device))
    lvl = (0.5 * torch.log2(area.clamp_min(1e-30)) - torch.log2(ratio)
           + 4.0)
    # Round half away from zero (the reference's Swift round()); lvl > 0.
    lvl = torch.floor(lvl + 0.5).clamp(min_level, max_level).to(torch.int32)
    valid = area > 0.0
    return torch.where(valid, lvl - min_level, torch.zeros_like(lvl)), valid


def _crop_grid(coord_lo: torch.Tensor, coord_hi: torch.Tensor,
               size_minus_1: torch.Tensor, crop: int) -> torch.Tensor:
    """(M,) edge pair + (M,) level extent minus one -> (M, crop) float32
    crop_and_resize sample positions along one axis."""
    dev = coord_lo.device
    steps = torch.arange(crop, dtype=torch.float32, device=dev)
    if crop > 1:
        # float32 arithmetic of the JAX package's compiled program: the
        # division by (crop - 1) as a multiply by its float32 reciprocal,
        # and `lo * s + step * span` as one fused multiply-add (exact
        # product and sum in float64, one rounding). A sample that lands
        # exactly on the last cell of the level is in range; one ulp past
        # it reads 0, so the edge samples must be computed the same way.
        recip = torch.ones((), dtype=torch.float32, device=dev) / (crop - 1)
        span = ((coord_hi - coord_lo) * size_minus_1) * recip
        base = coord_lo * size_minus_1
        return (steps[None, :].double() * span[:, None].double()
                + base[:, None].double()).to(torch.float32)
    return 0.5 * (coord_lo + coord_hi)[:, None] * size_minus_1[:, None]


def prepare(rois: torch.Tensor, level_hw: Sequence[tuple[int, int]],
            image_shape: tuple[int, int], canonical_scale: float,
            crop: int):
    """(M, 4) ROIs -> (ys (M, crop), xs (M, crop), level (M,) int32,
    valid (M,) bool): everything the kernel takes besides the features."""
    rois = rois.to(torch.float32)
    level, valid = roi_levels(rois, image_shape, canonical_scale,
                              min_level=2, max_level=2 + len(level_hw) - 1)
    dev = rois.device
    heights = torch.tensor([float(h) for h, _ in level_hw], device=dev)
    widths = torch.tensor([float(w) for _, w in level_hw], device=dev)
    li = level.to(torch.int64)
    fh, fw = heights[li], widths[li]
    ys = _crop_grid(rois[:, 0], rois[:, 2], fh - 1.0, crop)
    xs = _crop_grid(rois[:, 1], rois[:, 3], fw - 1.0, crop)
    return ys.contiguous(), xs.contiguous(), level.contiguous(), valid


def pyramid_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                      crop_size: int, image_shape: tuple[int, int],
                      canonical_scale: float = 224.0, head_params=None,
                      mask_params=None, class_ids=None) -> torch.Tensor:
    """P2..P5 as (B, H_l, W_l, C) + (B, N, 4) normalized ROIs ->
    (B, N, crop, crop, C) pooled features in the features' dtype; zero
    rows of `rois` give zero output.

    With `head_params` (`roi_align_cuda.pack_classifier_head`) the pool
    feeds the classifier head (K5) and the result is its (B*N, HEAD_OUT)
    float32 rows (`unpack_classifier_head`); with `mask_params`
    (`pack_mask_head`) and (B, N) `class_ids` it feeds the mask head (K6)
    and the result is the (B*N, 2*crop, 2*crop) float32 masks. Unlike the
    TPU kernel, the fused calls return only the head's output: the pooled
    features are never written. Where a feature requires grad (training),
    the pool runs through `RoiAlignDiff`: the kernel forward, the plain
    version's gradient."""
    b, n, _ = rois.shape
    level_hw = [(f.shape[1], f.shape[2]) for f in features]
    ys, xs, level, valid = prepare(rois.reshape(b * n, 4), level_hw,
                                   image_shape, canonical_scale, crop_size)
    features = list(features)
    if head_params is not None:
        return roi_classifier_head(features, ys, xs, level, valid, n,
                                   head_params)
    if mask_params is not None:
        if class_ids is None:
            raise ValueError("mask_params needs class_ids")
        return roi_mask_head(features, ys, xs, level, valid, n, mask_params,
                             class_ids.reshape(b * n))
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        out = RoiAlignDiff.apply(ys, xs, level, valid, n, *features)
    else:
        out = roi_align(features, ys, xs, level, valid, n)
    return out.reshape(b, n, crop_size, crop_size, out.shape[-1])
