"""Pyramid anchor generation (Matterport convention), port of
`maskrcnn_tpu/core/anchors.py`.

Ordering contract (must match the RPN output layout): levels P2..P6 outer,
then row-major over (y, x) feature positions, then the aspect ratios.
`generate_anchors`, `anchor_spec` and the `anchors.bin` reader and writer
are numpy, as in the JAX package;
`anchors_at` computes the anchors of given flat indices in torch.
"""

from __future__ import annotations

import numpy as np
import torch

from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
from maskrcnn_tpu_torch.ops.common import device_constant


def generate_level_anchors(scale: float, ratios: np.ndarray,
                           feature_shape: tuple[int, int],
                           feature_stride: int,
                           anchor_stride: int = 1) -> np.ndarray:
    """Anchors for one pyramid level, in image pixels, (y1,x1,y2,x2).
    Ratio varies fastest."""
    ratios = np.asarray(ratios, dtype=np.float64)
    heights = scale / np.sqrt(ratios)
    widths = scale * np.sqrt(ratios)
    shifts_y = np.arange(0, feature_shape[0], anchor_stride) * feature_stride
    shifts_x = np.arange(0, feature_shape[1], anchor_stride) * feature_stride
    ctr_x, ctr_y = np.meshgrid(shifts_x, shifts_y)
    cy = np.repeat(ctr_y.reshape(-1, 1), len(ratios), axis=1)
    cx = np.repeat(ctr_x.reshape(-1, 1), len(ratios), axis=1)
    hh = np.broadcast_to(heights, cy.shape)
    ww = np.broadcast_to(widths, cx.shape)
    boxes = np.stack(
        [cy - 0.5 * hh, cx - 0.5 * ww, cy + 0.5 * hh, cx + 0.5 * ww],
        axis=-1)
    return boxes.reshape(-1, 4)


def norm_boxes(boxes: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Pixel (y1,x1,y2,x2) -> normalized: (box - [0,0,1,1]) / [H-1,W-1]*2."""
    h, w = shape
    scale = np.array([h - 1, w - 1, h - 1, w - 1], dtype=np.float64)
    shift = np.array([0.0, 0.0, 1.0, 1.0], dtype=np.float64)
    return (boxes - shift) / scale


def denorm_boxes(boxes: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Inverse of `norm_boxes` (back to pixel coordinates)."""
    h, w = shape
    scale = np.array([h - 1, w - 1, h - 1, w - 1], dtype=np.float64)
    shift = np.array([0.0, 0.0, 1.0, 1.0], dtype=np.float64)
    return boxes * scale + shift


def generate_anchors(config: MaskRCNNConfig) -> np.ndarray:
    """Normalized float32 anchors (N, 4) over all levels."""
    ratios = np.asarray(config.anchor_ratios, dtype=np.float64)
    pix = np.concatenate([
        generate_level_anchors(scale, ratios, fshape, stride,
                               config.anchor_stride)
        for scale, fshape, stride in zip(
            config.anchor_scales, config.feature_shapes,
            config.backbone_strides)], axis=0)
    return norm_boxes(
        pix, (config.image_height, config.image_width)).astype(np.float32)


def save_anchors_bin(anchors: np.ndarray, path: str) -> None:
    """Raw little-endian float32 dump (`anchors.bin`, the JAX package's and
    the reference's artifact format)."""
    np.ascontiguousarray(anchors, dtype="<f4").tofile(path)


def load_anchors_bin(path: str, expect_count: int | None = None
                     ) -> np.ndarray:
    data = np.fromfile(path, dtype="<f4")
    if data.size % 4:
        raise ValueError(f"{path}: size {data.size} not divisible by 4")
    anchors = data.reshape(-1, 4)
    if expect_count is not None and anchors.shape[0] != expect_count:
        raise ValueError(
            f"{path}: expected {expect_count} anchors, found "
            f"{anchors.shape[0]}")
    return anchors


def anchor_spec(config: MaskRCNNConfig):
    """Per-level spec for `anchors_at`: ((flat offset, grid_h, grid_w,
    center step in pixels, per-ratio (height, width) pairs rounded to
    float32), ...), number of ratios, (image_h, image_w)."""
    ratios = np.asarray(config.anchor_ratios, dtype=np.float64)
    levels = []
    off = 0
    for scale, (fh, fw), stride in zip(
            config.anchor_scales, config.feature_shapes,
            config.backbone_strides):
        gh = len(range(0, fh, config.anchor_stride))
        gw = len(range(0, fw, config.anchor_stride))
        hw = tuple(
            (float(np.float32(scale / np.sqrt(r))),
             float(np.float32(scale * np.sqrt(r)))) for r in ratios)
        levels.append((off, gh, gw, config.anchor_stride * stride, hw))
        off += gh * gw * len(ratios)
    return (tuple(levels), len(ratios),
            (config.image_height, config.image_width))


def anchors_at(idx: torch.Tensor, spec) -> torch.Tensor:
    """Normalized (y1,x1,y2,x2) float32 anchors for flat indices of any
    shape: (...,) int -> (..., 4). The anchor at a flat index is a closed
    form of (level, cell, ratio); matches `generate_anchors` to float32
    rounding (<= 2 ulp; the table rounds once from float64)."""
    levels, n_ratios, (img_h, img_w) = spec
    idx = idx.to(torch.int64)
    dev = idx.device

    def table(vals, dtype):
        return device_constant(tuple(vals), dtype, dev)

    starts = table((lv[0] for lv in levels), torch.int64)
    level = (idx[..., None] >= starts[1:]).sum(-1)
    j = idx - starts[level]
    r = j % n_ratios
    cell = j // n_ratios
    gw = table((lv[2] for lv in levels), torch.int64)[level]
    step = table((float(lv[3]) for lv in levels), torch.float32)[level]
    cy = (cell // gw).to(torch.float32) * step
    cx = (cell % gw).to(torch.float32) * step
    hw = table((tuple(map(tuple, lv[4])) for lv in levels), torch.float32)
    hh = hw[level, r, 0]
    ww = hw[level, r, 1]
    sy = float(img_h - 1)
    sx = float(img_w - 1)
    return torch.stack([
        (cy - 0.5 * hh) / sy,
        (cx - 0.5 * ww) / sx,
        (cy + 0.5 * hh - 1.0) / sy,
        (cx + 0.5 * ww - 1.0) / sx,
    ], dim=-1)
