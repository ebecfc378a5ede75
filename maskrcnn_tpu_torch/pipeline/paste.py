"""Full-resolution mask pasting on the device, port of
`maskrcnn_tpu/pipeline/paste.py`: each output pixel maps to a mask
coordinate through its detection's box and is sampled bilinearly, zero
outside the box (the inverse of ROIAlign's sampling), then thresholded.

The sampling runs as two batched float32 matrix products with dense
(S, m) interpolation matrices, Wy @ mask @ Wx^T, as in the JAX package.
"""

from __future__ import annotations

import torch


def _interp_matrix(coords: torch.Tensor, ok: torch.Tensor,
                   m: int) -> torch.Tensor:
    """(..., S) continuous mask coordinates -> (..., S, m) bilinear weights,
    zero where `ok` is 0. Where both corners clamp to the same column the
    two indicator terms land on it and sum to 1."""
    c0 = torch.clamp(torch.floor(coords), 0, m - 1)
    wfrac = torch.clamp(coords - c0, 0.0, 1.0)
    c0 = c0.to(torch.int64)
    c1 = torch.clamp(c0 + 1, max=m - 1)
    j = torch.arange(m, device=coords.device)
    w = ((j == c0[..., None]) * (1 - wfrac)[..., None]
         + (j == c1[..., None]) * wfrac[..., None])
    return w * ok[..., None]


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor,
                valid: torch.Tensor, out_size: int,
                threshold: float = 0.5) -> torch.Tensor:
    """(..., D, m, m) soft masks + (..., D, 4) normalized boxes + (..., D)
    valid -> (..., D, S, S) uint8 {0, 1}.

    Pixel centers sit at (i + 0.5) / S in normalized canvas coordinates; a
    pixel is set when it lies inside its box and the bilinearly sampled
    mask value reaches the threshold."""
    m = masks.shape[-1]
    s = out_size
    masks = masks.to(torch.float32)
    centers = (torch.arange(s, dtype=torch.float32, device=masks.device)
               + 0.5) / s
    y1, x1, y2, x2 = boxes.to(torch.float32).unbind(-1)
    h = torch.clamp(y2 - y1, min=1e-8)
    w = torch.clamp(x2 - x1, min=1e-8)
    # Normalized canvas -> continuous mask coordinates (box edge -> mask
    # edge, pixel centers at half steps, as PIL's resize).
    my = (centers - y1[..., None]) / h[..., None] * m - 0.5     # (..., D, S)
    mx = (centers - x1[..., None]) / w[..., None] * m - 0.5
    in_y = (centers >= y1[..., None]) & (centers <= y2[..., None])
    in_x = (centers >= x1[..., None]) & (centers <= x2[..., None])
    wy = _interp_matrix(my, in_y.to(torch.float32), m)      # (..., D, S, m)
    wx = _interp_matrix(mx, in_x.to(torch.float32), m)
    val = (wy @ masks) @ wx.transpose(-1, -2)               # (..., D, S, S)
    return ((val >= threshold) & valid[..., None, None]).to(torch.uint8)
