"""Pyramid ROIAlign gather-and-blend: the CUDA kernel K2 (`csrc/roi_align.cu`)
and its plain PyTorch version. Replaces the plain mode of
`maskrcnn_tpu/ops/roi_align_pallas.py::pyramid_roi_align_pallas`.

Contract (both versions): P2..P5 levels (B, H_l, W_l, C), per-ROI sample
positions ys/xs (M, P) on the ROI's level (from `roi_align.prepare`), the
level (M,) int32 and valid (M,) flags, M = B * rois_per_image ->
(M, P, P, C) in the features' dtype. Corners are clamped to the level,
blended in float32 (x first, then y), samples out of range and invalid ROIs
give 0.
"""

from __future__ import annotations

from typing import Sequence

import torch

from maskrcnn_tpu_torch.ops import cuda_lib


def roi_align_plain(features: Sequence[torch.Tensor], ys: torch.Tensor,
                    xs: torch.Tensor, level: torch.Tensor,
                    valid: torch.Tensor, rois_per_image: int) -> torch.Tensor:
    m, p = ys.shape
    c = features[0].shape[-1]
    out = torch.zeros((m, p, p, c), dtype=torch.float32, device=ys.device)
    img = torch.arange(m, device=ys.device) // rois_per_image
    for li, f in enumerate(features):
        sel = torch.nonzero((level == li) & valid).flatten()
        if sel.numel() == 0:
            continue
        fh, fw = f.shape[1], f.shape[2]
        y, x = ys[sel], xs[sel]
        y_in = (y >= 0.0) & (y <= fh - 1.0)
        x_in = (x >= 0.0) & (x <= fw - 1.0)
        y0, x0 = torch.floor(y), torch.floor(x)
        wy, wx = y - y0, x - x0
        y0i = y0.clamp(0, fh - 1).to(torch.int64)
        x0i = x0.clamp(0, fw - 1).to(torch.int64)
        y1i = (y0i + 1).clamp(max=fh - 1)
        x1i = (x0i + 1).clamp(max=fw - 1)
        # At the right edge both x corners are the same cell; its weight
        # is exactly zero there (clipped sampling has floor(x) == x).
        wx = torch.where(x1i > x0i, wx, torch.zeros_like(wx))
        bi = img[sel][:, None, None]

        def corner(yi, xi):
            return f[bi, yi[:, :, None], xi[:, None, :]].to(torch.float32)

        wxe = wx[:, None, :, None]
        wye = wy[:, :, None, None]
        top = corner(y0i, x0i) * (1.0 - wxe) + corner(y0i, x1i) * wxe
        bot = corner(y1i, x0i) * (1.0 - wxe) + corner(y1i, x1i) * wxe
        o = top * (1.0 - wye) + bot * wye
        inside = (y_in[:, :, None] & x_in[:, None, :])[..., None]
        out[sel] = torch.where(inside, o, torch.zeros_like(o))
    return out.to(features[0].dtype)


def roi_align_cuda(features: Sequence[torch.Tensor], ys: torch.Tensor,
                   xs: torch.Tensor, level: torch.Tensor,
                   valid: torch.Tensor, rois_per_image: int) -> torch.Tensor:
    if len(features) != 4:
        raise ValueError(f"roi_align kernel takes 4 levels, got "
                         f"{len(features)}")
    m, p = ys.shape
    bsz, _, _, c = features[0].shape
    dtype = features[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"roi_align kernel takes bf16 or f32, got {dtype}")
    if c % 2:
        raise ValueError(f"roi_align kernel needs an even channel count, "
                         f"got {c}")
    if m != bsz * rois_per_image:
        raise ValueError(f"{m} ROIs for {bsz} images x {rois_per_image}")
    for i, f in enumerate(features):
        cuda_lib.require(f, f"features[{i}]", dtype,
                         (bsz, f.shape[1], f.shape[2], c))
    cuda_lib.require(ys, "ys", torch.float32, (m, p))
    cuda_lib.require(xs, "xs", torch.float32, (m, p))
    cuda_lib.require(level, "level", torch.int32, (m,))
    cuda_lib.require(valid, "valid", torch.bool, (m,))
    lib = cuda_lib.load()
    out = torch.empty((m, p, p, c), dtype=dtype, device=ys.device)
    dims = [d for f in features for d in (f.shape[1], f.shape[2])]
    with torch.cuda.device(ys.device):
        rc = lib.mrt_roi_align(
            *[f.data_ptr() for f in features], *dims, c,
            ys.data_ptr(), xs.data_ptr(), level.data_ptr(),
            valid.data_ptr(), m, rois_per_image, p,
            1 if dtype == torch.bfloat16 else 0, out.data_ptr(),
            cuda_lib.stream_ptr(ys))
    cuda_lib.check(rc, "roi_align")
    cuda_lib.launches["roi_align"] += 1
    return out


def roi_align(features: Sequence[torch.Tensor], ys: torch.Tensor,
              xs: torch.Tensor, level: torch.Tensor, valid: torch.Tensor,
              rois_per_image: int) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if ys.is_cuda:
        return roi_align_cuda([f.contiguous() for f in features], ys, xs,
                              level, valid, rois_per_image)
    return roi_align_plain(features, ys, xs, level, valid, rois_per_image)
