"""Feature Pyramid Network (Matterport topology and layer names), port of
`maskrcnn_tpu/models/fpn.py`: lateral 1x1 convs `fpn_c{2..5}p{2..5}`,
nearest 2x top-down merges, 3x3 output convs `fpn_p{2..5}`, P6 = stride-2
subsample of P5."""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.models import nn


def init_fpn(gen: torch.Generator, channels: int = 256,
             c_channels=(256, 512, 1024, 2048)) -> nn.Params:
    params: nn.Params = {}
    for lvl, cin in zip((2, 3, 4, 5), c_channels):
        params[f"fpn_c{lvl}p{lvl}"] = nn.conv_init(gen, 1, 1, cin, channels)
        params[f"fpn_p{lvl}"] = nn.conv_init(gen, 3, 3, channels, channels)
    return params


def apply_fpn(params, c2, c3, c4, c5, dtype=torch.bfloat16):
    """C2..C5 -> (P2, P3, P4, P5, P6), each (B, H_l, W_l, channels)."""
    p5 = nn.conv2d(c5, params["fpn_c5p5"], padding="VALID", dtype=dtype)
    p4 = nn.upsample2x_nearest(p5) + nn.conv2d(
        c4, params["fpn_c4p4"], padding="VALID", dtype=dtype)
    p3 = nn.upsample2x_nearest(p4) + nn.conv2d(
        c3, params["fpn_c3p3"], padding="VALID", dtype=dtype)
    p2 = nn.upsample2x_nearest(p3) + nn.conv2d(
        c2, params["fpn_c2p2"], padding="VALID", dtype=dtype)
    p2 = nn.conv2d(p2, params["fpn_p2"], padding="SAME", dtype=dtype)
    p3 = nn.conv2d(p3, params["fpn_p3"], padding="SAME", dtype=dtype)
    p4 = nn.conv2d(p4, params["fpn_p4"], padding="SAME", dtype=dtype)
    p5 = nn.conv2d(p5, params["fpn_p5"], padding="SAME", dtype=dtype)
    p6 = p5[:, ::2, ::2, :]
    return p2, p3, p4, p5, p6
