"""Region Proposal Network head shared across pyramid levels, port of
`maskrcnn_tpu/models/rpn.py`: 3x3x512 shared conv (`rpn_conv_shared`,
relu), 1x1 class conv (`rpn_class_raw`) and 1x1 box conv (`rpn_bbox_pred`),
the two 1x1s run as one conv over concatenated output channels. A row-major
(H, W, anchor) flatten matches the anchor order of `core/anchors.py`."""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.models import nn


def init_rpn(gen: torch.Generator, in_channels: int = 256,
             anchors_per_location: int = 3,
             shared_channels: int = 512) -> nn.Params:
    return {
        "rpn_conv_shared": nn.conv_init(gen, 3, 3, in_channels,
                                        shared_channels),
        "rpn_class_raw": nn.conv_init(gen, 1, 1, shared_channels,
                                      2 * anchors_per_location),
        "rpn_bbox_pred": nn.conv_init(gen, 1, 1, shared_channels,
                                      4 * anchors_per_location),
    }


def apply_rpn_level(params, feature, dtype=torch.bfloat16):
    """(B, H, W, C) -> logits (B, H*W*apl, 2), deltas (B, H*W*apl, 4) f32."""
    b, h, w, _ = feature.shape
    shared = nn.relu(nn.conv2d(feature, params["rpn_conv_shared"],
                               padding="SAME", dtype=dtype))
    n_cls = params["rpn_class_raw"]["kernel"].shape[-1]
    merged = {
        "kernel": torch.cat([params["rpn_class_raw"]["kernel"],
                             params["rpn_bbox_pred"]["kernel"]], dim=-1),
        "bias": torch.cat([params["rpn_class_raw"]["bias"],
                           params["rpn_bbox_pred"]["bias"]], dim=-1),
    }
    both = nn.conv2d(shared, merged, padding="VALID", dtype=dtype)
    apl = n_cls // 2
    logits = both[..., :n_cls].reshape(b, h * w * apl, 2)
    deltas = both[..., n_cls:].reshape(b, h * w * apl, 4)
    return logits.to(torch.float32), deltas.to(torch.float32)


def apply_rpn(params, pyramid, dtype=torch.bfloat16):
    """All levels -> (B, A, 2) logits, (B, A, 4) deltas, levels outer."""
    outs = [apply_rpn_level(params, f, dtype=dtype) for f in pyramid]
    return (torch.cat([o[0] for o in outs], dim=1),
            torch.cat([o[1] for o in outs], dim=1))
