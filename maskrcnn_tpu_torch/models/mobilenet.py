"""MobileNetV2 backbone (width 1.0) emitting C2..C5 for the FPN, port of
`maskrcnn_tpu/models/mobilenet.py`: stem conv 3x3/2, then inverted-residual
groups (expansion t, channels c, repeats n, first stride s), each block a
1x1 expand (none when t == 1), BN, relu6, a 3x3 depthwise conv, BN, relu6,
a 1x1 project and BN, plus the input where the stride is 1 and the width
stays.

    (1,16,1,1) (6,24,2,2) (6,32,3,2) (6,64,4,2) (6,96,3,1)
    (6,160,3,2) (6,320,1,1)

Taps: C2 = end of the 24-channel group (stride 4), C3 = 32 (stride 8),
C4 = 96 (stride 16), C5 = 320 (stride 32). Parameters take the JAX
package's names (`mbv2_...`: there is no Matterport weight contract for
this backbone). Every conv is the framework's (cuDNN on the card): the
JAX package ran this backbone through XLA, with no Pallas kernel, so K3
and K4 (ResNet-only) never run here.
"""

from __future__ import annotations

import math

import torch

from maskrcnn_tpu_torch.models import nn

_GROUPS = [
    # (expansion, channels, repeats, first_stride)
    (1, 16, 1, 1),
    (6, 24, 2, 2),   # -> C2 tap (stride 4)
    (6, 32, 3, 2),   # -> C3 tap (stride 8)
    (6, 64, 4, 2),
    (6, 96, 3, 1),   # -> C4 tap (stride 16)
    (6, 160, 3, 2),
    (6, 320, 1, 1),  # -> C5 tap (stride 32)
]
_TAPS = {1: "c2", 2: "c3", 4: "c4", 6: "c5"}
C_CHANNELS = (24, 32, 96, 320)  # FPN lateral input widths


def _dw_init(gen: torch.Generator, k: int, c: int) -> nn.Params:
    """Depthwise kernel (k, k, 1, c), He-normal over its k*k fan-in."""
    return {"kernel": torch.randn((k, k, 1, c), generator=gen)
            * math.sqrt(2.0 / (k * k)),
            "bias": torch.zeros((c,), dtype=torch.float32)}


def init_mobilenetv2(gen: torch.Generator) -> nn.Params:
    """Random init with the JAX package's names and shapes; the stem
    kernel scaled by 1/128 (the inputs are mean-subtracted, not
    std-normalized)."""
    params: nn.Params = {}
    params["mbv2_stem"] = nn.conv_init(gen, 3, 3, 3, 32)
    params["mbv2_stem"]["kernel"] = params["mbv2_stem"]["kernel"] / 128.0
    params["mbv2_stem_bn"] = nn.bn_init(32)
    cin = 32
    for gi, (t, c, n, _) in enumerate(_GROUPS):
        for bi in range(n):
            base = f"mbv2_g{gi}b{bi}"
            hidden = cin * t
            if t != 1:
                params[base + "_expand"] = nn.conv_init(gen, 1, 1, cin,
                                                        hidden)
                params[base + "_expand_bn"] = nn.bn_init(hidden)
            params[base + "_dw"] = _dw_init(gen, 3, hidden)
            params[base + "_dw_bn"] = nn.bn_init(hidden)
            params[base + "_project"] = nn.conv_init(gen, 1, 1, hidden, c)
            params[base + "_project_bn"] = nn.bn_init(c)
            cin = c
    return params


def _block(x, params, base, t, cout, stride, dtype, bn_ctx):
    cin = x.shape[-1]
    y = x
    if t != 1:
        y = nn.conv2d(y, params[base + "_expand"], padding="VALID",
                      dtype=dtype)
        y = nn.relu6(nn.bn_apply(y, params, base + "_expand_bn", bn_ctx))
    y = nn.depthwise_conv(y, params[base + "_dw"], stride=stride, dtype=dtype)
    y = nn.relu6(nn.bn_apply(y, params, base + "_dw_bn", bn_ctx))
    y = nn.conv2d(y, params[base + "_project"], padding="VALID", dtype=dtype)
    y = nn.bn_apply(y, params, base + "_project_bn", bn_ctx)
    if stride == 1 and cin == cout:
        y = y + x
    return y


def apply_mobilenetv2(params, images: torch.Tensor, dtype=torch.bfloat16,
                      bn_ctx=None):
    """(B, H, W, 3) preprocessed images -> (C2, C3, C4, C5), NHWC. `bn_ctx`
    as in `nn.bn_apply` (None: the stored statistics)."""
    x = nn.conv2d(images.to(dtype), params["mbv2_stem"], stride=2,
                  padding="SAME", dtype=dtype)
    x = nn.relu6(nn.bn_apply(x, params, "mbv2_stem_bn", bn_ctx))
    taps = {}
    for gi, (t, c, n, s) in enumerate(_GROUPS):
        for bi in range(n):
            x = _block(x, params, f"mbv2_g{gi}b{bi}", t, c,
                       s if bi == 0 else 1, dtype, bn_ctx)
        if gi in _TAPS:
            taps[_TAPS[gi]] = x
    return taps["c2"], taps["c3"], taps["c4"], taps["c5"]
