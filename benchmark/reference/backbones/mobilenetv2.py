"""MobileNetV2 width 1.0 (Sandler et al., arXiv:1801.04381) under
Matterport's top-down FPN, layers named `mbv2_*`. It runs no port kernel,
so it gives no `kernel_work`."""

from __future__ import annotations

import math

from benchmark import roofline
from benchmark.reference import model as R

# Table 2: (expansion, channels, repeats, first stride); C2..C5 taps after
# groups 1, 2, 4, 6.
MBV2_GROUPS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
MBV2_TAPS = (1, 2, 4, 6)
MBV2_C = (24, 32, 96, 320)


def param_shapes(cfg) -> dict[str, dict[str, tuple]]:
    shapes = {"mbv2_stem": R.conv_shape(3, 3, 3, 32),
              "mbv2_stem_bn": R.bn_shape(32)}
    cin = 32
    for gi, (t, c, n, _) in enumerate(MBV2_GROUPS):
        for bi in range(n):
            base, hidden = f"mbv2_g{gi}b{bi}", cin * t
            if t != 1:
                shapes[base + "_expand"] = R.conv_shape(1, 1, cin, hidden)
                shapes[base + "_expand_bn"] = R.bn_shape(hidden)
            shapes[base + "_dw"] = R.conv_shape(3, 3, 1, hidden)
            shapes[base + "_dw_bn"] = R.bn_shape(hidden)
            shapes[base + "_project"] = R.conv_shape(1, 1, hidden, c)
            shapes[base + "_project_bn"] = R.bn_shape(c)
            cin = c
    shapes.update(R.topdown_fpn_shapes(cfg, MBV2_C))
    return shapes


def pyramid(params, x, cfg, nx):
    relu6 = lambda t: t.clamp(0.0, 6.0)
    x = relu6(R.bn(R.conv(x, params["mbv2_stem"], nx, stride=2),
                   params["mbv2_stem_bn"]))
    taps = []
    for gi, (t, c, n, s) in enumerate(MBV2_GROUPS):
        for bi in range(n):
            base, stride, cin = f"mbv2_g{gi}b{bi}", (s if bi == 0 else 1), \
                x.shape[1]
            y = x
            if t != 1:
                y = relu6(R.bn(R.conv(y, params[base + "_expand"], nx,
                                      padding="VALID"),
                               params[base + "_expand_bn"]))
            y = relu6(R.bn(R.conv(y, params[base + "_dw"], nx, stride=stride,
                                  groups=y.shape[1]),
                           params[base + "_dw_bn"]))
            y = R.bn(R.conv(y, params[base + "_project"], nx,
                            padding="VALID"), params[base + "_project_bn"])
            x = y + x if stride == 1 and cin == c else y
        if gi in MBV2_TAPS:
            taps.append(x)
    return R.topdown_fpn(params, taps, nx)


def macs(cfg) -> dict[str, float]:
    ceil = roofline.ceil_div
    sh, sw = ceil(cfg.image_height, 2), ceil(cfg.image_width, 2)
    total = sh * sw * 9 * 3 * 32
    cin = 32
    for t, c, n, s in MBV2_GROUPS:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            if t != 1:
                total += sh * sw * cin * hidden
            sh, sw = ceil(sh, stride), ceil(sw, stride)
            total += sh * sw * (9 * hidden + hidden * c)
            cin = c
    return {"backbone": float(total),
            "fpn": roofline.topdown_fpn_macs(cfg, MBV2_C)}


def init_std(layer: str, shape) -> float | None:
    """The stem He-normal scaled by 1/128: the inputs are mean-subtracted,
    not normalized."""
    if layer == "mbv2_stem":
        return math.sqrt(2.0 / math.prod(shape[:-1])) / 128.0
    return None
