"""ResNet-50 and ResNet-101 (He et al., arXiv:1512.03385) in Matterport's
Keras layer names, under Matterport's top-down FPN: what `resnet50.py`
and `resnet101.py` share. The depth is the number of identity blocks in
stage 4, `RESNET_STAGES[cfg.architecture]`."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark import roofline
from benchmark.reference import model as R

# Identity blocks in stage 4 by depth.
RESNET_STAGES = {"resnet50": 5, "resnet101": 22}
RESNET_C = (256, 512, 1024, 2048)

# The chains K4 runs: (stride of the map, input channels, (f1, f2, f3),
# blocks, whether the first block has the projection shortcut).
CHAINS = ((4, 64, (64, 64, 256), 3, True), (8, 512, (128, 128, 512), 3,
                                            False))


def resnet_blocks(architecture: str):
    """(stage, letter, is_conv_block, (f1, f2, f3), stride) per block."""
    spec = ((2, (64, 64, 256), 1, 2), (3, (128, 128, 512), 2, 3),
            (4, (256, 256, 1024), 2, RESNET_STAGES[architecture]),
            (5, (512, 512, 2048), 2, 2))
    for stage, filters, stride, n_identity in spec:
        yield stage, "a", True, filters, stride
        for i in range(n_identity):
            yield stage, chr(ord("b") + i), False, filters, 1


def param_shapes(cfg) -> dict[str, dict[str, tuple]]:
    shapes = {"conv1": R.conv_shape(7, 7, 3, 64), "bn_conv1": R.bn_shape(64)}
    cin = 64
    for stage, letter, is_conv, (f1, f2, f3), _ in resnet_blocks(
            cfg.architecture):
        base, bnb = f"res{stage}{letter}_branch", f"bn{stage}{letter}_branch"
        for suffix, (kh, ci, co) in (("2a", (1, cin, f1)),
                                     ("2b", (3, f1, f2)),
                                     ("2c", (1, f2, f3))):
            shapes[base + suffix] = R.conv_shape(kh, kh, ci, co)
            shapes[bnb + suffix] = R.bn_shape(co)
        if is_conv:
            shapes[base + "1"] = R.conv_shape(1, 1, cin, f3)
            shapes[bnb + "1"] = R.bn_shape(f3)
        cin = f3
    shapes.update(R.topdown_fpn_shapes(cfg, RESNET_C))
    return shapes


def pyramid(params, x, cfg, nx):
    x = R.conv(x, params["conv1"], nx, stride=2, padding=3)
    x = torch.relu(R.bn(x, params["bn_conv1"]))
    (t, b), (l, r) = R.same(x.shape[2], 3, 2), R.same(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3, 2)
    feats = {}
    for stage, letter, is_conv, _, stride in resnet_blocks(cfg.architecture):
        base, bnb = f"res{stage}{letter}_branch", f"bn{stage}{letter}_branch"
        y = torch.relu(R.bn(R.conv(x, params[base + "2a"], nx, stride=stride,
                                   padding="VALID"), params[bnb + "2a"]))
        y = torch.relu(R.bn(R.conv(y, params[base + "2b"], nx),
                            params[bnb + "2b"]))
        y = R.bn(R.conv(y, params[base + "2c"], nx, padding="VALID"),
                 params[bnb + "2c"])
        sc = (R.bn(R.conv(x, params[base + "1"], nx, stride=stride,
                          padding="VALID"), params[bnb + "1"])
              if is_conv else x)
        x = torch.relu(y + sc)
        feats[stage] = x
    return R.topdown_fpn(params, [feats[s] for s in (2, 3, 4, 5)], nx)


def macs(cfg) -> dict[str, float]:
    h, w = cfg.image_height, cfg.image_width
    ceil = roofline.ceil_div
    total = ceil(h, 2) * ceil(w, 2) * 7 * 7 * 3 * 64
    cin = 64
    spec = ((4, (64, 64, 256), 2), (8, (128, 128, 512), 3),
            (16, (256, 256, 1024), RESNET_STAGES[cfg.architecture]),
            (32, (512, 512, 2048), 2))
    for stride, (f1, f2, f3), n_identity in spec:
        hw = ceil(h, stride) * ceil(w, stride)
        for block in range(n_identity + 1):
            per = cin * f1 + 9 * f1 * f2 + f2 * f3
            if block == 0:
                per += cin * f3
            total += hw * per
            cin = f3
    return {"backbone": float(total),
            "fpn": roofline.topdown_fpn_macs(cfg, RESNET_C)}


def init_std(layer: str, shape) -> float | None:
    """The first convolution He-normal scaled by 1/128: the inputs are
    mean-subtracted, not normalized."""
    if layer == "conv1":
        return math.sqrt(2.0 / math.prod(shape[:-1])) / 128.0
    return None


def kernel_work(cfg, b: int) -> dict[str, list]:
    """K3 (the stem) and K4 (the two chains of `CHAINS`) once a forward."""
    return {"stem": [roofline.stem_call(b, cfg)],
            "bottleneck": [roofline.chain_call(b, cfg, c) for c in CHAINS]}
