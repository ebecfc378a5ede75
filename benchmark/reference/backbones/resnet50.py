"""ResNet-50-FPN: the shared ResNet of `_resnet.py` at this depth."""

from benchmark.reference.backbones._resnet import (  # noqa: F401
    init_std, kernel_work, macs, param_shapes, pyramid)
