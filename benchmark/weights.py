"""Random weights from the seed, made on the device in a few large calls.

The layout is the reference's (`reference/model.py::param_shapes`); the
program and the reference get the same float32 tensors. Kernels are
He-normal over their fan-in (the heads' dense layers Glorot-normal), but
where the backbone's file (`reference/backbones/`) gives its own scale,
as it does for its first convolution; biases small and uniform; every
BatchNorm's gamma, beta and moving statistics drawn so that the residual
branches stay alive, as `chip_smoke.py::live_bn` draws them; any other
weight of a backbone in the range its file gives.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import backbones
from benchmark.reference.model import param_shapes

BN_RANGES = {"gamma": (0.3, 0.8), "beta": (-0.2, 0.2),
             "moving_mean": (-0.2, 0.2), "moving_variance": (0.5, 2.0)}
BIAS_RANGE = 0.05
DENSE = ("mrcnn_class_logits", "mrcnn_bbox_fc")


def _std(arch, layer: str, shape) -> float:
    fan_in = math.prod(shape[:-1])
    if layer in DENSE:
        return math.sqrt(2.0 / (fan_in + shape[-1]))
    own = arch.init_std(layer, shape)
    return math.sqrt(2.0 / fan_in) if own is None else own


def _range(arch, layer: str, name: str, shape) -> tuple[float, float]:
    init_range = getattr(arch, "init_range", None)
    own = init_range(layer, name, shape) if init_range else None
    return own or BN_RANGES.get(name, (-BIAS_RANGE, BIAS_RANGE))


def make_params(cfg, seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """{layer: {weight: float32 tensor}} on `device`, from `seed` alone."""
    arch = backbones.load(cfg.architecture)
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal, uniform = [], []
    for layer, weights in shapes.items():
        for name, shape in weights.items():
            (normal if name == "kernel" else uniform).append(
                (layer, name, shape))
    n_total = sum(math.prod(s) for _, _, s in normal)
    u_total = sum(math.prod(s) for _, _, s in uniform)
    flat_n = torch.randn(n_total, generator=gen, device=device)
    flat_u = torch.rand(u_total, generator=gen, device=device)
    params: dict[str, dict[str, torch.Tensor]] = {k: {} for k in shapes}
    pos = 0
    for layer, name, shape in normal:
        n = math.prod(shape)
        params[layer][name] = flat_n[pos:pos + n].view(shape).mul_(
            _std(arch, layer, shape))
        pos += n
    pos = 0
    for layer, name, shape in uniform:
        n = math.prod(shape)
        lo, hi = _range(arch, layer, name, shape)
        params[layer][name] = flat_u[pos:pos + n].view(shape).mul_(
            hi - lo).add_(lo)
        pos += n
    return params
