"""Functional layer kit (conv / BN / dense / pooling) on torch tensors, port
of `maskrcnn_tpu/models/nn.py`.

Parameters are plain nested dicts keyed by the Matterport Keras layer names
(`params["res2a_branch2a"]["kernel"]`), kernels HWIO, activations NHWC, as
in the JAX package. A convolution runs as `F.conv2d` on the NCHW view of the
NHWC tensor (`x.permute(0, 3, 1, 2)`, no copy) and hands back the NHWC view
of its result.

Mixed precision as in the JAX package: parameters float32, convolutions and
matmuls in the compute dtype with the output rounded to it, then the bias
added in that dtype; BatchNorm (eps 1e-3) in float32, with the moving
statistics or, in training, the batch's own (with a process group,
those of the global batch over its ranks).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

Params = dict[str, Any]
BN_EPS = 1e-3  # Keras BatchNormalization's default


# ----------------------------------------------------------------------------
# Initializers (random init; pretrained weights overwrite these).
# ----------------------------------------------------------------------------

def _he_normal(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in = int(np.prod(shape[:-1]))
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * math.sqrt(2.0 / fan_in))


def _glorot_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in = int(np.prod(shape[:-1]))
    fan_out = int(shape[-1])
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen, dtype=torch.float32)
            * (2 * limit) - limit)


def conv_init(gen: torch.Generator, kh, kw, cin, cout) -> Params:
    return {"kernel": _he_normal(gen, (kh, kw, cin, cout)),
            "bias": torch.zeros((cout,), dtype=torch.float32)}


def dense_init(gen: torch.Generator, cin, cout) -> Params:
    return {"kernel": _glorot_uniform(gen, (cin, cout)),
            "bias": torch.zeros((cout,), dtype=torch.float32)}


def bn_init(c) -> Params:
    return {"gamma": torch.ones(c), "beta": torch.zeros(c),
            "moving_mean": torch.zeros(c), "moving_variance": torch.ones(c)}


# ----------------------------------------------------------------------------
# Layer application
# ----------------------------------------------------------------------------

def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF SAME padding (lo, hi) along one axis: the extra goes on the right."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, p: Params, *, stride=1, padding="SAME",
           dtype=torch.bfloat16) -> torch.Tensor:
    """NHWC conv with an HWIO kernel. `padding` is "SAME", "VALID", or
    explicit [(lo, hi), (lo, hi)]."""
    y = conv2d_nobias(x, conv_weight(p["kernel"], dtype), stride=stride,
                      padding=padding, dtype=dtype)
    return (y + p["bias"].to(dtype)).to(dtype)


def conv_weight(kernel: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """An HWIO kernel as the OIHW weight in `dtype` that `F.conv2d` takes
    (a view of the cast)."""
    return kernel.to(dtype).permute(3, 2, 0, 1)


def conv2d_nobias(x: torch.Tensor, w: torch.Tensor, *, stride=1,
                  padding="SAME", dtype=torch.bfloat16) -> torch.Tensor:
    """`conv2d`'s convolution without the bias: an OIHW kernel `w` already
    in `dtype`, the NHWC view of the raw result (rounded to `dtype`)."""
    if isinstance(stride, int):
        stride = (stride, stride)
    kh, kw = w.shape[2], w.shape[3]
    if padding == "SAME":
        pads = [_same_pads(x.shape[1], kh, stride[0]),
                _same_pads(x.shape[2], kw, stride[1])]
    elif padding == "VALID":
        pads = [(0, 0), (0, 0)]
    else:
        pads = [tuple(pp) for pp in padding]
    xc = x.to(dtype).permute(0, 3, 1, 2)
    (t, bt), (l, r) = pads
    if t == bt and l == r:
        y = F.conv2d(xc, w, stride=stride, padding=(t, l))
    else:
        y = F.conv2d(F.pad(xc, (l, r, t, bt)), w, stride=stride)
    return y.permute(0, 2, 3, 1)


def conv2d_transpose(x: torch.Tensor, p: Params, *, stride=2,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """Keras Conv2DTranspose with 'valid' padding and kernel == stride: the
    output blocks do not overlap, out[ki+di, kj+dj, o] = sum_c
    in[i, j, c] * K[di, dj, c, o]."""
    kh, kw = p["kernel"].shape[:2]
    if isinstance(stride, int):
        stride = (stride, stride)
    if (kh, kw) != tuple(stride):
        raise ValueError("deconv requires kernel == stride")
    n, h, w, _ = x.shape
    o = p["kernel"].shape[-1]
    y = torch.einsum("nhwc,pqco->nhpwqo", x.to(dtype),
                     p["kernel"].to(dtype))
    y = y.reshape(n, h * kh, w * kw, o) + p["bias"].to(dtype)
    return y.to(dtype)


class _AllSum(torch.autograd.Function):
    """The sum over the ranks of a process group; its backward sums the
    gradient over the ranks too (every rank's loss reads the sum, and the
    ranks' losses add up)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllSum.apply(grad, ctx.group), None


def bn_scale_shift(p: Params, mean: torch.Tensor | None = None,
                   var: torch.Tensor | None = None, *,
                   eps: float = BN_EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """BN's float32 per-channel scale, gamma * rsqrt(var + eps), and shift,
    beta - mean * scale: with the moving statistics unless `mean` and
    `var` are given."""
    if mean is None:
        mean = p["moving_mean"].float()
        var = p["moving_variance"].float()
    scale = p["gamma"].float() * torch.rsqrt(var + eps)
    return scale, p["beta"].float() - mean * scale


def batch_norm(x: torch.Tensor, p: Params, *, eps: float = BN_EPS,
               use_batch_stats: bool = False, collect: dict | None = None,
               name: str | None = None, group=None) -> torch.Tensor:
    """BatchNormalization (Keras default eps 1e-3), in float32.

    By default it normalizes with the stored moving statistics (inference,
    and Matterport's frozen-BN fine-tuning). `use_batch_stats=True`
    normalizes with the statistics of the current batch over every axis
    but the last (the mean and the biased variance, as `jnp.var`): the
    from-scratch training recipe, which never reads the moving statistics.
    `collect` (a dict) records the batch's (mean, var) under `name`, for
    `train/calibrate.py::calibrate_bn_stats`. With a process `group`
    (each rank a shard of the batch) the batch statistics are the global
    batch's, as GSPMD normalizes a sharded batch: the mean is the
    all-reduced sum over the global count, the variance the all-reduced
    sum of squared deviations from it over the same count (two passes, as
    `jnp.var`), both differentiable."""
    xf = x.float()
    world = 1 if group is None else dist.get_world_size(group)
    if use_batch_stats or collect is not None:
        axes = tuple(range(xf.dim() - 1))
        if world > 1 and use_batch_stats:
            count = xf.numel() // xf.shape[-1] * world
            mean = _AllSum.apply(xf.sum(dim=axes), group) / count
            var = _AllSum.apply(((xf - mean) ** 2).sum(dim=axes),
                                group) / count
        else:
            mean = xf.mean(dim=axes)
            var = xf.var(dim=axes, unbiased=False)
        if collect is not None:
            collect[name] = (mean, var)
    scale, shift = (bn_scale_shift(p, mean, var, eps=eps) if use_batch_stats
                    else bn_scale_shift(p, eps=eps))
    return (xf * scale + shift).to(x.dtype)


def bn_apply(x: torch.Tensor, params: Params, name: str,
             bn_ctx: dict | None = None) -> torch.Tensor:
    """BN by layer name: `bn_ctx` None (moving statistics) or
    {"use_batch_stats": bool, "collect": dict | None, "group": process
    group | None}."""
    if bn_ctx is None:
        return batch_norm(x, params[name])
    return batch_norm(x, params[name],
                      use_batch_stats=bn_ctx.get("use_batch_stats", False),
                      collect=bn_ctx.get("collect"), name=name,
                      group=bn_ctx.get("group"))


def depthwise_conv(x: torch.Tensor, p: Params, *, stride: int = 1,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """NHWC depthwise conv with TF SAME padding (the extra row and column
    on the right at stride 2): kernel (k, k, 1, C) HWIO for C groups, the
    result rounded to `dtype`, then the bias added in it."""
    k = p["kernel"]
    kh, kw, c = k.shape[0], k.shape[1], k.shape[-1]
    (t, bt) = _same_pads(x.shape[1], kh, stride)
    (l, r) = _same_pads(x.shape[2], kw, stride)
    xc = F.pad(x.to(dtype).permute(0, 3, 1, 2), (l, r, t, bt))
    y = F.conv2d(xc, k.to(dtype).permute(3, 2, 0, 1), stride=stride,
                 groups=c).permute(0, 2, 3, 1)
    return (y + p["bias"].to(dtype)).to(dtype)


def dense(x: torch.Tensor, p: Params, *, dtype=torch.bfloat16):
    y = x.to(dtype) @ p["kernel"].to(dtype)
    return y + p["bias"].to(y.dtype)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "SAME") -> torch.Tensor:
    """NHWC max-pool; SAME pads with -inf, extra on the right."""
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (t, bt) = _same_pads(x.shape[1], window, stride)
        (l, r) = _same_pads(x.shape[2], window, stride)
        xc = F.pad(xc, (l, r, t, bt), value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """UpSampling2D(2), nearest neighbour."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 6)
