"""Fused ResNet stem: conv1 7x7/2 (pad 3) + inference BN + ReLU + 3x3/2 SAME
max-pool. The CUDA kernel K3 (`csrc/stem.cu`) and its plain PyTorch version.
Replaces `maskrcnn_tpu/ops/stem_pallas.py::stem_pallas` (via
`apply_stem_pallas`).

Numerics of both versions (those of the TPU kernel): images rounded to
bf16, BN folded into bf16 weights and a float32 bias
(`fold_stem_weights`), float32 accumulation, ReLU, max-pool, one rounding
to bf16 at the end. The TF SAME pool pads 0 on the left and 1 on the right;
post-ReLU values are >= 0, so the kernel's zero for the missing edge row
and column equals the pool's -inf padding. The TPU kernel's 4x4
space-to-depth packing is a Mosaic layout device and is not ported.

`StemFusedDiff` runs the kernel under autograd (frozen-BN training with
`train_fused_kernels`, the JAX package's `_stem_fused_diff`): the kernel
forward, and for the backward the gradient of the layer graph
`models/resnet.py::_stem_layers` in bf16 with the stored BN statistics,
recomputed (there is no backward kernel, on the TPU either).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.ops import cuda_lib
from maskrcnn_tpu_torch.ops.common import graph_vjp

# The tensors `StemFusedDiff` takes after the images, in this order.
STEM_TENSORS = (("conv1", "kernel"), ("conv1", "bias"),
                ("bn_conv1", "gamma"), ("bn_conv1", "beta"),
                ("bn_conv1", "moving_mean"), ("bn_conv1", "moving_variance"))


def fold_stem_weights(conv1: dict, bn: dict, eps: float = 1e-3):
    """(7,7,3,64) conv1 + inference BN -> folded (7,7,3,64) bf16 kernel
    (HWIO) + (64,) float32 bias."""
    k = conv1["kernel"].to(torch.float32)
    b = conv1["bias"].to(torch.float32)
    scale = bn["gamma"].float() * torch.rsqrt(bn["moving_variance"].float()
                                              + eps)
    shift = bn["beta"].float() - bn["moving_mean"].float() * scale
    return (k * scale).to(torch.bfloat16).contiguous(), b * scale + shift


def stem_plain(images: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    x = images.to(torch.bfloat16).to(torch.float32).permute(0, 3, 1, 2)
    y = F.conv2d(x, w.to(torch.float32).permute(3, 2, 0, 1), stride=2,
                 padding=3)
    y = torch.relu(y + bias.to(torch.float32)[None, :, None, None])
    y = F.max_pool2d(F.pad(y, (0, 1, 0, 1), value=float("-inf")), 3, 2)
    return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def stem_cuda(images: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    b, h, wd, _ = images.shape
    if h % 4 or wd % 4:
        raise ValueError(f"stem kernel needs H, W divisible by 4, got "
                         f"{(h, wd)}")
    cuda_lib.require(images, "images", torch.float32, (b, h, wd, 3))
    cuda_lib.require(w, "w", torch.bfloat16, (7, 7, 3, 64))
    cuda_lib.require(bias, "bias", torch.float32, (64,))
    # the kernel reads the image and weights in 16-byte vectors: a view
    # that starts off a 16-byte boundary is copied to one that does not
    images, w, bias = [t if t.data_ptr() % 16 == 0 else t.clone()
                       for t in (images, w, bias)]
    lib = cuda_lib.load()
    out = torch.empty((b, h // 4, wd // 4, 64), dtype=torch.bfloat16,
                      device=images.device)
    with torch.cuda.device(images.device):
        rc = lib.mrt_stem(images.data_ptr(), w.data_ptr(), bias.data_ptr(),
                          out.data_ptr(), b, h, wd,
                          cuda_lib.stream_ptr(images))
    cuda_lib.check(rc, "stem")
    cuda_lib.launches["stem"] += 1
    return out


def stem(images: torch.Tensor, w: torch.Tensor,
         bias: torch.Tensor) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if images.is_cuda:
        return stem_cuda(images.contiguous(), w.contiguous(),
                         bias.contiguous())
    return stem_plain(images, w, bias)


def stem_supported(images: torch.Tensor, dtype: torch.dtype) -> bool:
    """The kernel's gate (as `stem_pallas.stem_supported`): bf16 on the
    card, spatial dims divisible by 32 (the caller adds the stored-BN
    condition, `models/resnet.py::apply_resnet`)."""
    h, w = images.shape[1], images.shape[2]
    return (dtype == torch.bfloat16 and images.is_cuda
            and h % 32 == 0 and w % 32 == 0)


def apply_stem(params: dict, images: torch.Tensor,
               eps: float = 1e-3) -> torch.Tensor:
    """conv1 + bn_conv1 + relu + maxpool of preprocessed f32 images."""
    w, bias = fold_stem_weights(params["conv1"], params["bn_conv1"], eps)
    return stem(images.to(torch.float32), w, bias)


def _stem_params(flat) -> dict:
    params: dict = {}
    for (layer, w), t in zip(STEM_TENSORS, flat):
        params.setdefault(layer, {})[w] = t
    return params


def _stem_graph(images: torch.Tensor, *flat: torch.Tensor) -> torch.Tensor:
    from maskrcnn_tpu_torch.models.resnet import _stem_layers
    return _stem_layers(_stem_params(flat), images, torch.bfloat16)


class StemFusedDiff(torch.autograd.Function):
    """K3 under autograd: forward `apply_stem` (the kernel on a CUDA tensor,
    its plain version on a CPU one), backward the vjp of `_stem_layers`.
    Takes the images, then the `STEM_TENSORS` positionally (autograd
    tracks only tensors passed as arguments)."""

    @staticmethod
    def forward(ctx, images, *flat):
        ctx.save_for_backward(images, *flat)
        return apply_stem(_stem_params(flat), images)

    @staticmethod
    def backward(ctx, grad):
        return graph_vjp(_stem_graph, ctx.saved_tensors,
                         ctx.needs_input_grad, grad.to(torch.bfloat16))


def stem_fused_diff(params: dict, images: torch.Tensor) -> torch.Tensor:
    """conv1 + bn_conv1 + relu + maxpool through `StemFusedDiff`."""
    return StemFusedDiff.apply(images, *(params[layer][w]
                                         for layer, w in STEM_TENSORS))
