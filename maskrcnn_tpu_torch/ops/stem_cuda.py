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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.ops import cuda_lib


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
    """The kernel's gate (as `stem_pallas.stem_supported`): bf16 inference
    on the card, spatial dims divisible by 32."""
    h, w = images.shape[1], images.shape[2]
    return (dtype == torch.bfloat16 and images.is_cuda
            and h % 32 == 0 and w % 32 == 0)


def apply_stem(params: dict, images: torch.Tensor,
               eps: float = 1e-3) -> torch.Tensor:
    """conv1 + bn_conv1 + relu + maxpool of preprocessed f32 images."""
    w, bias = fold_stem_weights(params["conv1"], params["bn_conv1"], eps)
    return stem(images.to(torch.float32), w, bias)
