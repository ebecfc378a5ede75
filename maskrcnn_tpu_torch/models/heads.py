"""ROI heads (Matterport names), port of `maskrcnn_tpu/models/heads.py`.

Classifier head: the pool x pool VALID conv `mrcnn_class_conv1` as one
(N, p*p*C) @ (p*p*C, 1024) matmul (the NHWC row-major flatten matches the
HWIO kernel reshape), BN, relu; `mrcnn_class_conv2` as a dense layer, BN,
relu; then `mrcnn_class_logits` (softmax) and `mrcnn_bbox_fc`.

Mask head: 4x [3x3 conv 256 + BN + relu], the 2x2/2 deconv (relu), and
the 1x1 `mrcnn_mask` with sigmoid; with `class_ids` only the detected
class's channel is computed.
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.models import nn


def init_classifier_head(gen: torch.Generator, num_classes: int,
                         in_channels: int = 256, pool_size: int = 7,
                         fc_dim: int = 1024) -> nn.Params:
    return {
        "mrcnn_class_conv1": nn.conv_init(gen, pool_size, pool_size,
                                          in_channels, fc_dim),
        "mrcnn_class_bn1": nn.bn_init(fc_dim),
        "mrcnn_class_conv2": nn.conv_init(gen, 1, 1, fc_dim, fc_dim),
        "mrcnn_class_bn2": nn.bn_init(fc_dim),
        "mrcnn_class_logits": nn.dense_init(gen, fc_dim, num_classes),
        "mrcnn_bbox_fc": nn.dense_init(gen, fc_dim, num_classes * 4),
    }


def apply_classifier_head(params, pooled: torch.Tensor, num_classes: int,
                          dtype=torch.bfloat16, with_logits: bool = False,
                          bn_ctx=None):
    """(N, pool, pool, C) -> probs (N, num_classes) f32, deltas
    (N, num_classes, 4) f32 [, logits f32 for the training losses].
    `bn_ctx` as in `nn.bn_apply`."""
    n = pooled.shape[0]
    k1 = params["mrcnn_class_conv1"]
    flat_k = k1["kernel"].reshape(-1, k1["kernel"].shape[-1])
    x = nn.dense(pooled.reshape(n, -1), {"kernel": flat_k,
                                         "bias": k1["bias"]}, dtype=dtype)
    x = nn.relu(nn.bn_apply(x.to(dtype), params, "mrcnn_class_bn1",
                            bn_ctx))
    k2 = params["mrcnn_class_conv2"]
    x = nn.dense(x, {"kernel": k2["kernel"].reshape(k2["kernel"].shape[-2],
                                                    k2["kernel"].shape[-1]),
                     "bias": k2["bias"]}, dtype=dtype)
    shared = nn.relu(nn.bn_apply(x.to(dtype), params, "mrcnn_class_bn2",
                                 bn_ctx))
    logits = nn.dense(shared, params["mrcnn_class_logits"],
                      dtype=dtype).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    deltas = nn.dense(shared, params["mrcnn_bbox_fc"], dtype=dtype)
    deltas = deltas.to(torch.float32).reshape(n, num_classes, 4)
    if with_logits:
        return probs, deltas, logits
    return probs, deltas


def init_mask_head(gen: torch.Generator, num_classes: int,
                   in_channels: int = 256, channels: int = 256) -> nn.Params:
    params: nn.Params = {}
    cin = in_channels
    for i in range(1, 5):
        params[f"mrcnn_mask_conv{i}"] = nn.conv_init(gen, 3, 3, cin,
                                                     channels)
        params[f"mrcnn_mask_bn{i}"] = nn.bn_init(channels)
        cin = channels
    params["mrcnn_mask_deconv"] = nn.conv_init(gen, 2, 2, channels, channels)
    params["mrcnn_mask"] = nn.conv_init(gen, 1, 1, channels, num_classes)
    return params


def apply_mask_head(params, pooled: torch.Tensor, dtype=torch.bfloat16,
                    bn_ctx=None,
                    class_ids: torch.Tensor | None = None) -> torch.Tensor:
    """(N, pool, pool, C) -> sigmoid masks, (N, 2p, 2p) f32 for the given
    (N,) class ids, else (N, 2p, 2p, num_classes) f32. `bn_ctx` as in
    `nn.bn_apply`."""
    x = pooled
    for i in range(1, 5):
        x = nn.conv2d(x, params[f"mrcnn_mask_conv{i}"], padding="SAME",
                      dtype=dtype)
        x = nn.relu(nn.bn_apply(x, params, f"mrcnn_mask_bn{i}",
                                bn_ctx))
    x = nn.relu(nn.conv2d_transpose(x, params["mrcnn_mask_deconv"],
                                    stride=2, dtype=dtype))
    k = params["mrcnn_mask"]
    if class_ids is not None:
        kern = k["kernel"].reshape(k["kernel"].shape[-2],
                                   k["kernel"].shape[-1])
        ids = class_ids.to(torch.int64)
        w = kern[:, ids].T.to(dtype)                    # (N, C)
        # bf16 products summed in float32, as the JAX einsum with
        # preferred_element_type=float32.
        logits = torch.einsum("nhwc,nc->nhw", x.to(dtype).float(), w.float())
        return torch.sigmoid(logits + k["bias"][ids][:, None, None])
    x = nn.conv2d(x, k, padding="VALID", dtype=dtype)
    return torch.sigmoid(x.to(torch.float32))
