"""ViTDet's backbone: a plain ViT with windowed and global attention and a
simple feature pyramid (Li, Mao, Girshick, He, arXiv:2203.16527;
Detectron2 `modeling/backbone/vit.py`, `utils.py`, and
`projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py`).

  patch embedding 16x16/16 conv (bias) + the pretraining position table
    (class token dropped, 14x14 resized bicubically to the grid)
  blocks: x += proj(attn(LN1(x))); x += fc2(GELU(fc1(LN2(x))))
    LayerNorm eps 1e-6, exact GELU, no final norm; qkv with bias; every
    block's attention carries the decomposed relative-position bias
    (`ops/attention.py`). Windowed blocks pad LN1(x) with zeros on the
    bottom and right to a multiple of the window, attend inside each
    window (qkv and proj over the padded tokens, the padding unmasked)
    and crop the padding after the windows are put back; global blocks
    attend over the whole grid
  simple feature pyramid from the stride-16 map:
    P2 deconv 2x2/2 -> LN -> GELU -> deconv 2x2/2; P3 deconv 2x2/2;
    P4 the map; P5 max-pool 2x2/2; each then a 1x1 conv (no bias) -> LN
    -> 3x3 conv (no bias) -> LN to `fpn_channels`; P6 = P5[::2, ::2]
    (Detectron2's LastLevelMaxPool). LayerNorms over channels, eps 1e-6.

The published sizes are `VIT[architecture]`; the grid and the global
blocks' relative-position tables follow the configuration's input.
Parameters are the flat {layer: {weight}} dict: conv and deconv kernels
HWIO, dense kernels (in, out), LayerNorm weights `scale` / `bias` (no
BatchNorm name, so nothing folds or freezes them as BN).

Mixed precision: the residual stream, the LayerNorms (statistics and
output) and the position table stay float32; linears, convs and deconvs
run in the compute dtype with the output rounded to it and the bias
added in it, as `models/nn.py` does; GELU runs on the compute dtype's
values and is rounded to it; attention is `ops/attention.py`'s (on the
card in bfloat16: q', k', v and the output rounded to it, the softmax
float32). The float32 route is the plain reference's arithmetic.

On the card in bfloat16 the blocks take the fused route (`_attention_fused`,
`_mlp_fused`): the four linears are `torch.matmul` on bf16 kernels and
biases prepared once per parameter set, each finished by one
`vit_epilogue` pass (`ops/vit_epilogue_cuda.py`): the bias after qkv; bias
and GELU after fc1; bias and residual add after proj and fc2, with the
LayerNorm that follows (LN2 after proj, the next block's LN1 after fc2)
written in bf16 in the layout the next linear reads, the padded windows of
a windowed block included. Block 0's LN1 stays the layers'. The bias, GELU
and residual stream are the layers' bit for bit, a LayerNorm output within
one bf16 ulp.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.models import nn
from maskrcnn_tpu_torch.ops import vit_epilogue_cuda as ve
from maskrcnn_tpu_torch.ops.attention import rel_pos_attention
from maskrcnn_tpu_torch.ops.common import (window_partition,
                                           window_unpartition)
from maskrcnn_tpu_torch.utils.profiling import stage

LN_EPS = 1e-6


class ViTSpec(NamedTuple):
    width: int
    depth: int
    heads: int
    mlp: int
    patch: int
    window: int
    global_blocks: tuple[int, ...]
    pretrain_grid: int          # the position table's grid (224 / patch)
    pyramid: tuple[int, ...]    # the SFP's widths before its convs, P2..P5


VIT = {"vitdet_b": ViTSpec(width=768, depth=12, heads=12, mlp=3072,
                           patch=16, window=14, global_blocks=(2, 5, 8, 11),
                           pretrain_grid=14, pyramid=(192, 384, 768, 768))}


def _ln_init(c: int) -> nn.Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def init_vit(gen: torch.Generator, architecture: str, image_hw,
             channels: int = 256) -> nn.Params:
    """Random init of the backbone and its pyramid: the patch kernel
    scaled by 1/128 (the inputs are mean-subtracted, not normalized), the
    position table N(0, 0.02), dense layers Glorot-uniform, relative
    positions zero (as Detectron2; 2S - 1 rows, S the window's side or,
    in a global block, the grid's), LayerNorms identity."""
    spec = VIT[architecture]
    c, p = spec.width, spec.patch
    grid = (image_hw[0] // p, image_hw[1] // p)
    params: nn.Params = {}
    params["vit_patch_embed"] = nn.conv_init(gen, p, p, 3, c)
    params["vit_patch_embed"]["kernel"] /= 128.0
    params["vit_pos_embed"] = {"table": torch.randn(
        (1, spec.pretrain_grid ** 2 + 1, c), generator=gen) * 0.02}
    hd = c // spec.heads
    for i in range(spec.depth):
        b = f"vit_b{i}_"
        sh, sw = (grid if i in spec.global_blocks
                  else (spec.window, spec.window))
        params[b + "norm1"] = _ln_init(c)
        params[b + "attn_qkv"] = nn.dense_init(gen, c, 3 * c)
        params[b + "attn_proj"] = nn.dense_init(gen, c, c)
        params[b + "attn_rel_pos"] = {
            "rel_pos_h": torch.zeros(2 * sh - 1, hd),
            "rel_pos_w": torch.zeros(2 * sw - 1, hd)}
        params[b + "norm2"] = _ln_init(c)
        params[b + "mlp_fc1"] = nn.dense_init(gen, c, spec.mlp)
        params[b + "mlp_fc2"] = nn.dense_init(gen, spec.mlp, c)
    w2, w3 = spec.pyramid[0], spec.pyramid[1]
    params["sfp_p2_deconv1"] = nn.conv_init(gen, 2, 2, c, 2 * w2)
    params["sfp_p2_norm"] = _ln_init(2 * w2)
    params["sfp_p2_deconv2"] = nn.conv_init(gen, 2, 2, 2 * w2, w2)
    params["sfp_p3_deconv"] = nn.conv_init(gen, 2, 2, c, w3)
    for lvl, cin in zip((2, 3, 4, 5), spec.pyramid):
        b = f"sfp_p{lvl}_"
        params[b + "lateral"] = {"kernel": nn.conv_init(
            gen, 1, 1, cin, channels)["kernel"]}
        params[b + "lateral_norm"] = _ln_init(channels)
        params[b + "output"] = {"kernel": nn.conv_init(
            gen, 3, 3, channels, channels)["kernel"]}
        params[b + "output_norm"] = _ln_init(channels)
    return params


def layer_norm(x: torch.Tensor, p: nn.Params) -> torch.Tensor:
    """LayerNorm over the last axis, eps 1e-6, float32 in and out."""
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), LN_EPS)


def _conv_nobias(x, kernel, dtype):
    """NHWC stride-1 conv with an odd HWIO kernel, zero padding of half
    its size, no bias, rounded to `dtype`."""
    k = kernel.to(dtype).permute(3, 2, 0, 1)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), k,
                 padding=kernel.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def position_table(table: torch.Tensor, spec: ViTSpec, grid) -> torch.Tensor:
    """(1, 1 + g*g, C) pretraining table -> (1, H, W, C) float32: class
    token dropped, resized bicubically (align_corners False) where the
    grid differs."""
    g = spec.pretrain_grid
    pos = table[:, 1:].float().reshape(1, g, g, -1)
    if tuple(grid) != (g, g):
        pos = F.interpolate(pos.permute(0, 3, 1, 2), size=tuple(grid),
                            mode="bicubic", align_corners=False)
        pos = pos.permute(0, 2, 3, 1)
    return pos


def _window(spec: ViTSpec, i: int) -> int:
    """Block `i`'s window side, 0 for a global block."""
    return 0 if i in spec.global_blocks else spec.window


def _attend(qkv, params, spec: ViTSpec, i: int, grid):
    """(n, h w, 3 C) qkv of block `i` -> the heads' attention over each
    (h, w) grid, (n, h, w, C), before proj."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    hd = c // spec.heads
    q, k, v = qkv.view(n, t, 3, spec.heads, hd).permute(
        2, 0, 3, 1, 4).unbind(0)
    rel = params[f"vit_b{i}_attn_rel_pos"]
    o = rel_pos_attention(q, k, v, rel["rel_pos_h"], rel["rel_pos_w"],
                          grid, hd ** -0.5)
    return o.transpose(1, 2).reshape(n, *grid, c)


def _attention(x, params, spec: ViTSpec, i: int, dtype):
    """x + proj(attn(LN1(x))), block `i`, windowed or global."""
    b = f"vit_b{i}_"
    y = layer_norm(x, params[b + "norm1"])
    windowed = i not in spec.global_blocks
    if windowed:
        y, padded = window_partition(y, spec.window)
    n, gh, gw, c = y.shape
    qkv = nn.dense(y.reshape(n, gh * gw, c), params[b + "attn_qkv"],
                   dtype=dtype)
    o = nn.dense(_attend(qkv, params, spec, i, (gh, gw)),
                 params[b + "attn_proj"], dtype=dtype)
    if windowed:
        o = window_unpartition(o, spec.window, padded, x.shape[1:3])
    return x + o.float()


def _mlp(x, params, i: int, dtype):
    b = f"vit_b{i}_"
    y = nn.dense(layer_norm(x, params[b + "norm2"]), params[b + "mlp_fc1"],
                 dtype=dtype)
    y = nn.dense(F.gelu(y), params[b + "mlp_fc2"], dtype=dtype)
    return x + y.float()


def _attention_fused(x, y, params, spec: ViTSpec, i: int):
    """`_attention` on the card in bf16, and LN2 of its result: (x', LN2(x')
    in bf16). `y` is LN1(x) in bf16 in the block's layout (its padded
    windows, or the grid), from the previous block's fc2 pass; None for
    block 0, whose LN1 is the layers'."""
    b = f"vit_b{i}_"
    win = _window(spec, i)
    if y is None:
        y = layer_norm(x, params[b + "norm1"])
        if win:
            y, _ = window_partition(y, win)
        y = y.to(torch.bfloat16)
    n, gh, gw, c = y.shape
    qkv, proj = (ve.prepare(params[b + name])
                 for name in ("attn_qkv", "attn_proj"))
    o = _attend(ve.bias(y.reshape(n, gh * gw, c) @ qkv.kernel, qkv),
                params, spec, i, (gh, gw))
    return ve.bias_residual_norm(o @ proj.kernel, proj, x,
                                 params[b + "norm2"], LN_EPS, window=win)


def _mlp_fused(x, y, params, spec: ViTSpec, i: int):
    """`_mlp` on the card in bf16 from `y` = LN2(x) in bf16, and the next
    block's LN1 of its result in that block's layout: (x', LN1(x') in
    bf16), (x', None) after the last block."""
    b = f"vit_b{i}_"
    fc1, fc2 = (ve.prepare(params[b + name]) for name in ("mlp_fc1",
                                                          "mlp_fc2"))
    h = ve.bias_gelu(y @ fc1.kernel, fc1)
    if i + 1 == spec.depth:
        return ve.bias_residual_norm(h @ fc2.kernel, fc2, x)
    return ve.bias_residual_norm(h @ fc2.kernel, fc2, x,
                                 params[f"vit_b{i + 1}_norm1"], LN_EPS,
                                 window=_window(spec, i + 1),
                                 norm_windowed=True)


def _pyramid(x, params, dtype):
    """Stride-16 map (B, H, W, C) -> P2..P6 in `dtype`."""
    x = x.to(dtype)
    p2 = nn.conv2d_transpose(x, params["sfp_p2_deconv1"], dtype=dtype)
    p2 = F.gelu(layer_norm(p2, params["sfp_p2_norm"]).to(dtype))
    p2 = nn.conv2d_transpose(p2, params["sfp_p2_deconv2"], dtype=dtype)
    p3 = nn.conv2d_transpose(x, params["sfp_p3_deconv"], dtype=dtype)
    p5 = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    out = []
    for lvl, feat in zip((2, 3, 4, 5), (p2, p3, x, p5)):
        b = f"sfp_p{lvl}_"
        y = layer_norm(_conv_nobias(feat, params[b + "lateral"]["kernel"],
                                    dtype), params[b + "lateral_norm"])
        y = layer_norm(_conv_nobias(y, params[b + "output"]["kernel"],
                                    dtype), params[b + "output_norm"])
        out.append(y.to(dtype))
    return (*out, out[3][:, ::2, ::2, :])


def apply_vit(params, images: torch.Tensor, architecture: str,
              dtype=torch.bfloat16):
    """(B, H, W, 3) preprocessed images -> (P2, P3, P4, P5, P6), NHWC in
    `dtype`. Spans: `vit.patch_embed`, per block `vit.window_attention` or
    `vit.global_attention` (args `tokens` a window or the grid, `windows`
    an image) and `vit.mlp`, then `vit.pyramid`; on the fused route a
    block's LN2 is computed inside its attention span and the next block's
    LN1 inside its `vit.mlp` span."""
    spec = VIT[architecture]
    with stage("vit.patch_embed"):
        x = nn.conv2d(images.to(dtype), params["vit_patch_embed"],
                      stride=spec.patch, padding="VALID", dtype=dtype)
        grid = x.shape[1:3]
        x = x.float() + position_table(params["vit_pos_embed"]["table"],
                                       spec, grid)
    nwin = math.ceil(grid[0] / spec.window) * math.ceil(grid[1] /
                                                        spec.window)
    fused = ve.epilogue_supported(x, dtype, spec.width)
    if fused:
        x, y = x.contiguous(), None
    for i in range(spec.depth):
        if i in spec.global_blocks:
            span = stage("vit.global_attention", tokens=grid[0] * grid[1],
                         windows=1)
        else:
            span = stage("vit.window_attention", tokens=spec.window ** 2,
                         windows=nwin)
        with span:
            if fused:
                x, y = _attention_fused(x, y, params, spec, i)
            else:
                x = _attention(x, params, spec, i, dtype)
        with stage("vit.mlp"):
            if fused:
                x, y = _mlp_fused(x, y, params, spec, i)
            else:
                x = _mlp(x, params, i, dtype)
    with stage("vit.pyramid"):
        return _pyramid(x, params, dtype)
