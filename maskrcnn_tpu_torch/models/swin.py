"""Swin Transformer backbone for Mask R-CNN (Liu et al., "Swin Transformer:
Hierarchical Vision Transformer using Shifted Windows", arXiv:2103.14030;
`SwinTransformer/Swin-Transformer-Object-Detection`
`mmdet/models/backbones/swin_transformer.py`, configured by
`configs/swin/mask_rcnn_swin_small_patch4_window7_mstrain_480-800_adamw_3x_coco.py`).

  patch embedding 4x4/4 conv (bias) 3 -> C, then a LayerNorm (patch_norm;
    no absolute position table)
  four stages of widths C, 2C, 4C, 8C; block j of a stage attends in plain
    windows when j is even and in windows shifted by half a window, rounded
    down, when j is odd:
      x += proj(attn(LN1(x))); x += fc2(GELU(fc1(LN2(x))))
    LN1(x) is zero-padded on the bottom and right to a multiple of the
    window; a shifted block rolls the padded map by (-shift, -shift) and
    masks the logits between tokens of different regions
    (`ops/common.py::shift_regions`); the map is cut into windows, qkv,
    the attention (`ops/attention.py::window_attention`: the per-head
    relative-position table in every block) and proj run on every padded
    token, then the windows are joined, rolled back and cropped
  patch merging after stages 1-3: [x[0::2, 0::2], x[1::2, 0::2],
    x[0::2, 1::2], x[1::2, 1::2]] on channels (4C) -> LayerNorm -> linear
    4C -> 2C without bias
  each stage's output, before merging, through its own LayerNorm: C2..C5
    at strides 4, 8, 16, 32, for the top-down FPN (`models/fpn.py`)

LayerNorm eps 1e-5, exact GELU, qkv, proj and the MLP with biases, queries
scaled by head_dim^-0.5. The published sizes are `SWIN[architecture]`.
Parameters are the flat {layer: {weight}} dict: conv kernels HWIO, dense
kernels (in, out), LayerNorm `scale` / `bias`, each block's table
`attn_rel_pos/table` ((2 window - 1)^2, heads); no BatchNorm name, so
nothing folds or freezes them as BN.

Mixed precision as `models/vit.py`'s layers: the residual stream and the
LayerNorms (statistics and output) are float32; LN1's output is rounded
to the compute dtype before it is padded and cut (the rounding qkv would
make); linears and the patch conv run in the compute dtype with the output
rounded to it and the bias added in it; GELU runs on the compute dtype's
values; attention is `ops/attention.py`'s. The float32 route is the plain
reference's arithmetic.

On the card in bf16 the blocks take the fused route (`_attention_fused`,
`_mlp_fused`), as `models/vit.py`'s: the four linears are `torch.matmul` on
bf16 kernels and biases prepared once per parameter set, each finished by
one `vit_epilogue` pass (`ops/vit_epilogue_cuda.py`): the bias after qkv;
after proj the bias and the residual add, proj's output read in the
block's rolled, padded windows and x' written in the grid, with LN2; bias
and GELU after fc1; after fc2 the bias and residual add with the next
block's LN1 written straight into that block's rolled, padded windows (pad
rows zero), or after a stage's last block the stage's output norm in the
grid (the bf16 C2..C5). A stage's first block keeps the layers' LN1 (after
the patch embedding or a merge); the merges and the patch norm are the
layers'. The bias, GELU and residual stream are the layers' bit for bit,
a LayerNorm output within one bf16 ulp.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.models import nn
from maskrcnn_tpu_torch.ops import vit_epilogue_cuda as ve
from maskrcnn_tpu_torch.ops.attention import window_attention
from maskrcnn_tpu_torch.ops.common import (shift_regions, window_partition,
                                           window_unpartition)
from maskrcnn_tpu_torch.utils.profiling import stage

LN_EPS = 1e-5


class SwinSpec(NamedTuple):
    embed: int                 # the first stage's width C
    depths: tuple[int, ...]
    heads: tuple[int, ...]
    window: int
    mlp_ratio: int
    patch: int

    @property
    def widths(self) -> tuple[int, ...]:
        return tuple(self.embed * 2 ** s for s in range(len(self.depths)))


SWIN = {"swin_s": SwinSpec(embed=96, depths=(2, 2, 18, 2),
                           heads=(3, 6, 12, 24), window=7, mlp_ratio=4,
                           patch=4)}


def _shift(spec: SwinSpec, j: int) -> int:
    """Block `j`'s window shift: half a window, rounded down, in odd
    blocks."""
    return spec.window // 2 if j % 2 else 0


def _ln_init(c: int) -> nn.Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def init_swin(gen: torch.Generator, architecture: str) -> nn.Params:
    """Random init of the backbone: the patch kernel He-normal, dense
    layers Glorot-uniform, the relative-position tables N(0, 0.02) (the
    source's truncation at 2 std left out), LayerNorms identity; in the
    layer order the reference's `param_shapes` gives."""
    spec = SWIN[architecture]
    params: nn.Params = {
        "swin_patch_embed": nn.conv_init(gen, spec.patch, spec.patch, 3,
                                         spec.embed),
        "swin_patch_norm": _ln_init(spec.embed)}
    rows = (2 * spec.window - 1) ** 2
    for s, (depth, heads, c) in enumerate(zip(spec.depths, spec.heads,
                                              spec.widths)):
        for j in range(depth):
            b = f"swin_s{s}_b{j}_"
            params[b + "norm1"] = _ln_init(c)
            params[b + "attn_qkv"] = nn.dense_init(gen, c, 3 * c)
            params[b + "attn_rel_pos"] = {"table": torch.randn(
                (rows, heads), generator=gen) * 0.02}
            params[b + "attn_proj"] = nn.dense_init(gen, c, c)
            params[b + "norm2"] = _ln_init(c)
            params[b + "mlp_fc1"] = nn.dense_init(gen, c, spec.mlp_ratio * c)
            params[b + "mlp_fc2"] = nn.dense_init(gen, spec.mlp_ratio * c, c)
        params[f"swin_norm{s}"] = _ln_init(c)
        if s + 1 < len(spec.depths):
            params[f"swin_merge{s}_norm"] = _ln_init(4 * c)
            params[f"swin_merge{s}_reduction"] = {"kernel": nn.dense_init(
                gen, 4 * c, 2 * c)["kernel"]}
    return params


def layer_norm(x: torch.Tensor, p: nn.Params) -> torch.Tensor:
    """LayerNorm over the last axis, eps 1e-5, float32 in and out."""
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), LN_EPS)


def _attend(qkv, params, b: str, heads: int, window: int, shift: int,
            padded):
    """(B, windows, window^2, 3 C) qkv of the block whose layers start with
    `b` over its (Hp, Wp) padded map -> the heads' attention in each
    window, (B * windows, window, window, C), before proj."""
    c = qkv.shape[-1] // 3
    q, k, v = qkv.view(*qkv.shape[:3], 3, heads, c // heads).permute(
        3, 0, 1, 4, 2, 5).unbind(0)
    regions = (shift_regions(padded, window, shift, qkv.device) if shift
               else None)
    o = window_attention(q, k, v, params[b + "attn_rel_pos"]["table"],
                         window, (c // heads) ** -0.5, regions)
    return o.transpose(2, 3).reshape(-1, window, window, c)


def _attention(x, params, b: str, heads: int, window: int, shift: int,
               dtype):
    """x + proj(attn(LN1(x))) of the block whose layers start with `b`,
    its windows shifted by `shift` (0: plain windows)."""
    bsz, h, w, c = x.shape
    y, padded = window_partition(layer_norm(x, params[b + "norm1"])
                                 .to(dtype), window, shift)
    qkv = nn.dense(y.view(bsz, -1, window * window, c),
                   params[b + "attn_qkv"], dtype=dtype)
    o = nn.dense(_attend(qkv, params, b, heads, window, shift, padded),
                 params[b + "attn_proj"], dtype=dtype)
    return x + window_unpartition(o, window, padded, (h, w), shift).float()


def _mlp(x, params, b: str, dtype):
    y = nn.dense(layer_norm(x, params[b + "norm2"]), params[b + "mlp_fc1"],
                 dtype=dtype)
    y = nn.dense(F.gelu(y), params[b + "mlp_fc2"], dtype=dtype)
    return x + y.float()


def _attention_fused(x, y, params, b: str, heads: int, window: int,
                     shift: int):
    """`_attention` on the card in bf16, and LN2 of its result: (x', LN2(x')
    in bf16). `y` is LN1(x) in bf16 in the block's rolled, padded windows,
    from the previous block's fc2 pass; None for a stage's first block,
    whose LN1 is the layers'."""
    bsz, h, w, c = x.shape
    if y is None:
        y, _ = window_partition(layer_norm(x, params[b + "norm1"])
                                .to(torch.bfloat16), window, shift)
    padded = (-(-h // window) * window, -(-w // window) * window)
    qkv, proj = (ve.prepare(params[b + name])
                 for name in ("attn_qkv", "attn_proj"))
    o = _attend(ve.bias(y.view(bsz, -1, window * window, c) @ qkv.kernel,
                        qkv), params, b, heads, window, shift, padded)
    return ve.bias_residual_norm(o @ proj.kernel, proj, x,
                                 params[b + "norm2"], LN_EPS, window=window,
                                 shift=shift)


def _mlp_fused(x, y, params, b: str, norm, window: int, shift: int):
    """`_mlp` on the card in bf16 from `y` = LN2(x) in bf16, and the
    LayerNorm `norm` of its result: (x', the next block's LN1 in bf16 in
    its rolled, padded windows of side `window`, shifted by `shift`), or
    with `window` 0 (x', the stage's output norm in bf16 in the grid)."""
    fc1, fc2 = (ve.prepare(params[b + name]) for name in ("mlp_fc1",
                                                          "mlp_fc2"))
    hidden = ve.bias_gelu(y @ fc1.kernel, fc1)
    return ve.bias_residual_norm(hidden @ fc2.kernel, fc2, x, norm, LN_EPS,
                                 window=window, norm_windowed=bool(window),
                                 shift=shift)


def _merge(x, params, s: int, dtype):
    """Patch merging after stage `s`: (B, H, W, C) -> (B, H/2, W/2, 2C)
    float32."""
    y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], -1)
    y = layer_norm(y, params[f"swin_merge{s}_norm"]).to(dtype)
    return (y @ params[f"swin_merge{s}_reduction"]["kernel"].to(dtype)
            ).float()


def apply_swin(params, images: torch.Tensor, architecture: str,
               dtype=torch.bfloat16):
    """(B, H, W, 3) preprocessed images -> C2..C5, NHWC in `dtype`. Spans:
    `swin.patch_embed`; per block `swin.window_attention` or
    `swin.shifted_window_attention` (args `stage`, `windows` an image,
    `tokens` a window) and `swin.mlp`; `swin.patch_merge` after stages
    1-3. On the fused route a block's LN2 is computed inside its attention
    span, and the next block's LN1 or the stage's output norm inside its
    `swin.mlp` span."""
    spec = SWIN[architecture]
    with stage("swin.patch_embed"):
        x = nn.conv2d(images.to(dtype), params["swin_patch_embed"],
                      stride=spec.patch, padding="VALID", dtype=dtype)
        x = layer_norm(x, params["swin_patch_norm"])
    fused = all(ve.epilogue_supported(x, dtype, c) for c in spec.widths)
    outs = []
    for s, (depth, heads) in enumerate(zip(spec.depths, spec.heads)):
        windows = (math.ceil(x.shape[1] / spec.window)
                   * math.ceil(x.shape[2] / spec.window))
        y = None        # a stage's first LN1 is the layers'
        for j in range(depth):
            b = f"swin_s{s}_b{j}_"
            shift = _shift(spec, j)
            name = ("swin.shifted_window_attention" if shift
                    else "swin.window_attention")
            with stage(name, stage=s + 1, windows=windows,
                       tokens=spec.window ** 2):
                if fused:
                    x, y = _attention_fused(x, y, params, b, heads,
                                            spec.window, shift)
                else:
                    x = _attention(x, params, b, heads, spec.window, shift,
                                   dtype)
            with stage("swin.mlp"):
                if fused and j + 1 < depth:
                    x, y = _mlp_fused(x, y, params, b,
                                      params[f"swin_s{s}_b{j + 1}_norm1"],
                                      spec.window, _shift(spec, j + 1))
                elif fused:
                    x, y = _mlp_fused(x, y, params, b,
                                      params[f"swin_norm{s}"], 0, 0)
                else:
                    x = _mlp(x, params, b, dtype)
        outs.append(y if fused else
                    layer_norm(x, params[f"swin_norm{s}"]).to(dtype))
        if s + 1 < len(spec.depths):
            with stage("swin.patch_merge"):
                x = _merge(x, params, s, dtype)
    return tuple(outs)
