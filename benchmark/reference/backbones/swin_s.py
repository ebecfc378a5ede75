"""Swin-S (Liu et al., arXiv:2103.14030; Swin-Transformer-Object-Detection
`configs/swin/mask_rcnn_swin_small_patch4_window7_mstrain_480-800_adamw_3x_coco.py`,
the backbone of `mmdet/models/backbones/swin_transformer.py`): a 4x4 patch
embedding with a LayerNorm, four stages of depths 2, 2, 18, 2, widths 96,
192, 384, 768 and 3, 6, 12, 24 heads of 32, 7x7 windows shifted by 3 in
every second block, a per-head relative-position table in every block,
patch merging between stages and a LayerNorm on each stage's output, under
Matterport's top-down FPN. Layers named `swin_*`, then `fpn_*`. It runs no
port kernel, so it gives no `kernel_work`.

Written from the equations, in float32, every matmul and convolution
operand through `nx.q` (q, k, v and the probabilities too, so the float8
control covers the attention):

  x = LN(patch4x4(image))
  per block: x += proj(attn(LN1(x))), x += fc2(GELU(fc1(LN2(x))))
    LN1(x) zero-padded bottom/right to a multiple of 7; in a shifted block
    rolled by (-3, -3); cut into 7x7 windows; qkv, attention and proj on
    every padded token; joined, rolled back by (3, 3), cropped
    attn: softmax(32^-0.5 q.k + B[h] (+ M in a shifted block)) v, where
    B[h][(i, j), (k, l)] = table[(i - k + 6) 13 + (j - l + 6), h], and
    M = -100 between tokens whose regions differ: the rolled padded map's
    rows cut at Hp - 7 and Hp - 3, its columns at Wp - 7 and Wp - 3
  merge: LN(cat(x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
    x[1::2, 1::2])) @ reduction (4C -> 2C, no bias)
  C2..C5: each stage's output (before merging) through its own LN

LayerNorm eps 1e-5 throughout; GELU exact.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark import roofline
from benchmark.reference import model as R

EMBED, PATCH, WINDOW, SHIFT, MLP_RATIO = 96, 4, 7, 3, 4
DEPTHS, HEADS = (2, 2, 18, 2), (3, 6, 12, 24)
WIDTHS = tuple(EMBED * 2 ** s for s in range(4))
EPS = 1e-5
MASKED = -100.0

# Initial scales (the weights are random): qkv, proj, fc2 and the merges'
# reductions at sqrt(1 / fan-in) (each of the 24 blocks adds to the stream
# about as much as it holds), fc1 He (before GELU); LayerNorm gains and
# biases and the relative-position tables uniform, the tables at about the
# scaled q.k logits' spread (std ~1), so that the bias is felt.
LN_SCALE, LN_BIAS = (0.8, 1.2), (-0.1, 0.1)
TABLE_RANGE = (-1.5, 1.5)


def ln_shape(c):
    return {"scale": (c,), "bias": (c,)}


def param_shapes(cfg) -> dict[str, dict[str, tuple]]:
    rows = (2 * WINDOW - 1) ** 2
    shapes = {"swin_patch_embed": R.conv_shape(PATCH, PATCH, 3, EMBED),
              "swin_patch_norm": ln_shape(EMBED)}
    for s, (depth, heads, c) in enumerate(zip(DEPTHS, HEADS, WIDTHS)):
        for j in range(depth):
            b = f"swin_s{s}_b{j}_"
            shapes[b + "norm1"] = ln_shape(c)
            shapes[b + "attn_qkv"] = {"kernel": (c, 3 * c), "bias": (3 * c,)}
            shapes[b + "attn_rel_pos"] = {"table": (rows, heads)}
            shapes[b + "attn_proj"] = {"kernel": (c, c), "bias": (c,)}
            shapes[b + "norm2"] = ln_shape(c)
            shapes[b + "mlp_fc1"] = {"kernel": (c, MLP_RATIO * c),
                                     "bias": (MLP_RATIO * c,)}
            shapes[b + "mlp_fc2"] = {"kernel": (MLP_RATIO * c, c),
                                     "bias": (c,)}
        shapes[f"swin_norm{s}"] = ln_shape(c)
        if s + 1 < len(DEPTHS):
            shapes[f"swin_merge{s}_norm"] = ln_shape(4 * c)
            shapes[f"swin_merge{s}_reduction"] = {"kernel": (4 * c, 2 * c)}
    shapes.update(R.topdown_fpn_shapes(cfg, WIDTHS))
    return shapes


# --------------------------------------------------------------------------
# Layers (tokens NHWC float32)
# --------------------------------------------------------------------------

def ln(x, p):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * p["scale"] + p["bias"]


def linear(x, p, nx):
    return nx.q(x) @ nx.q(p["kernel"]) + p["bias"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def bias_of(table):
    """(169, heads) -> (heads, 49, 49): query (i, j), key (k, l) read row
    (i - k + 6) 13 + (j - l + 6)."""
    i, j = torch.meshgrid(torch.arange(WINDOW), torch.arange(WINDOW),
                          indexing="ij")
    i, j = i.flatten(), j.flatten()
    row = ((i[:, None] - i[None, :] + WINDOW - 1) * (2 * WINDOW - 1)
           + (j[:, None] - j[None, :] + WINDOW - 1))
    return table[row.to(table.device)].permute(2, 0, 1)


def windows_of(x):
    """(B, Hp, Wp, C) -> (B, nW, 49, C), windows row-major."""
    b, hp, wp, c = x.shape
    return (x.reshape(b, hp // WINDOW, WINDOW, wp // WINDOW, WINDOW, c)
            .permute(0, 1, 3, 2, 4, 5).reshape(b, -1, WINDOW * WINDOW, c))


def merge_windows(x, hp, wp):
    """`windows_of`'s inverse: (B, nW, 49, C) -> (B, Hp, Wp, C)."""
    b, c = x.shape[0], x.shape[-1]
    return (x.reshape(b, hp // WINDOW, wp // WINDOW, WINDOW, WINDOW, c)
            .permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c))


def shift_mask(hp, wp, device):
    """(nW, 49, 49): MASKED between tokens of a window whose regions of
    the rolled padded map differ, else 0."""
    label = torch.zeros((1, hp, wp, 1), device=device)
    cuts = lambda n: (slice(0, n - WINDOW), slice(n - WINDOW, n - SHIFT),
                      slice(n - SHIFT, n))
    region = 0
    for rows in cuts(hp):
        for cols in cuts(wp):
            label[:, rows, cols] = region
            region += 1
    lab = windows_of(label)[0, :, :, 0]
    return torch.where(lab[:, :, None] == lab[:, None, :], 0.0, MASKED)


def attend(q, k, v, table, mask, nx):
    """(b, nW, heads, 49, d) -> the same; `mask` (nW, 49, 49) or None."""
    d = q.shape[-1]
    logits = nx.q(q * d ** -0.5) @ nx.q(k).transpose(-1, -2)
    logits = logits + bias_of(table)
    if mask is not None:
        logits = logits + mask[:, None]
    return nx.q(torch.softmax(logits, -1)) @ nx.q(v)


def attention_block(x, params, b, heads, shifted, nx):
    bsz, h, w, c = x.shape
    hp, wp = -(-h // WINDOW) * WINDOW, -(-w // WINDOW) * WINDOW
    y = F.pad(ln(x, params[b + "norm1"]), (0, 0, 0, wp - w, 0, hp - h))
    if shifted:
        y = torch.roll(y, (-SHIFT, -SHIFT), (1, 2))
    wins = windows_of(y)
    nw = wins.shape[1]
    qkv = linear(wins, params[b + "attn_qkv"], nx)
    q, k, v = qkv.reshape(bsz, nw, WINDOW * WINDOW, 3, heads,
                          c // heads).permute(3, 0, 1, 4, 2, 5)
    out = attend(q, k, v, params[b + "attn_rel_pos"]["table"],
                 shift_mask(hp, wp, x.device) if shifted else None, nx)
    out = linear(out.transpose(2, 3).reshape(bsz, nw, -1, c),
                 params[b + "attn_proj"], nx)
    out = merge_windows(out, hp, wp)
    if shifted:
        out = torch.roll(out, (SHIFT, SHIFT), (1, 2))
    return x + out[:, :h, :w]


def mlp_block(x, params, b, nx):
    y = gelu(linear(ln(x, params[b + "norm2"]), params[b + "mlp_fc1"], nx))
    return x + linear(y, params[b + "mlp_fc2"], nx)


def merge(x, params, s, nx):
    y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], -1)
    y = ln(y, params[f"swin_merge{s}_norm"])
    return nx.q(y) @ nx.q(params[f"swin_merge{s}_reduction"]["kernel"])


def pyramid(params, x, cfg, nx):
    t = F.conv2d(nx.q(x), nx.q(params["swin_patch_embed"]["kernel"]
                              .permute(3, 2, 0, 1)), stride=PATCH)
    t = ln(t.permute(0, 2, 3, 1) + params["swin_patch_embed"]["bias"],
           params["swin_patch_norm"])
    c_maps = []
    for s, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        for j in range(depth):
            b = f"swin_s{s}_b{j}_"
            t = mlp_block(attention_block(t, params, b, heads, j % 2 == 1,
                                          nx), params, b, nx)
        c_maps.append(ln(t, params[f"swin_norm{s}"]).permute(0, 3, 1, 2))
        if s + 1 < len(DEPTHS):
            t = merge(t, params, s, nx)
    return R.topdown_fpn(params, c_maps, nx)


# --------------------------------------------------------------------------
# Multiply-adds, initial scales
# --------------------------------------------------------------------------

def macs(cfg) -> dict[str, float]:
    """Per image: the patch embedding; each block's qkv and proj over its
    padded tokens, q.k and p.v in every window, the MLP over the stage's
    grid; each merge's reduction over the next grid; the FPN over C2..C5."""
    gh, gw = cfg.image_height // PATCH, cfg.image_width // PATCH
    total = gh * gw * PATCH * PATCH * 3 * EMBED
    for s, (depth, heads, c) in enumerate(zip(DEPTHS, HEADS, WIDTHS)):
        h, w = gh >> s, gw >> s
        padded = (-(-h // WINDOW) * WINDOW) * (-(-w // WINDOW) * WINDOW)
        t = WINDOW * WINDOW
        per_block = (padded * 4 * c * c               # qkv, proj
                     + padded * 2 * t * c             # q.k, p.v
                     + h * w * 2 * MLP_RATIO * c * c)  # fc1, fc2
        total += depth * per_block
        if s:
            total += h * w * 2 * c * c                 # the merge into it
    return {"backbone": float(total),
            "fpn": roofline.topdown_fpn_macs(cfg, WIDTHS)}


def init_std(layer: str, shape) -> float | None:
    """The patch embedding He-normal scaled by 1/128 (the inputs are
    mean-subtracted, not normalized; its LayerNorm follows); qkv, proj,
    fc2 and the reductions at sqrt(1 / fan-in); fc1 and the FPN He."""
    if layer == "swin_patch_embed":
        return math.sqrt(2.0 / math.prod(shape[:-1])) / 128.0
    if layer.startswith("swin_") and not layer.endswith("fc1"):
        return math.sqrt(1.0 / shape[0])
    return None


def init_range(layer: str, weight: str, shape) -> tuple | None:
    if "norm" in layer:
        return LN_SCALE if weight == "scale" else LN_BIAS
    if weight == "table":
        return TABLE_RANGE
    return None
