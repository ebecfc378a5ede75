"""ViTDet-B (Li, Mao, Girshick, He, arXiv:2203.16527; Detectron2
`projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py`, the backbone
of `modeling/backbone/vit.py` and `utils.py`): a plain ViT-B/16 with 14x14
windowed attention in blocks 0, 1, 3, 4, 6, 7, 9, 10, global attention in
2, 5, 8, 11, the decomposed relative-position bias in every block, and
the simple feature pyramid. Layers named `vit_*` and `sfp_*`. It runs no
port kernel, so it gives no `kernel_work`.

Written from the equations, in float32, every matmul and convolution
operand through `nx.q` (q, k, v, the probabilities and the bias's
einsum operands too, so the float8 control covers the attention):

  x = patch16x16(image) + bicubic(pos_table[1:] as 14x14 -> grid)
  per block: x += proj(attn(LN1(x))), x += fc2(GELU(fc1(LN2(x))))
    windowed: LN1(x) zero-padded bottom/right to a multiple of 14, split
    into 14x14 windows, padding unmasked, cropped after the windows join
    attn: softmax(scale q.k + q.Rh[i, kh] + q.Rw[j, kw]) v, 12 heads of
    64, scale 64^-0.5, R[i, k] = table[i - k + S - 1], S the window or
    the grid side
  SFP: P2 = deconv(GELU(LN(deconv(x)))), P3 = deconv(x), P4 = x,
    P5 = maxpool2(x); each 1x1 conv -> LN -> 3x3 conv -> LN, no biases;
    P6 = P5[::2, ::2]

LayerNorm eps 1e-6 throughout. The global attention runs one image at a
time (a (12, 4096, 4096) float32 block of logits at 1024^2).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import model as R

WIDTH, DEPTH, HEADS, MLP, PATCH, WINDOW = 768, 12, 12, 3072, 16, 14
GLOBAL = (2, 5, 8, 11)
PRETRAIN = 14                    # the position table's grid, 224 / 16
SFP_IN = (192, 384, 768, 768)   # P2..P5 widths before the pyramid's convs
EPS = 1e-6

# Initial scales (the weights are random): the ViT linears at
# sqrt(1 / fan-in) except fc1 (He, before GELU); LayerNorm gains and
# biases, the position table and the relative-position tables uniform.
LN_SCALE, LN_BIAS = (0.8, 1.2), (-0.1, 0.1)
POS_RANGE = (-0.5, 0.5)
REL_RANGE = (-0.15, 0.15)


def grid(cfg) -> tuple[int, int]:
    return cfg.image_height // PATCH, cfg.image_width // PATCH


def ln_shape(c):
    return {"scale": (c,), "bias": (c,)}


def param_shapes(cfg) -> dict[str, dict[str, tuple]]:
    gh, gw = grid(cfg)
    hd = WIDTH // HEADS
    shapes = {"vit_patch_embed": R.conv_shape(PATCH, PATCH, 3, WIDTH),
              "vit_pos_embed": {"table": (1, PRETRAIN ** 2 + 1, WIDTH)}}
    for i in range(DEPTH):
        b = f"vit_b{i}_"
        sh, sw = (gh, gw) if i in GLOBAL else (WINDOW, WINDOW)
        shapes[b + "norm1"] = ln_shape(WIDTH)
        shapes[b + "attn_qkv"] = {"kernel": (WIDTH, 3 * WIDTH),
                                  "bias": (3 * WIDTH,)}
        shapes[b + "attn_proj"] = {"kernel": (WIDTH, WIDTH), "bias": (WIDTH,)}
        shapes[b + "attn_rel_pos"] = {"rel_pos_h": (2 * sh - 1, hd),
                                      "rel_pos_w": (2 * sw - 1, hd)}
        shapes[b + "norm2"] = ln_shape(WIDTH)
        shapes[b + "mlp_fc1"] = {"kernel": (WIDTH, MLP), "bias": (MLP,)}
        shapes[b + "mlp_fc2"] = {"kernel": (MLP, WIDTH), "bias": (WIDTH,)}
    shapes["sfp_p2_deconv1"] = R.conv_shape(2, 2, WIDTH, 2 * SFP_IN[0])
    shapes["sfp_p2_norm"] = ln_shape(2 * SFP_IN[0])
    shapes["sfp_p2_deconv2"] = R.conv_shape(2, 2, 2 * SFP_IN[0], SFP_IN[0])
    shapes["sfp_p3_deconv"] = R.conv_shape(2, 2, WIDTH, SFP_IN[1])
    ch = cfg.fpn_channels
    for lvl, cin in zip((2, 3, 4, 5), SFP_IN):
        b = f"sfp_p{lvl}_"
        shapes[b + "lateral"] = {"kernel": (1, 1, cin, ch)}
        shapes[b + "lateral_norm"] = ln_shape(ch)
        shapes[b + "output"] = {"kernel": (3, 3, ch, ch)}
        shapes[b + "output_norm"] = ln_shape(ch)
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


def table_rows(table, size):
    """R[i, k] = table[i - k + size - 1]: (size, size, d)."""
    i = torch.arange(size, device=table.device)
    return table[i[:, None] - i[None, :] + size - 1]


def attend(q, k, v, rel, hw, nx):
    """(n, heads, T, d) on one (h, w) grid -> (n, heads, T, d)."""
    h, w = hw
    n, heads, t, d = q.shape
    rq = nx.q(q).reshape(n, heads, h, w, d)
    rel_h = torch.einsum("nahwc,hkc->nahwk", rq,
                         nx.q(table_rows(rel["rel_pos_h"], h)))
    rel_w = torch.einsum("nahwc,wkc->nahwk", rq,
                         nx.q(table_rows(rel["rel_pos_w"], w)))
    logits = nx.q(q * d ** -0.5) @ nx.q(k).transpose(-1, -2)
    logits = (logits.reshape(n, heads, h, w, h, w)
              + rel_h[:, :, :, :, :, None] + rel_w[:, :, :, :, None, :])
    probs = torch.softmax(logits.reshape(n, heads, t, t), -1)
    return nx.q(probs) @ nx.q(v)


def attention_block(x, params, i, nx):
    b = f"vit_b{i}_"
    bsz, h, w, c = x.shape
    y = ln(x, params[b + "norm1"])
    if i in GLOBAL:
        wins, win_hw = y, (h, w)
    else:
        win = WINDOW
        hp, wp = -(-h // win) * win, -(-w // win) * win
        y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        wins = (y.reshape(bsz, hp // win, win, wp // win, win, c)
                .permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c))
        win_hw = (win, win)
    n, t = wins.shape[0], win_hw[0] * win_hw[1]
    qkv = linear(wins.reshape(n, t, c), params[b + "attn_qkv"], nx)
    q, k, v = qkv.reshape(n, t, 3, HEADS, c // HEADS).permute(
        2, 0, 3, 1, 4)
    per = n // bsz          # windows an image: one image a call
    out = torch.cat([attend(q[s:s + per], k[s:s + per], v[s:s + per],
                            params[b + "attn_rel_pos"], win_hw, nx)
                     for s in range(0, n, per)])
    out = out.permute(0, 2, 1, 3).reshape(n, t, c)
    out = linear(out, params[b + "attn_proj"], nx)
    if i not in GLOBAL:
        out = (out.reshape(bsz, hp // win, wp // win, win, win, c)
               .permute(0, 1, 3, 2, 4, 5).reshape(bsz, hp, wp, c)
               [:, :h, :w])
    return x + out.reshape(bsz, h, w, c)


def mlp_block(x, params, i, nx):
    b = f"vit_b{i}_"
    y = gelu(linear(ln(x, params[b + "norm2"]), params[b + "mlp_fc1"], nx))
    return x + linear(y, params[b + "mlp_fc2"], nx)


def deconv(x, p, nx):
    """NHWC, 2x2 stride-2 transposed conv of an HWIO kernel, with bias."""
    y = F.conv_transpose2d(nx.q(x.permute(0, 3, 1, 2)),
                           nx.q(p["kernel"].permute(2, 3, 0, 1)), stride=2)
    return y.permute(0, 2, 3, 1) + p["bias"]


def conv_nobias(x, kernel, nx):
    """NHWC stride-1 conv, zero padding (k - 1) / 2, no bias."""
    y = F.conv2d(nx.q(x.permute(0, 3, 1, 2)),
                 nx.q(kernel.permute(3, 2, 0, 1)),
                 padding=kernel.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def pyramid(params, x, cfg, nx):
    gh, gw = grid(cfg)
    t = F.conv2d(nx.q(x), nx.q(params["vit_patch_embed"]["kernel"]
                              .permute(3, 2, 0, 1)), stride=PATCH)
    t = t.permute(0, 2, 3, 1) + params["vit_patch_embed"]["bias"]
    pos = params["vit_pos_embed"]["table"][:, 1:].reshape(
        1, PRETRAIN, PRETRAIN, WIDTH).permute(0, 3, 1, 2)
    if (gh, gw) != (PRETRAIN, PRETRAIN):
        pos = F.interpolate(pos, size=(gh, gw), mode="bicubic",
                            align_corners=False)
    t = t + pos.permute(0, 2, 3, 1)
    for i in range(DEPTH):
        t = mlp_block(attention_block(t, params, i, nx), params, i, nx)
    p2 = deconv(t, params["sfp_p2_deconv1"], nx)
    p2 = deconv(gelu(ln(p2, params["sfp_p2_norm"])),
                params["sfp_p2_deconv2"], nx)
    p3 = deconv(t, params["sfp_p3_deconv"], nx)
    p5 = F.max_pool2d(t.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    out = []
    for lvl, f in zip((2, 3, 4, 5), (p2, p3, t, p5)):
        b = f"sfp_p{lvl}_"
        f = ln(conv_nobias(f, params[b + "lateral"]["kernel"], nx),
               params[b + "lateral_norm"])
        f = ln(conv_nobias(f, params[b + "output"]["kernel"], nx),
               params[b + "output_norm"])
        out.append(f.permute(0, 3, 1, 2))
    return out + [out[3][:, :, ::2, ::2]]


# --------------------------------------------------------------------------
# Multiply-adds, initial scales
# --------------------------------------------------------------------------

def macs(cfg) -> dict[str, float]:
    """Per image: the patch embedding; each block's qkv and proj over its
    tokens (a windowed block's padded ones), q.k and p.v, the bias's two
    einsums (a token against each row and each column of its window or
    grid), the MLP over the grid's tokens; the SFP's deconvs and convs."""
    gh, gw = grid(cfg)
    tokens = gh * gw
    hd = WIDTH // HEADS
    total = tokens * PATCH * PATCH * 3 * WIDTH
    for i in range(DEPTH):
        if i in GLOBAL:
            n, (h, w) = 1, (gh, gw)
        else:
            n, (h, w) = (-(-gh // WINDOW)) * (-(-gw // WINDOW)), (WINDOW,
                                                                 WINDOW)
        t = n * h * w
        total += t * (WIDTH * 3 * WIDTH + WIDTH * WIDTH)
        total += n * HEADS * (2 * (h * w) ** 2 * hd + h * w * (h + w) * hd)
        total += tokens * 2 * WIDTH * MLP
    ch, w2, w3 = cfg.fpn_channels, SFP_IN[0], SFP_IN[1]
    fpn = (4 * tokens * WIDTH * 2 * w2 + 16 * tokens * 2 * w2 * w2
           + 4 * tokens * WIDTH * w3)
    for (fh, fw), cin in zip(cfg.feature_shapes[:4], SFP_IN):
        fpn += fh * fw * (cin * ch + 9 * ch * ch)
    return {"backbone": float(total), "fpn": float(fpn)}


def init_std(layer: str, shape) -> float | None:
    """The patch embedding He-normal scaled by 1/128 (the inputs are
    mean-subtracted, not normalized); the ViT's qkv, proj and fc2 at
    sqrt(1 / fan-in), so that each of the 12 blocks adds to the residual
    stream about as much as it holds; the deconvs He over the one tap an
    output takes (fan-in: their input channels)."""
    if layer == "vit_patch_embed":
        return math.sqrt(2.0 / math.prod(shape[:-1])) / 128.0
    if layer.startswith("vit_b") and not layer.endswith("fc1"):
        return math.sqrt(1.0 / shape[0])
    if "deconv" in layer:
        return math.sqrt(2.0 / shape[2])
    return None


def init_range(layer: str, weight: str, shape) -> tuple | None:
    if "norm" in layer:
        return LN_SCALE if weight == "scale" else LN_BIAS
    if weight == "table":
        return POS_RANGE
    if weight.startswith("rel_pos"):
        return REL_RANGE
    return None
