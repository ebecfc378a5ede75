"""Plain Mask R-CNN in PyTorch: the benchmark's reference.

A float32 forward of the published architectures (He et al.,
arXiv:1703.06870, in Matterport's Keras topology and layer names:
backbone and neck -> P2..P6 -> RPN -> proposals -> pyramid ROIAlign ->
classifier head -> detection refine -> mask head), with no kernel, no
fusion and no batching trick. Each backbone and its neck is a file of
`backbones/`, found by the configuration's `architecture`; this module
holds the layers they share, Matterport's top-down FPN among them, and
everything from the RPN on. It imports nothing of the system under test:
it reads the same raw parameter dict ({layer: {weight: tensor}}, kernels
HWIO, float32) that the benchmark hands the program, and applies
BatchNorm (eps 1e-3, moving statistics) itself.

`Numerics` picks the precision of every convolution and matmul operand:
float32 (TF32 off, the reference) or float8 e4m3 with one scale per
tensor and float32 sums (the control: the reference one step below the
configuration's bfloat16). Box arithmetic, BatchNorm, softmax and sigmoid
are float32 in both.

Departures from the published description, all shared with the
configuration the program runs:
  * TF "SAME" padding (the extra row/column on the right at stride 2), as
    Matterport's Keras model;
  * ROIAlign samples as `tf.image.crop_and_resize` (one sample per bin,
    bilinear, zero outside the level), Matterport's pyramid ROIAlign;
  * the mask head computes only the detected class's channel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import backbones

BN_EPS = 1e-3
FP8_MAX = 448.0     # largest finite float8 e4m3fn


class Numerics:
    """Operand precision of convolutions and matmuls."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"numerics must be float32 or fp8, got {kind}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind == "float32":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale


# --------------------------------------------------------------------------
# Parameter layout (names and shapes the benchmark makes weights for)
# --------------------------------------------------------------------------

def conv_shape(kh: int, kw: int, cin: int, cout: int) -> dict[str, tuple]:
    return {"kernel": (kh, kw, cin, cout), "bias": (cout,)}


def bn_shape(c: int) -> dict[str, tuple]:
    return {k: (c,) for k in ("gamma", "beta", "moving_mean",
                              "moving_variance")}


def topdown_fpn_shapes(cfg, c_channels) -> dict[str, dict[str, tuple]]:
    """Matterport's FPN over C2..C5 of `c_channels` widths."""
    shapes, ch = {}, cfg.fpn_channels
    for lvl, cin in zip((2, 3, 4, 5), c_channels):
        shapes[f"fpn_c{lvl}p{lvl}"] = conv_shape(1, 1, cin, ch)
        shapes[f"fpn_p{lvl}"] = conv_shape(3, 3, ch, ch)
    return shapes


def param_shapes(cfg) -> dict[str, dict[str, tuple]]:
    """{layer: {weight: shape}} of the whole model, Matterport names: the
    backbone file's layers (up to `fpn_p5`), then the RPN and the heads."""
    shapes = backbones.load(cfg.architecture).param_shapes(cfg)
    ch = cfg.fpn_channels
    apl = len(cfg.anchor_ratios)
    shapes["rpn_conv_shared"] = conv_shape(3, 3, ch, 512)
    shapes["rpn_class_raw"] = conv_shape(1, 1, 512, 2 * apl)
    shapes["rpn_bbox_pred"] = conv_shape(1, 1, 512, 4 * apl)
    nc, fc, p = cfg.num_classes, cfg.head_fc_dim, cfg.pool_size
    shapes["mrcnn_class_conv1"] = conv_shape(p, p, ch, fc)
    shapes["mrcnn_class_bn1"] = bn_shape(fc)
    shapes["mrcnn_class_conv2"] = conv_shape(1, 1, fc, fc)
    shapes["mrcnn_class_bn2"] = bn_shape(fc)
    shapes["mrcnn_class_logits"] = {"kernel": (fc, nc), "bias": (nc,)}
    shapes["mrcnn_bbox_fc"] = {"kernel": (fc, 4 * nc), "bias": (4 * nc,)}
    for i in range(1, 5):
        shapes[f"mrcnn_mask_conv{i}"] = conv_shape(3, 3, ch, ch)
        shapes[f"mrcnn_mask_bn{i}"] = bn_shape(ch)
    shapes["mrcnn_mask_deconv"] = conv_shape(2, 2, ch, ch)
    shapes["mrcnn_mask"] = conv_shape(1, 1, ch, nc)
    return shapes


# --------------------------------------------------------------------------
# Layers (NCHW float32 activations, HWIO kernels)
# --------------------------------------------------------------------------

def same(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, p, nx: Numerics, stride=1, padding="SAME", groups=1):
    k = p["kernel"]
    kh, kw = k.shape[0], k.shape[1]
    if padding == "SAME":
        (t, b), (l, r) = same(x.shape[2], kh, stride), same(x.shape[3], kw,
                                                            stride)
    elif padding == "VALID":
        t = b = l = r = 0
    else:
        t = b = l = r = padding
    x = F.pad(nx.q(x), (l, r, t, b))
    y = F.conv2d(x, nx.q(k.permute(3, 2, 0, 1)), stride=stride,
                 groups=groups)
    return y + p["bias"].float()[None, :, None, None]


def bn(x, p):
    scale = p["gamma"].float() * torch.rsqrt(p["moving_variance"].float()
                                             + BN_EPS)
    shift = p["beta"].float() - p["moving_mean"].float() * scale
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.reshape(shape) + shift.reshape(shape)


def dense(x, p, nx: Numerics):
    k = p["kernel"].reshape(-1, p["kernel"].shape[-1])
    return nx.q(x) @ nx.q(k) + p["bias"].float()


# --------------------------------------------------------------------------
# FPN, RPN
# --------------------------------------------------------------------------

def topdown_fpn(params, c_maps, nx):
    """Matterport's FPN: C2..C5 -> [P2, P3, P4, P5, P6]."""
    c2, c3, c4, c5 = c_maps
    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
    p5 = conv(c5, params["fpn_c5p5"], nx, padding="VALID")
    p4 = up(p5) + conv(c4, params["fpn_c4p4"], nx, padding="VALID")
    p3 = up(p4) + conv(c3, params["fpn_c3p3"], nx, padding="VALID")
    p2 = up(p3) + conv(c2, params["fpn_c2p2"], nx, padding="VALID")
    out = [conv(p, params[f"fpn_p{i}"], nx)
           for i, p in zip((2, 3, 4, 5), (p2, p3, p4, p5))]
    return out + [out[3][:, :, ::2, ::2]]


def backbone_fpn(params, images_u8, cfg, nx):
    """(B, H, W, 3) RGB [0, 255] canvases -> [P2, P3, P4, P5, P6] NCHW,
    by the configuration's backbone file."""
    mean = torch.tensor(cfg.mean_pixel, dtype=torch.float32,
                        device=images_u8.device)
    x = (images_u8.float() - mean).permute(0, 3, 1, 2)
    return backbones.load(cfg.architecture).pyramid(params, x, cfg, nx)


def rpn(params, pyramid, nx):
    """-> logits (B, A, 2), deltas (B, A, 4); per level row-major over
    (y, x, anchor), levels P2..P6 outer."""
    logits, deltas = [], []
    for f in pyramid:
        shared = torch.relu(conv(f, params["rpn_conv_shared"], nx))
        cls = conv(shared, params["rpn_class_raw"], nx, padding="VALID")
        box = conv(shared, params["rpn_bbox_pred"], nx, padding="VALID")
        b = f.shape[0]
        logits.append(cls.permute(0, 2, 3, 1).reshape(b, -1, 2))
        deltas.append(box.permute(0, 2, 3, 1).reshape(b, -1, 4))
    return torch.cat(logits, 1), torch.cat(deltas, 1)


# --------------------------------------------------------------------------
# Anchors and boxes
# --------------------------------------------------------------------------

def anchors(cfg, device) -> torch.Tensor:
    """(A, 4) normalized (y1, x1, y2, x2) anchors, float64 then float32;
    levels outer, then rows, columns, ratios."""
    out = []
    ratios = np.asarray(cfg.anchor_ratios, np.float64)
    for scale, (fh, fw), stride in zip(cfg.anchor_scales,
                                       cfg.feature_shapes,
                                       cfg.backbone_strides):
        hh, ww = scale / np.sqrt(ratios), scale * np.sqrt(ratios)
        ys = np.arange(0, fh, cfg.anchor_stride) * stride
        xs = np.arange(0, fw, cfg.anchor_stride) * stride
        cy, cx, h = np.meshgrid(ys, xs, hh, indexing="ij")
        _, _, w = np.meshgrid(ys, xs, ww, indexing="ij")
        out.append(np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                            -1).reshape(-1, 4))
    pix = np.concatenate(out)
    s = np.array([cfg.image_height - 1, cfg.image_width - 1] * 2, np.float64)
    norm = (pix - np.array([0.0, 0.0, 1.0, 1.0])) / s
    return torch.from_numpy(norm.astype(np.float32)).to(device)


def apply_deltas(boxes, deltas):
    y1, x1, y2, x2 = boxes.unbind(-1)
    dy, dx, dh, dw = deltas.unbind(-1)
    h, w = y2 - y1, x2 - x1
    cy, cx = y1 + 0.5 * h + dy * h, x1 + 0.5 * w + dx * w
    h, w = h * torch.exp(dh), w * torch.exp(dw)
    ny1, nx1 = cy - 0.5 * h, cx - 0.5 * w
    return torch.stack([ny1, nx1, ny1 + h, nx1 + w], -1)


def area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def greedy_nms(boxes: torch.Tensor, cand: torch.Tensor, threshold: float,
               max_out: int) -> list[int]:
    """Sequential greedy NMS over score-sorted (N, 4) boxes: a candidate
    with positive area is kept unless a kept box before it has IoU above
    the threshold; stops after `max_out`."""
    a = area(boxes)
    ok = cand & (a > 0)
    iy = (torch.minimum(boxes[:, None, 2], boxes[None, :, 2])
          - torch.maximum(boxes[:, None, 0], boxes[None, :, 0])).clamp_min(0)
    ix = (torch.minimum(boxes[:, None, 3], boxes[None, :, 3])
          - torch.maximum(boxes[:, None, 1], boxes[None, :, 1])).clamp_min(0)
    inter = iy * ix
    union = a[:, None] + a[None, :] - inter
    hits = ((inter > threshold * union) & ok[:, None] & ok[None, :]).cpu()
    ok = ok.cpu().numpy()
    hits = hits.numpy()
    suppressed = np.zeros(len(ok), bool)
    keep: list[int] = []
    for i in range(len(ok)):
        if not ok[i] or suppressed[i]:
            continue
        keep.append(i)
        if len(keep) == max_out:
            break
        suppressed |= hits[i]
    return keep


# --------------------------------------------------------------------------
# Pyramid ROIAlign (crop_and_resize sampling)
# --------------------------------------------------------------------------

def roi_levels(rois, image_hw, canonical_scale, n_levels):
    """Matterport's level of each ROI, relative to P2, and its validity
    (positive area): floor(log2(sqrt(hw) / (224 / sqrt(HW))) + 4 + 0.5),
    clamped to P2..P5."""
    a = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    ratio = canonical_scale / torch.sqrt(torch.tensor(
        float(image_hw[0]) * float(image_hw[1]), dtype=torch.float32,
        device=rois.device))
    lvl = 0.5 * torch.log2(a.clamp_min(1e-30)) - torch.log2(ratio) + 4.0
    lvl = torch.floor(lvl + 0.5).clamp(2, 2 + n_levels - 1).to(torch.int32)
    valid = a > 0.0
    return torch.where(valid, lvl - 2, torch.zeros_like(lvl)), valid


def crop_grid(lo, hi, extent, crop):
    """Sample positions of crop_and_resize along one axis: lo*(n-1) +
    i*(hi-lo)*(n-1)/(crop-1), the product and sum rounded once."""
    steps = torch.arange(crop, dtype=torch.float32, device=lo.device)
    recip = torch.ones((), dtype=torch.float32, device=lo.device) / (crop - 1)
    span = ((hi - lo) * extent) * recip
    return (steps[None].double() * span[:, None].double()
            + (lo * extent)[:, None].double()).float()


def roi_align(levels, rois, crop, cfg):
    """P2..P5 (B, C, H, W) + (B, N, 4) normalized ROIs -> (B, N, crop,
    crop, C) float32; zero-area ROIs give zeros."""
    b, n, _ = rois.shape
    r = rois.reshape(-1, 4).float()
    lvl, valid = roi_levels(r, (cfg.image_height, cfg.image_width),
                            cfg.roi_canonical_scale, len(levels))
    c = levels[0].shape[1]
    out = torch.zeros((b * n, crop, crop, c), dtype=torch.float32,
                      device=r.device)
    img = torch.arange(b * n, device=r.device) // n
    for li, f in enumerate(levels):
        sel = torch.nonzero((lvl == li) & valid).flatten()
        if sel.numel() == 0:
            continue
        fh, fw = f.shape[2], f.shape[3]
        ext_h = torch.full((sel.numel(),), fh - 1.0, device=r.device)
        ext_w = torch.full((sel.numel(),), fw - 1.0, device=r.device)
        ys = crop_grid(r[sel, 0], r[sel, 2], ext_h, crop)
        xs = crop_grid(r[sel, 1], r[sel, 3], ext_w, crop)
        y0, x0 = torch.floor(ys), torch.floor(xs)
        wy, wx = ys - y0, xs - x0
        y0i = y0.clamp(0, fh - 1).long()
        x0i = x0.clamp(0, fw - 1).long()
        y1i = (y0i + 1).clamp(max=fh - 1)
        x1i = (x0i + 1).clamp(max=fw - 1)
        wx = torch.where(x1i > x0i, wx, torch.zeros_like(wx))
        fn = f.permute(0, 2, 3, 1)
        bi = img[sel][:, None, None]

        def at(yi, xi):
            return fn[bi, yi[:, :, None], xi[:, None, :]]

        wxe, wye = wx[:, None, :, None], wy[:, :, None, None]
        top = at(y0i, x0i) * (1 - wxe) + at(y0i, x1i) * wxe
        bot = at(y1i, x0i) * (1 - wxe) + at(y1i, x1i) * wxe
        o = top * (1 - wye) + bot * wye
        inside = (((ys >= 0) & (ys <= fh - 1.0))[:, :, None]
                  & ((xs >= 0) & (xs <= fw - 1.0))[:, None, :])[..., None]
        out[sel] = torch.where(inside, o, torch.zeros_like(o))
    return out.reshape(b, n, crop, crop, c)


# --------------------------------------------------------------------------
# ROI heads
# --------------------------------------------------------------------------

def classifier_head(params, pooled, nx):
    """(N, p, p, C) -> logits (N, K), deltas (N, K, 4)."""
    n = pooled.shape[0]
    x = dense(pooled.reshape(n, -1), params["mrcnn_class_conv1"], nx)
    x = torch.relu(bn(x, params["mrcnn_class_bn1"]))
    x = dense(x, params["mrcnn_class_conv2"], nx)
    x = torch.relu(bn(x, params["mrcnn_class_bn2"]))
    logits = dense(x, params["mrcnn_class_logits"], nx)
    deltas = dense(x, params["mrcnn_bbox_fc"], nx).reshape(n, -1, 4)
    return logits, deltas


def mask_head(params, pooled, class_ids, nx):
    """(N, p, p, C) + (N,) class ids -> (N, 2p, 2p) sigmoid masks."""
    x = pooled.permute(0, 3, 1, 2)
    for i in range(1, 5):
        x = torch.relu(bn(conv(x, params[f"mrcnn_mask_conv{i}"], nx),
                          params[f"mrcnn_mask_bn{i}"]))
    k = params["mrcnn_mask_deconv"]
    x = F.conv_transpose2d(nx.q(x), nx.q(k["kernel"].permute(2, 3, 0, 1)),
                           stride=2) + k["bias"].float()[None, :, None, None]
    x = torch.relu(x)
    k = params["mrcnn_mask"]
    w = k["kernel"].reshape(k["kernel"].shape[-2], -1)[:, class_ids].T
    logits = torch.einsum("nchw,nc->nhw", nx.q(x), nx.q(w))
    return torch.sigmoid(logits + k["bias"].float()[class_ids][:, None, None])


# --------------------------------------------------------------------------
# Mask paste (normalized canvas boxes -> full-resolution masks)
# --------------------------------------------------------------------------

def paste_soft(masks, boxes, size):
    """(D, m, m) soft masks + (D, 4) normalized boxes -> (D, S, S) values
    sampled bilinearly at pixel centers (i + 0.5) / S, zero outside each
    box."""
    m = masks.shape[-1]
    centers = (torch.arange(size, dtype=torch.float32,
                            device=masks.device) + 0.5) / size
    y1, x1, y2, x2 = boxes.float().unbind(-1)
    h = torch.clamp(y2 - y1, min=1e-8)
    w = torch.clamp(x2 - x1, min=1e-8)

    def interp(coords, inside):
        c0 = torch.clamp(torch.floor(coords), 0, m - 1)
        frac = torch.clamp(coords - c0, 0.0, 1.0)
        c0 = c0.long()
        c1 = torch.clamp(c0 + 1, max=m - 1)
        j = torch.arange(m, device=coords.device)
        wt = ((j == c0[..., None]) * (1 - frac)[..., None]
              + (j == c1[..., None]) * frac[..., None])
        return wt * inside[..., None].float()

    my = (centers - y1[:, None]) / h[:, None] * m - 0.5
    mx = (centers - x1[:, None]) / w[:, None] * m - 0.5
    wy = interp(my, (centers >= y1[:, None]) & (centers <= y2[:, None]))
    wx = interp(mx, (centers >= x1[:, None]) & (centers <= x2[:, None]))
    return (wy @ masks.float()) @ wx.transpose(-1, -2)


# --------------------------------------------------------------------------
# The whole inference pipeline (the control runs it in the program's place)
# --------------------------------------------------------------------------

def detect(params, images_u8, cfg, nx: Numerics, paste_size=None) -> dict:
    """The program's output contract from the reference alone: rois
    (B, R, 4), roi_valid, detections (B, D, 6), valid, masks (B, D, m, m),
    with `paste_size` pasted (B, D, S, S) uint8."""
    dev = images_u8.device
    pyramid = backbone_fpn(params, images_u8, cfg, nx)
    logits, deltas = rpn(params, pyramid, nx)
    std = torch.tensor(cfg.bbox_std_dev, dtype=torch.float32, device=dev)
    anc = anchors(cfg, dev)
    b, r, d = images_u8.shape[0], cfg.max_proposals, cfg.max_detections
    rois = torch.zeros((b, r, 4), device=dev)
    roi_valid = torch.zeros((b, r), dtype=torch.bool, device=dev)
    for i in range(b):
        fg = logits[i, :, 1] - logits[i, :, 0]
        top = torch.sort(fg, descending=True, stable=True).indices[
            :cfg.pre_nms_max_proposals]
        boxes = apply_deltas(anc[top], deltas[i, top] * std).clamp(0.0, 1.0)
        keep = greedy_nms(boxes, torch.ones_like(top, dtype=torch.bool),
                          cfg.proposal_nms_threshold, r)
        rois[i, :len(keep)] = boxes[keep]
        roi_valid[i, :len(keep)] = True
    pooled = roi_align(pyramid[:4], rois, cfg.pool_size, cfg)
    cls_logits, cls_deltas = classifier_head(
        params, pooled.reshape((b * r,) + pooled.shape[2:]), nx)
    probs = torch.softmax(cls_logits, -1).reshape(b, r, -1)
    cls_deltas = cls_deltas.reshape(b, r, -1, 4)
    dets = torch.zeros((b, d, 6), device=dev)
    valid = torch.zeros((b, d), dtype=torch.bool, device=dev)
    for i in range(b):
        cid = probs[i].argmax(-1)
        score = probs[i].amax(-1)
        dl = cls_deltas[i, torch.arange(r, device=dev), cid]
        refined = apply_deltas(rois[i], dl * std).clamp(0.0, 1.0)
        cand = (score >= cfg.detection_score_threshold) & (cid > 0) & (
            area(rois[i]) > 0)
        order = torch.argsort(-score, stable=True)
        shifted = refined[order] + cid[order].float()[:, None] * 2.0
        keep = order[greedy_nms(shifted, cand[order],
                                cfg.detection_nms_threshold, d)]
        n = keep.numel()
        dets[i, :n] = torch.cat([refined[keep], cid[keep, None].float(),
                                 score[keep, None]], -1)
        valid[i, :n] = True
    mpool = roi_align(pyramid[:4], dets[..., :4], cfg.mask_pool_size, cfg)
    masks = mask_head(params, mpool.reshape((b * d,) + mpool.shape[2:]),
                      dets[..., 4].reshape(-1).long(), nx)
    masks = masks.reshape(b, d, cfg.mask_size, cfg.mask_size) * \
        valid[..., None, None]
    out = {"rois": rois, "roi_valid": roi_valid, "detections": dets,
           "valid": valid, "masks": masks}
    if paste_size is not None:
        out["pasted"] = torch.stack([
            ((paste_soft(masks[i], dets[i, :, :4], paste_size) >= 0.5)
             & valid[i, :, None, None]).to(torch.uint8) for i in range(b)])
    return out
