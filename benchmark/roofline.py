"""Operations and bytes: of the model per image, and of each kernel call.

Arithmetic only, from shapes (and, where the work depends on the data, from
the inputs a call received), against the published peaks of one H100 SXM.
A kernel's least time is the larger of its operations over the peak rate
and its bytes over the HBM rate; each input byte counts as read once and
each output byte as written once, whatever the kernel reads again. The
counts follow the algorithm, not its implementation, so a share reads the
same work whatever computes it. K1-K6 follow `chip_smoke.py`'s counts,
except that K5's output is the algorithm's (logits and deltas, 5 x
classes), not the kernel's padded lanes, and K6 counts the class's 1x1.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from benchmark.reference import backbones
from benchmark.reference import model as R

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, bf16 tensor-core FLOP/s,
# float32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

BF16, F32 = 2, 4


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """The least time the chip could take, in seconds."""
    return max(nbytes / HBM_BYTES_S, flops / peak)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# --------------------------------------------------------------------------
# Model multiply-adds per image (convolutions and matmuls)
# --------------------------------------------------------------------------

def topdown_fpn_macs(cfg, c_channels) -> float:
    """Matterport's FPN over C2..C5 of `c_channels` widths: the lateral
    1x1s and the 3x3 outputs P2..P5."""
    ch = cfg.fpn_channels
    return float(sum(fh * fw * (cin * ch + 9 * ch * ch)
                     for (fh, fw), cin in zip(cfg.feature_shapes[:4],
                                              c_channels)))


def model_macs(cfg) -> dict[str, float]:
    """MACs per image by part: backbone, fpn, rpn, classifier head over
    `max_proposals` ROIs, mask head over `max_detections` (every padded
    row is computed); the backbone and the neck by the backbone's file."""
    own = backbones.load(cfg.architecture).macs(cfg)
    ch = cfg.fpn_channels
    sizes = cfg.feature_shapes                       # P2..P6
    apl = len(cfg.anchor_ratios)
    rpn = sum(fh * fw * (9 * ch * 512 + 512 * 6 * apl) for fh, fw in sizes)
    nc, fc, p = cfg.num_classes, cfg.head_fc_dim, cfg.pool_size
    cls = cfg.max_proposals * (p * p * ch * fc + fc * fc + fc * 5 * nc)
    mp = cfg.mask_pool_size
    mask = cfg.max_detections * (mp * mp * (4 * 9 * ch * ch + 4 * ch * ch)
                                 + (2 * mp) ** 2 * ch)
    return {"backbone": float(own["backbone"]), "fpn": float(own["fpn"]),
            "rpn": float(rpn),
            "classifier_head": float(cls), "mask_head": float(mask)}


def model_flops_per_image(cfg) -> float:
    return 2.0 * sum(model_macs(cfg).values())


# --------------------------------------------------------------------------
# Kernel calls: (bytes, flops, peak) of one call
# --------------------------------------------------------------------------

def box_overlap_mask(a: torch.Tensor, b: torch.Tensor, t: float):
    """(N, 4) x (M, 4) -> IoU(a, b) > t, as `inter > t * union`; boxes
    with no area overlap nothing."""
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    iy = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp_min(0.0)
    ix = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp_min(0.0)
    inter = iy * ix
    union = area_a + area_b - inter
    return (inter > t * union) & (area_a > 0) & (area_b > 0)


def nms_tests(boxes, keep, cand, t, max_out) -> int:
    """IoU tests a sequential greedy makes on this data: each candidate up
    to the stop tests the keepers before it until the first that hits
    it (`chip_smoke.py::nms_work`)."""
    tests = 0
    for i in range(boxes.shape[0]):
        kidx = torch.nonzero(keep[i]).flatten()[:max_out]
        stop = (int(kidx[-1]) + 1 if kidx.numel() == max_out
                else boxes.shape[1])
        hits = box_overlap_mask(boxes[i, kidx], boxes[i, :stop], t)
        before = kidx[:, None] < torch.arange(stop, device=boxes.device)
        hits = hits & before
        first = torch.where(hits.any(0), hits.to(torch.int8).argmax(0) + 1,
                            before.sum(0))
        tests += int(first[cand[i, :stop]].sum())
    return tests


def nms_call(boxes, cand, keep, t, max_out) -> tuple[float, float, float]:
    """K1 on (B, N, 4) float32 boxes and (B, N) candidates: 20 float32
    operations an IoU test; boxes and flags read, flags written."""
    b, n = cand.shape
    nbytes = b * n * (4 * F32 + 1 + 1)
    return nbytes, 20.0 * nms_tests(boxes, keep, cand, t, max_out), F32_FLOPS


def distinct_cells(rois: torch.Tensor, crop: int, cfg) -> int:
    """Pyramid cells (image, level, y, x) the bilinear corners of every
    sample touch, for (B, N, 4) normalized ROIs."""
    b, n, _ = rois.shape
    r = rois.reshape(-1, 4).float()
    lvl, valid = R.roi_levels(r, (cfg.image_height, cfg.image_width),
                              cfg.roi_canonical_scale, 4)
    img = torch.arange(b * n, device=r.device) // n
    keys = []
    for li, (fh, fw) in enumerate(cfg.feature_shapes[:4]):
        sel = (lvl == li) & valid
        if not sel.any():
            continue
        rr = r[sel]
        y = R.crop_grid(rr[:, 0], rr[:, 2], torch.full_like(rr[:, 0], fh - 1.0),
                        crop)
        x = R.crop_grid(rr[:, 1], rr[:, 3], torch.full_like(rr[:, 0], fw - 1.0),
                        crop)
        ok = ((y >= 0) & (y <= fh - 1))[:, :, None] & \
             ((x >= 0) & (x <= fw - 1))[:, None, :]
        y0 = y.floor().clamp(0, fh - 1).long()
        x0 = x.floor().clamp(0, fw - 1).long()
        for yy in (y0, (y0 + 1).clamp(max=fh - 1)):
            for xx in (x0, (x0 + 1).clamp(max=fw - 1)):
                k = ((img[sel][:, None, None] * 4 + li) * fh
                     + yy[:, :, None]) * fw + xx[:, None, :]
                keys.append(k[ok])
    return int(torch.unique(torch.cat(keys)).numel()) if keys else 0


def _prep_bytes(m: int, crop: int) -> int:
    """Sample positions (ys, xs float32), level (int32) and valid flags."""
    return m * (2 * crop * F32 + 4 + 1)


def roi_align_call(rois, crop, cfg) -> tuple[float, float, float]:
    """K2 over (B, N, 4) ROIs: the touched cells read, (M, crop, crop, C)
    bf16 written, 10 float32 operations an output value."""
    m = rois.shape[0] * rois.shape[1]
    c = cfg.fpn_channels
    out = m * crop * crop * c
    nbytes = (distinct_cells(rois, crop, cfg) * c * BF16 + out * BF16
              + _prep_bytes(m, crop))
    return nbytes, 10.0 * out, F32_FLOPS


def classifier_head_call(rois, cfg) -> tuple[float, float, float]:
    """K5: the pool-7 pass and the head's three matmuls (pool x pool x C
    -> fc -> fc -> 5 x classes) for every ROI row, padded rows too."""
    m = rois.shape[0] * rois.shape[1]
    c, fc, p = cfg.fpn_channels, cfg.head_fc_dim, cfg.pool_size
    n3 = 5 * cfg.num_classes
    k1 = p * p * c
    weights = (k1 * fc + fc * fc + fc * n3) * BF16 + (fc + fc + n3) * F32
    nbytes = (weights + distinct_cells(rois, p, cfg) * c * BF16
              + m * n3 * F32 + _prep_bytes(m, p))
    return nbytes, 2.0 * m * (k1 * fc + fc * fc + fc * n3), BF16_FLOPS


def mask_head_call(boxes, cfg) -> tuple[float, float, float]:
    """K6: the pool-14 pass, four 3x3 convs, the 2x2/2 deconv and the
    class's 1x1 for every detection row."""
    m = boxes.shape[0] * boxes.shape[1]
    c, p = cfg.fpn_channels, cfg.mask_pool_size
    o = 2 * p
    weights = (4 * 9 * c * c + 4 * c * c) * BF16 + (4 * c + 4 * c) * F32 \
        + (cfg.num_classes * (c + 1)) * F32
    nbytes = (weights + distinct_cells(boxes, p, cfg) * c * BF16
              + m * o * o * F32 + m * 4 + _prep_bytes(m, p))
    flops = 2.0 * m * (p * p * (4 * 9 * c * c + 4 * c * c) + o * o * c)
    return nbytes, flops, BF16_FLOPS


def stem_call(b, cfg) -> tuple[float, float, float]:
    """K3: 7x7/2 conv + BN + ReLU + 3x3/2 max-pool; float32 images read,
    the pooled bf16 map written."""
    h, w = cfg.image_height, cfg.image_width
    nbytes = (b * h * w * 3 * F32 + 7 * 7 * 3 * 64 * BF16 + 64 * F32
              + b * ceil_div(h, 4) * ceil_div(w, 4) * 64 * BF16)
    flops = 2.0 * b * ceil_div(h, 2) * ceil_div(w, 2) * 64 * 147
    return nbytes, flops, BF16_FLOPS


def chain_call(b, cfg, chain) -> tuple[float, float, float]:
    """K4 on one chain of bottleneck blocks at the map's full size; a
    chain as the ResNet file's `CHAINS` gives it."""
    stride, cin, (f1, f2, f3), n, proj = chain
    hw = ceil_div(cfg.image_height, stride) * ceil_div(cfg.image_width, stride)
    flops = weights = 0.0
    c = cin
    for i in range(n):
        macs = c * f1 + 9 * f1 * f2 + f2 * f3
        wts = macs * BF16 + (f1 + f2 + f3) * F32
        if i == 0 and proj:
            macs += c * f3
            wts += c * f3 * BF16 + f3 * F32
        flops += 2.0 * b * hw * macs
        weights += wts
        c = f3
    nbytes = b * hw * (cin + f3) * BF16 + weights
    return nbytes, flops, BF16_FLOPS


def forward_work(cfg, forwards) -> dict[str, list]:
    """(bytes, flops, peak) of each port kernel call of the given forwards,
    (rois (B, R, 4), detection boxes (B, D, 4)) each, by kernel family;
    which kernels run follows the configuration (the backbone's own, by
    its file's `kernel_work`: K3/K4 on ResNet; K5/K6 where the heads are
    fused, else K2 for both pools). K1's calls are data-dependent:
    `nms_call` on what each call received."""
    kernel_work = getattr(backbones.load(cfg.architecture), "kernel_work",
                          None)
    work: dict[str, list] = defaultdict(list)
    for rois, boxes in forwards:
        if kernel_work is not None:
            for family, calls in kernel_work(cfg, rois.shape[0]).items():
                work[family] += calls
        if cfg.fuse_classifier_head:
            work["roi_classifier_head"].append(
                classifier_head_call(rois, cfg))
        else:
            work["roi_align"].append(roi_align_call(rois, cfg.pool_size, cfg))
        if cfg.fuse_mask_head:
            work["roi_mask_head"].append(mask_head_call(boxes, cfg))
        else:
            work["roi_align"].append(
                roi_align_call(boxes, cfg.mask_pool_size, cfg))
    return dict(work)


def family_share(measured, family: str):
    """A kernel family's share of its roofline in the traced window, in %:
    the least time of its calls over its device time; None where it did
    not run."""
    seconds = measured.trace.family_s.get(family, 0.0)
    calls = measured.work.get(family)
    if not seconds or not calls:
        return None
    return 100.0 * sum(bound_s(*c) for c in calls) / seconds


def mfu_percent(measured):
    """Model FLOPs of the measured window's images over its seconds, as a
    share of the bf16 peak; None where it completed none."""
    w = measured.window
    if not w["images"]:
        return None
    return (100.0 * model_flops_per_image(measured.cfg) * w["images"]
            / w["seconds"] / BF16_FLOPS)
