"""Pyramid ROIAlign and the two ROI heads fused behind it: the CUDA kernels
K2 (`csrc/roi_align.cu`), K5 (`csrc/roi_classifier_head.cu`) and K6
(`csrc/roi_mask_head.cu`), each beside its plain PyTorch version. They
replace the three modes of
`maskrcnn_tpu/ops/roi_align_pallas.py::pyramid_roi_align_pallas`: plain,
with `head_params`, and with `mask_params` + `class_ids`.

Contract of the pool (all versions): P2..P5 levels (B, H_l, W_l, C), per-ROI
sample positions ys/xs (M, P) on the ROI's level (from `roi_align.prepare`),
the level (M,) int32 and valid (M,) flags, M = B * rois_per_image ->
(M, P, P, C) in the features' dtype. Corners are clamped to the level,
blended in float32 (x first, then y), samples out of range and invalid ROIs
give 0.

K5 and K6 pool exactly so and feed the pooled values, rounded to the
features' dtype, to the head; they return only the head's output (the TPU
kernel also returned the pool, which the forward drops). Both write the
pool once to a scratch tile (K2's kernel, inside their launch functions)
and read it back by TMA into the GEMM tile they share
(`csrc/head_gemm.cuh`); K6 then runs its head layer by layer over all
ROIs. Invalid ROIs pool to zero rows and still go through the head, as in
the TPU kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.ops import cuda_lib
from maskrcnn_tpu_torch.ops.common import graph_vjp

HEAD_OUT = 512  # K5 output lanes: logits [0, nc), deltas [128, 128 + 4 nc)
MASK_CHANNELS = 256  # K6 is built for the mask head's width and pool 14
MASK_POOL = 14


# --------------------------------------------------------------------------
# K2: the pool
# --------------------------------------------------------------------------

def roi_align_plain(features: Sequence[torch.Tensor], ys: torch.Tensor,
                    xs: torch.Tensor, level: torch.Tensor,
                    valid: torch.Tensor, rois_per_image: int) -> torch.Tensor:
    m, p = ys.shape
    c = features[0].shape[-1]
    out = torch.zeros((m, p, p, c), dtype=torch.float32, device=ys.device)
    img = torch.arange(m, device=ys.device) // rois_per_image
    for li, f in enumerate(features):
        sel = torch.nonzero((level == li) & valid).flatten()
        if sel.numel() == 0:
            continue
        fh, fw = f.shape[1], f.shape[2]
        y, x = ys[sel], xs[sel]
        y_in = (y >= 0.0) & (y <= fh - 1.0)
        x_in = (x >= 0.0) & (x <= fw - 1.0)
        y0, x0 = torch.floor(y), torch.floor(x)
        wy, wx = y - y0, x - x0
        y0i = y0.clamp(0, fh - 1).to(torch.int64)
        x0i = x0.clamp(0, fw - 1).to(torch.int64)
        y1i = (y0i + 1).clamp(max=fh - 1)
        x1i = (x0i + 1).clamp(max=fw - 1)
        # At the right edge both x corners are the same cell; its weight
        # is exactly zero there (clipped sampling has floor(x) == x).
        wx = torch.where(x1i > x0i, wx, torch.zeros_like(wx))
        bi = img[sel][:, None, None]

        def corner(yi, xi):
            return f[bi, yi[:, :, None], xi[:, None, :]].to(torch.float32)

        wxe = wx[:, None, :, None]
        wye = wy[:, :, None, None]
        top = corner(y0i, x0i) * (1.0 - wxe) + corner(y0i, x1i) * wxe
        bot = corner(y1i, x0i) * (1.0 - wxe) + corner(y1i, x1i) * wxe
        o = top * (1.0 - wye) + bot * wye
        inside = (y_in[:, :, None] & x_in[:, None, :])[..., None]
        out[sel] = torch.where(inside, o, torch.zeros_like(o))
    return out.to(features[0].dtype)


def _pool_args(features: Sequence[torch.Tensor], ys: torch.Tensor,
               xs: torch.Tensor, level: torch.Tensor, valid: torch.Tensor,
               rois_per_image: int, dtypes: tuple) -> list:
    """Check the pool's inputs for a kernel; the C arguments they become:
    four level pointers, their (H, W), C, ys, xs, level, valid, M,
    rois_per_image, P."""
    if len(features) != 4:
        raise ValueError(f"ROIAlign kernels take 4 levels, got "
                         f"{len(features)}")
    m, p = ys.shape
    bsz, _, _, c = features[0].shape
    dtype = features[0].dtype
    if dtype not in dtypes:
        raise ValueError(f"kernel takes features in {dtypes}, got {dtype}")
    if c % 2:
        raise ValueError(f"kernel needs an even channel count, got {c}")
    if m != bsz * rois_per_image:
        raise ValueError(f"{m} ROIs for {bsz} images x {rois_per_image}")
    for i, f in enumerate(features):
        cuda_lib.require(f, f"features[{i}]", dtype,
                         (bsz, f.shape[1], f.shape[2], c))
    cuda_lib.require(ys, "ys", torch.float32, (m, p))
    cuda_lib.require(xs, "xs", torch.float32, (m, p))
    cuda_lib.require(level, "level", torch.int32, (m,))
    cuda_lib.require(valid, "valid", torch.bool, (m,))
    dims = [d for f in features for d in (f.shape[1], f.shape[2])]
    return [*[f.data_ptr() for f in features], *dims, c, ys.data_ptr(),
            xs.data_ptr(), level.data_ptr(), valid.data_ptr(), m,
            rois_per_image, p]


def roi_align_cuda(features: Sequence[torch.Tensor], ys: torch.Tensor,
                   xs: torch.Tensor, level: torch.Tensor,
                   valid: torch.Tensor, rois_per_image: int) -> torch.Tensor:
    args = _pool_args(features, ys, xs, level, valid, rois_per_image,
                      (torch.bfloat16, torch.float32))
    m, p = ys.shape
    dtype, c = features[0].dtype, features[0].shape[-1]
    lib = cuda_lib.load()
    out = torch.empty((m, p, p, c), dtype=dtype, device=ys.device)
    with torch.cuda.device(ys.device):
        rc = lib.mrt_roi_align(*args, 1 if dtype == torch.bfloat16 else 0,
                               out.data_ptr(), cuda_lib.stream_ptr(ys))
    cuda_lib.check(rc, "roi_align")
    cuda_lib.launches["roi_align"] += 1
    return out


@torch.library.custom_op("maskrcnn_tpu_torch::roi_align", mutates_args=(),
                         device_types="cpu")
def _roi_align_op(features: list[torch.Tensor], ys: torch.Tensor,
                  xs: torch.Tensor, level: torch.Tensor, valid: torch.Tensor,
                  rois_per_image: int) -> torch.Tensor:
    return roi_align_plain(features, ys, xs, level, valid, rois_per_image)


_roi_align_op.register_kernel("cuda")(roi_align_cuda)


@_roi_align_op.register_fake
def _(features, ys, xs, level, valid, rois_per_image):
    m, p = ys.shape
    return ys.new_empty((m, p, p, features[0].shape[-1]),
                        dtype=features[0].dtype)


def roi_align(features: Sequence[torch.Tensor], ys: torch.Tensor,
              xs: torch.Tensor, level: torch.Tensor, valid: torch.Tensor,
              rois_per_image: int) -> torch.Tensor:
    """The op `maskrcnn_tpu_torch::roi_align`: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    return _roi_align_op([f.contiguous() for f in features], ys, xs, level,
                         valid, int(rois_per_image))


class RoiAlignDiff(torch.autograd.Function):
    """K2 under autograd (training pools the sampled ROIs): forward
    `roi_align` (the kernel on CUDA tensors, the plain version on CPU
    ones), backward the vjp of `roi_align_plain` on the features at the
    same positions, recomputed; no backward kernel yet. The positions
    carry no gradient (the sampled ROIs are detached). Takes (ys, xs,
    level, valid, rois_per_image, *features)."""

    @staticmethod
    def forward(ctx, ys, xs, level, valid, rois_per_image, *features):
        ctx.rois_per_image = rois_per_image
        ctx.save_for_backward(ys, xs, level, valid, *features)
        return roi_align(features, ys, xs, level, valid, rois_per_image)

    @staticmethod
    def backward(ctx, grad):
        ys, xs, level, valid, *features = ctx.saved_tensors

        def graph(*feats):
            return roi_align_plain(feats, ys, xs, level, valid,
                                   ctx.rois_per_image)

        grads = graph_vjp(graph, features, ctx.needs_input_grad[5:], grad)
        return (None,) * 5 + grads


# --------------------------------------------------------------------------
# K5: pool 7 + classifier head
# --------------------------------------------------------------------------

def _bn_scale(bn: dict, eps: float = 1e-3) -> torch.Tensor:
    return bn["gamma"].float() * torch.rsqrt(bn["moving_variance"].float()
                                             + eps)


def pack_classifier_head(params: dict, num_classes: int,
                         dtype: torch.dtype = torch.bfloat16) -> dict:
    """The classifier head folded into three matrices, as
    `roi_align_pallas.pack_classifier_head`: inference BN folds into the
    dense before it, W = (W * s) in `dtype`, b = (bias - mean) * s + beta in
    float32, s = gamma * rsqrt(var + 1e-3); logits and box deltas pack into
    one (fc, HEAD_OUT) matrix, logits in columns [0, nc), deltas in
    [128, 128 + 4 nc), the rest zero."""

    def fold(kernel, bias, bn):
        s = _bn_scale(bn)
        w = kernel.float() * s[None, :]
        b = (bias.float() - bn["moving_mean"].float()) * s + bn["beta"].float()
        return w.to(dtype), b[None, :]

    k1 = params["mrcnn_class_conv1"]
    w1, b1 = fold(k1["kernel"].reshape(-1, k1["kernel"].shape[-1]),
                  k1["bias"], params["mrcnn_class_bn1"])
    k2 = params["mrcnn_class_conv2"]
    w2, b2 = fold(k2["kernel"].reshape(k2["kernel"].shape[-2],
                                       k2["kernel"].shape[-1]),
                  k2["bias"], params["mrcnn_class_bn2"])
    nd = 4 * num_classes
    if num_classes > 128 or 128 + nd > HEAD_OUT:
        raise ValueError(f"{num_classes} classes do not fit {HEAD_OUT} lanes")
    logits, bbox = params["mrcnn_class_logits"], params["mrcnn_bbox_fc"]
    dev = logits["kernel"].device
    w3 = torch.zeros((logits["kernel"].shape[0], HEAD_OUT),
                     dtype=torch.float32, device=dev)
    w3[:, :num_classes] = logits["kernel"].float()
    w3[:, 128:128 + nd] = bbox["kernel"].float()
    b3 = torch.zeros((HEAD_OUT,), dtype=torch.float32, device=dev)
    b3[:num_classes] = logits["bias"].float()
    b3[128:128 + nd] = bbox["bias"].float()
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3.to(dtype),
            "b3": b3[None, :]}


def unpack_classifier_head(head_out: torch.Tensor, num_classes: int):
    """(M, HEAD_OUT) float32 rows -> probs (M, nc), deltas (M, nc, 4),
    logits (M, nc)."""
    logits = head_out[:, :num_classes]
    deltas = head_out[:, 128:128 + 4 * num_classes]
    return (torch.softmax(logits, dim=-1), deltas.reshape(-1, num_classes, 4),
            logits)


def _classifier_head_plain(features: Sequence[torch.Tensor],
                           ys: torch.Tensor, xs: torch.Tensor,
                           level: torch.Tensor, valid: torch.Tensor,
                           rois_per_image: int, head: dict,
                           acc_dtype: torch.dtype = torch.float32):
    """`classifier_head_plain` -> (h1 (M, N1) in the features' dtype, out)."""
    pooled = roi_align_plain(features, ys, xs, level, valid, rois_per_image)
    dt, f = pooled.dtype, acc_dtype
    h = pooled.reshape(pooled.shape[0], -1).to(f)
    h1 = torch.relu(h @ head["w1"].to(f) + head["b1"]).to(dt)
    h = torch.relu(h1.to(f) @ head["w2"].to(f) + head["b2"]).to(dt).to(f)
    return h1, h @ head["w3"].to(f) + head["b3"]


def classifier_head_plain(features: Sequence[torch.Tensor], ys: torch.Tensor,
                          xs: torch.Tensor, level: torch.Tensor,
                          valid: torch.Tensor, rois_per_image: int,
                          head: dict,
                          acc_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """(M, HEAD_OUT) float32: h1 = relu(pool @ w1 + b1), h2 = relu(h1 @ w2
    + b2), each rounded to the features' dtype, out = h2 @ w3 + b3;
    products of the rounded values, float32 sums (the TPU kernel's
    rounding points). `acc_dtype` torch.float64 keeps those roundings and
    sums in float64 (out in float64): a reference whose only rounding is
    the scheme's (`tools/kernel_bias.py`)."""
    return _classifier_head_plain(features, ys, xs, level, valid,
                                  rois_per_image, head, acc_dtype)[1]


# K5's GEMM tiles (`csrc/roi_classifier_head.cu`): 128 rows x 256 columns
# a block, K in chunks of 64 through a 4-stage ring of A + B tiles.
HEAD_BM, HEAD_BN, HEAD_BK, HEAD_STAGES = 128, 256, 64, 4
# the ring (aligned to 1 KB) and its barriers: `csrc/head_gemm.cuh` kGemmSmem
HEAD_SMEM = 1024 + HEAD_STAGES * (HEAD_BM + HEAD_BN) * HEAD_BK * 2 \
    + 16 * HEAD_STAGES
SMEM_PER_BLOCK = 232448  # H100: the most dynamic shared memory a block has


def classifier_head_plan(m: int, k1: int, n1: int, sms: int = 132) -> dict:
    """Launch plan of K5's dense 1 (pooled (m, k1) @ W1 (k1, n1)): output
    tiles, the split of its k1 / 64 K chunks into groups (each group a grid
    layer of blocks writing float32 partial sums, added in group order
    after), and the shared memory a block takes. Groups are added until the
    blocks fill the SMs once (at most 4): 2 at M = 2000 (64 tiles, 128
    blocks)."""
    rows = -(-m // HEAD_BM)
    tiles = rows * (n1 // HEAD_BN)
    chunks = k1 // HEAD_BK
    split = max(1, min(4, chunks, sms // max(tiles, 1)))
    groups = [(g * chunks // split, (g + 1) * chunks // split)
              for g in range(split)]
    return {"rows": rows * HEAD_BM, "grid": (rows, n1 // HEAD_BN, split),
            "split": split, "chunks": chunks, "groups": groups,
            "smem_bytes": HEAD_SMEM}


def _classifier_head_cuda(features: Sequence[torch.Tensor],
                          ys: torch.Tensor, xs: torch.Tensor,
                          level: torch.Tensor, valid: torch.Tensor,
                          rois_per_image: int, head: dict):
    """The kernel's launch -> (h1, out): its dense-1 scratch (M, N1) bf16
    beside the (M, HEAD_OUT) float32 rows (`tools/kernel_bias.py` reads
    the 12544-deep sum there)."""
    args = _pool_args(features, ys, xs, level, valid, rois_per_image,
                      (torch.bfloat16,))
    m, p = ys.shape
    c = features[0].shape[-1]
    k1, n1 = head["w1"].shape
    n2, n3 = head["w2"].shape[1], head["w3"].shape[1]
    if k1 != p * p * c or k1 % HEAD_BK or n1 % HEAD_BN or n2 % HEAD_BN \
            or n3 % HEAD_BN:
        raise ValueError(f"classifier head kernel does not take C={c}, "
                         f"pool {p}, widths {k1}->{n1}->{n2}->{n3}")
    shapes = {"w1": (k1, n1), "w2": (n1, n2), "w3": (n2, n3)}
    for k, shape in shapes.items():
        cuda_lib.require(head[k], k, torch.bfloat16, shape)
        cuda_lib.require(head["b" + k[1]], "b" + k[1], torch.float32,
                         (1, shape[1]))
    dev = ys.device
    plan = classifier_head_plan(
        m, k1, n1,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    rows = plan["rows"]
    pooled = torch.empty((m, k1), dtype=torch.bfloat16, device=dev)
    part = torch.empty((plan["split"], rows, n1), dtype=torch.float32,
                       device=dev)
    h1 = torch.empty((rows, n1), dtype=torch.bfloat16, device=dev)
    h2 = torch.empty((rows, n2), dtype=torch.bfloat16, device=dev)
    out = torch.empty((rows, n3), dtype=torch.float32, device=dev)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        rc = lib.mrt_roi_classifier_head(
            *args, head["w1"].data_ptr(), head["b1"].data_ptr(), n1,
            head["w2"].data_ptr(), head["b2"].data_ptr(), n2,
            head["w3"].data_ptr(), head["b3"].data_ptr(), n3, plan["split"],
            pooled.data_ptr(), part.data_ptr(), h1.data_ptr(),
            h2.data_ptr(), out.data_ptr(), cuda_lib.stream_ptr(ys))
    cuda_lib.check(rc, "roi_classifier_head")
    cuda_lib.launches["roi_classifier_head"] += 1
    return h1[:m], out[:m]


def classifier_head_cuda(features: Sequence[torch.Tensor], ys: torch.Tensor,
                         xs: torch.Tensor, level: torch.Tensor,
                         valid: torch.Tensor, rois_per_image: int,
                         head: dict) -> torch.Tensor:
    return _classifier_head_cuda(features, ys, xs, level, valid,
                                 rois_per_image, head)[1]


HEAD_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


@torch.library.custom_op("maskrcnn_tpu_torch::roi_classifier_head",
                         mutates_args=(), device_types="cpu")
def _classifier_head_op(features: list[torch.Tensor], ys: torch.Tensor,
                        xs: torch.Tensor, level: torch.Tensor,
                        valid: torch.Tensor, rois_per_image: int,
                        head: list[torch.Tensor]) -> torch.Tensor:
    return classifier_head_plain(features, ys, xs, level, valid,
                                 rois_per_image, dict(zip(HEAD_KEYS, head)))


@_classifier_head_op.register_kernel("cuda")
def _(features, ys, xs, level, valid, rois_per_image, head):
    return classifier_head_cuda(features, ys, xs, level, valid,
                                rois_per_image, dict(zip(HEAD_KEYS, head)))


@_classifier_head_op.register_fake
def _(features, ys, xs, level, valid, rois_per_image, head):
    return ys.new_empty((ys.shape[0], head[4].shape[1]), dtype=torch.float32)


def roi_classifier_head(features: Sequence[torch.Tensor], ys: torch.Tensor,
                        xs: torch.Tensor, level: torch.Tensor,
                        valid: torch.Tensor, rois_per_image: int,
                        head: dict) -> torch.Tensor:
    """The op `maskrcnn_tpu_torch::roi_classifier_head`: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    return _classifier_head_op([f.contiguous() for f in features], ys, xs,
                               level, valid, int(rois_per_image),
                               [head[k] for k in HEAD_KEYS])


# --------------------------------------------------------------------------
# K6: pool 14 + mask head with the per-class select
# --------------------------------------------------------------------------

def pack_mask_head(params: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The mask head folded as `roi_align_pallas.pack_mask_head`: each 3x3
    conv as a (9C, C) im2col matrix W * s in `dtype` with bias b * s +
    (beta - mean * s) in float32, the 2x2/2 deconv as one (C, 4C) matrix
    whose column groups ab = 2a + b are the output parities, and the 1x1
    class kernel as (nc, C) rows, float32."""

    def fold(conv, bn):
        s = _bn_scale(bn)
        t = bn["beta"].float() - bn["moving_mean"].float() * s
        return conv["kernel"].float() * s, conv["bias"].float() * s + t

    wconv, bconv = [], []
    for i in range(1, 5):
        k, b = fold(params[f"mrcnn_mask_conv{i}"], params[f"mrcnn_mask_bn{i}"])
        wconv.append(k.reshape(9 * k.shape[2], k.shape[3]))
        bconv.append(b)
    c = wconv[0].shape[1]
    kd = params["mrcnn_mask_deconv"]["kernel"].float()
    wdec = torch.cat([kd[a, b] for a in range(2) for b in range(2)], dim=1)
    bdec = params["mrcnn_mask_deconv"]["bias"].float().repeat(4)[None, :]
    km = params["mrcnn_mask"]
    return {"wconv": torch.stack(wconv).to(dtype),
            "bconv": torch.stack(bconv),
            "wdec": wdec.to(dtype), "bdec": bdec,
            "kcls": km["kernel"].float().reshape(c, -1).t().contiguous(),
            "bcls": km["bias"].float()}


def _mask_head_plain(features: Sequence[torch.Tensor], ys: torch.Tensor,
                     xs: torch.Tensor, level: torch.Tensor,
                     valid: torch.Tensor, rois_per_image: int, mask: dict,
                     class_ids: torch.Tensor,
                     acc_dtype: torch.dtype = torch.float32):
    """`mask_head_plain` -> (the four conv outputs (M, P, P, C) in the
    features' dtype, the masks)."""
    pooled = roi_align_plain(features, ys, xs, level, valid, rois_per_image)
    m, p, _, c = pooled.shape
    dt, f = pooled.dtype, acc_dtype
    x, acts = pooled.to(f), []
    for k in range(4):
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        patches = torch.cat([xp[:, dy:dy + p, dx:dx + p]
                             for dy in range(3) for dx in range(3)], dim=-1)
        acts.append(torch.relu(patches @ mask["wconv"][k].to(f)
                               + mask["bconv"][k]).to(dt))
        x = acts[-1].to(f)
    z = torch.relu(x @ mask["wdec"].to(f) + mask["bdec"])
    ids = class_ids.to(torch.int64)
    w = mask["kcls"][ids].to(dt).to(f)
    logits = torch.einsum("myxqc,mc->myxq", z.reshape(m, p, p, 4, c), w)
    sig = torch.sigmoid(logits + mask["bcls"][ids][:, None, None, None])
    return acts, sig.reshape(m, p, p, 2, 2).permute(0, 1, 3, 2, 4).reshape(
        m, 2 * p, 2 * p)


def mask_head_plain(features: Sequence[torch.Tensor], ys: torch.Tensor,
                    xs: torch.Tensor, level: torch.Tensor,
                    valid: torch.Tensor, rois_per_image: int, mask: dict,
                    class_ids: torch.Tensor,
                    acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M, 2P, 2P) float32 sigmoid masks of each ROI's class: four times
    a = relu(conv3x3_SAME(a) @ W + b) rounded to the features' dtype, then
    z = relu(a @ wdec + bdec) in float32, logit = z . kcls[class] (the class
    row rounded to the features' dtype) + bcls[class], and
    mask[2y + a, 2x + b] = sigmoid(logit of parity 2a + b at (y, x)).
    `acc_dtype` torch.float64 keeps the roundings to the features' dtype
    and computes the rest in float64 (masks in float64)."""
    return _mask_head_plain(features, ys, xs, level, valid, rois_per_image,
                            mask, class_ids, acc_dtype)[1]


def mask_head_plan(m: int) -> dict:
    """Launch plan of K6's layer kernels (`csrc/roi_mask_head.cu`) over m
    ROIs, which `mask_head_cuda` hands to the kernel: block b of a conv
    launch (and of each of the deconv's 4 parity columns) computes output
    positions [128 b, 128 b + 128) of the m x 14 x 14 grid taken in order
    (roi, y, x), `origins[b]` = the (roi, y, x) of its first; positions past
    m x 196 are dropped. K is 9 taps x 256 channels in chunks of 64 for a
    conv, 256 channels for the deconv. The kernel refuses a plan whose
    tiles do not cover the positions once or whose chunks do not match
    those K."""
    rows = m * MASK_POOL ** 2
    tiles = -(-rows // HEAD_BM)
    origins = [(p // MASK_POOL ** 2, p % MASK_POOL ** 2 // MASK_POOL,
                p % MASK_POOL) for p in range(0, tiles * HEAD_BM, HEAD_BM)]
    return {"rows": rows, "tile_rows": HEAD_BM, "origins": origins,
            "conv_grid": (tiles,), "deconv_grid": (tiles, 4),
            "conv_chunks": 9 * MASK_CHANNELS // HEAD_BK,
            "deconv_chunks": MASK_CHANNELS // HEAD_BK,
            "padding": tiles * HEAD_BM / max(rows, 1),
            "smem_bytes": HEAD_SMEM}


def _mask_head_cuda(features: Sequence[torch.Tensor], ys: torch.Tensor,
                    xs: torch.Tensor, level: torch.Tensor,
                    valid: torch.Tensor, rois_per_image: int, mask: dict,
                    class_ids: torch.Tensor):
    """The kernel's launch -> ((conv 3, conv 4) outputs, masks): the two
    activation buffers beside the (M, 2P, 2P) masks (the pool and conv 1-2
    are overwritten by then; `tools/kernel_bias.py` reads them)."""
    args = _pool_args(features, ys, xs, level, valid, rois_per_image,
                      (torch.bfloat16,))
    m, p = ys.shape
    c = features[0].shape[-1]
    if c != MASK_CHANNELS or p != MASK_POOL:
        raise ValueError(f"mask head kernel takes C={MASK_CHANNELS} at pool "
                         f"{MASK_POOL}, got C={c} at pool {p}")
    nc = mask["kcls"].shape[0]
    cuda_lib.require(mask["wconv"], "wconv", torch.bfloat16, (4, 9 * c, c))
    cuda_lib.require(mask["bconv"], "bconv", torch.float32, (4, c))
    cuda_lib.require(mask["wdec"], "wdec", torch.bfloat16, (c, 4 * c))
    cuda_lib.require(mask["bdec"], "bdec", torch.float32, (1, 4 * c))
    cuda_lib.require(mask["kcls"], "kcls", torch.float32, (nc, c))
    cuda_lib.require(mask["bcls"], "bcls", torch.float32, (nc,))
    ids = class_ids.reshape(m).to(torch.int32).contiguous()
    cuda_lib.require(ids, "class_ids", torch.int32, (m,))
    dev = ys.device
    # the pool, then the conv activations ping-pong between the two
    act = [torch.empty((m, p, p, c), dtype=torch.bfloat16, device=dev)
           for _ in range(2)]
    out = torch.empty((m, 2 * p, 2 * p), dtype=torch.float32, device=dev)
    plan = mask_head_plan(m)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        rc = lib.mrt_roi_mask_head(
            *args, mask["wconv"].data_ptr(), mask["bconv"].data_ptr(),
            mask["wdec"].data_ptr(), mask["bdec"].data_ptr(),
            mask["kcls"].data_ptr(), mask["bcls"].data_ptr(), ids.data_ptr(),
            nc, plan["conv_grid"][0], plan["conv_chunks"],
            plan["deconv_chunks"], act[0].data_ptr(), act[1].data_ptr(),
            out.data_ptr(), cuda_lib.stream_ptr(ys))
    cuda_lib.check(rc, "roi_mask_head")
    cuda_lib.launches["roi_mask_head"] += 1
    # the pool lands in act[0], conv k (1-4) in act[k % 2]
    return (act[1], act[0]), out


def mask_head_cuda(features: Sequence[torch.Tensor], ys: torch.Tensor,
                   xs: torch.Tensor, level: torch.Tensor,
                   valid: torch.Tensor, rois_per_image: int, mask: dict,
                   class_ids: torch.Tensor) -> torch.Tensor:
    return _mask_head_cuda(features, ys, xs, level, valid, rois_per_image,
                           mask, class_ids)[1]


MASK_KEYS = ("wconv", "bconv", "wdec", "bdec", "kcls", "bcls")


@torch.library.custom_op("maskrcnn_tpu_torch::roi_mask_head", mutates_args=(),
                         device_types="cpu")
def _mask_head_op(features: list[torch.Tensor], ys: torch.Tensor,
                  xs: torch.Tensor, level: torch.Tensor, valid: torch.Tensor,
                  rois_per_image: int, mask: list[torch.Tensor],
                  class_ids: torch.Tensor) -> torch.Tensor:
    return mask_head_plain(features, ys, xs, level, valid, rois_per_image,
                           dict(zip(MASK_KEYS, mask)), class_ids).contiguous()


@_mask_head_op.register_kernel("cuda")
def _(features, ys, xs, level, valid, rois_per_image, mask, class_ids):
    return mask_head_cuda(features, ys, xs, level, valid, rois_per_image,
                          dict(zip(MASK_KEYS, mask)), class_ids)


@_mask_head_op.register_fake
def _(features, ys, xs, level, valid, rois_per_image, mask, class_ids):
    m, p = ys.shape
    return ys.new_empty((m, 2 * p, 2 * p), dtype=torch.float32)


def roi_mask_head(features: Sequence[torch.Tensor], ys: torch.Tensor,
                  xs: torch.Tensor, level: torch.Tensor, valid: torch.Tensor,
                  rois_per_image: int, mask: dict,
                  class_ids: torch.Tensor) -> torch.Tensor:
    """The op `maskrcnn_tpu_torch::roi_mask_head`: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    return _mask_head_op([f.contiguous() for f in features], ys, xs, level,
                         valid, int(rois_per_image),
                         [mask[k] for k in MASK_KEYS], class_ids)
