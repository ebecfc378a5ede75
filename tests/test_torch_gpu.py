"""Each CUDA kernel of the PyTorch port against its plain version on the
card, the K2/K3/K4 autograd Functions against the plain graph's gradients,
and one full-width training step (marked `gpu`; each test skips with a
reason where there is none).

This file imports neither JAX nor the JAX package, and uses no conftest
fixture, so it runs on a machine that has only PyTorch and the CUDA
toolkit:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Inputs are made with numpy from a seed. `nms_case` also feeds the CPU
tests that hold the plain NMS against the JAX package
(`tests/test_torch_ops.py`)."""

import numpy as np
import pytest
import torch

from maskrcnn_tpu_torch.io.weights import params_from_numpy
from maskrcnn_tpu_torch.models import heads as pt_heads
from maskrcnn_tpu_torch.ops import (bottleneck_cuda, cuda_lib, nms_cuda,
                                    roi_align, roi_align_cuda, stem_cuda)
from maskrcnn_tpu_torch.ops.nms import _compact


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    cuda_lib.load()
    return torch.device("cuda")


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def rand_bn(rng, c):
    return {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "beta": rng.uniform(-0.3, 0.3, c).astype(np.float32),
            "moving_mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
            "moving_variance": rng.uniform(0.5, 2.0, c).astype(np.float32)}


def rand_conv(rng, kh, kw, cin, cout, scale=None):
    scale = scale or np.sqrt(2.0 / (kh * kw * cin))
    return {"kernel": (rng.standard_normal((kh, kw, cin, cout)) * scale
                       ).astype(np.float32),
            "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}


def stage_params(rng, stage, cin, mid, cout, letters, proj):
    params = {}
    c = cin
    for i, letter in enumerate(letters):
        base, bnb = f"res{stage}{letter}_branch", f"bn{stage}{letter}_branch"
        params[base + "2a"] = rand_conv(rng, 1, 1, c, mid)
        params[bnb + "2a"] = rand_bn(rng, mid)
        params[base + "2b"] = rand_conv(rng, 3, 3, mid, mid)
        params[bnb + "2b"] = rand_bn(rng, mid)
        params[base + "2c"] = rand_conv(rng, 1, 1, mid, cout)
        params[bnb + "2c"] = rand_bn(rng, cout)
        if i == 0 and proj:
            params[base + "1"] = rand_conv(rng, 1, 1, c, cout)
            params[bnb + "1"] = rand_bn(rng, cout)
        c = cout
    return params


def stem_params(rng):
    return {"conv1": rand_conv(rng, 7, 7, 3, 64, scale=0.05),
            "bn_conv1": rand_bn(rng, 64)}


def clustered_boxes(rng, n):
    """Score-sorted boxes in clusters (heavy suppression at either IoU),
    with zero-area rows and flagged-invalid rows mixed in."""
    centers = rng.uniform(0.1, 0.9, size=(max(n // 12, 1), 2))
    pick = centers[rng.integers(0, len(centers), n)]
    half = rng.uniform(0.02, 0.12, size=(n, 2))
    jitter = rng.normal(0, 0.015, size=(n, 2))
    yx1 = np.clip(pick + jitter - half, 0, 1)
    yx2 = np.clip(pick + jitter + half, 0, 1)
    b = np.concatenate([yx1, yx2], axis=1).astype(np.float32)
    b[rng.choice(n, n // 10, replace=False)] = 0.0
    valid = rng.uniform(size=n) > 0.1
    return b, valid


NMS_KINDS = ("clustered", "stop_mid_chunk", "identical", "zero_area",
             "holes", "ulp_pairs", "classes")


def nms_case(kind, n, seed=0):
    """(boxes (n, 4) float32, valid (n,) bool, iou threshold, max_out) for
    one of NMS_KINDS:
      clustered       clusters with zero-area and invalid rows, IoU 0.7
      stop_mid_chunk  the same, max_out reached inside a 64-box chunk
      identical       every box the same: only the first is kept
      zero_area       every other box has zero height (never kept, never
                      suppresses)
      holes           every third candidate flag off
      ulp_pairs       disjoint pairs whose second box covers float32(0.7)
                      of the first, or one ulp less or more: IoU at the
                      threshold 0.7 up to the test's own rounding
      classes         class-offset boxes (class c shifted by 2c) at IoU 0.3,
                      max_out 100 (the detection stage)"""
    rng = np.random.default_rng(seed + n)
    t, max_out = 0.7, max(n // 6, 4)
    if kind in ("clustered", "stop_mid_chunk", "holes", "zero_area"):
        boxes, valid = clustered_boxes(rng, n)
        if kind == "stop_mid_chunk":
            max_out = min(37, n // 4)
        elif kind == "holes":
            valid = np.ones(n, bool)
            valid[::3] = False
        elif kind == "zero_area":
            boxes[1::2, 2] = boxes[1::2, 0]
    elif kind == "identical":
        boxes = np.tile(np.float32([[0.2, 0.3, 0.6, 0.5]]), (n, 1))
        valid = np.ones(n, bool)
    elif kind == "ulp_pairs":
        w = np.float32(0.7)
        widths = [np.nextafter(w, np.float32(0)), w,
                  np.nextafter(w, np.float32(1))]
        boxes = np.zeros((n, 4), np.float32)
        for i in range(n // 2):
            y = np.float32(2 * i)        # exact: pairs never meet
            boxes[2 * i] = [y, 0, y + 1, 1]
            boxes[2 * i + 1] = [y, 0, y + 1, widths[i % 3]]
        if n % 2:
            boxes[-1] = [2 * n, 0, 2 * n + 1, 1]
        valid = np.ones(n, bool)
    elif kind == "classes":
        boxes, valid = clustered_boxes(rng, n)
        cls = rng.integers(1, 8, n).astype(np.float32)
        boxes = boxes + 2.0 * cls[:, None] * (boxes.any(1, keepdims=True))
        t, max_out = 0.3, 100
    else:
        raise ValueError(kind)
    return boxes.astype(np.float32), valid, t, max_out


# --------------------------------------------------------------------------
# K1 NMS
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [6000, 12000])
@pytest.mark.parametrize("kind", NMS_KINDS)
def test_gpu_nms_kernel_matches_plain(kind, n):
    """Compacted kept indices (the first max_out selections) equal the
    plain version's, and the flags past them read False."""
    dev = _card()
    cases = [nms_case(kind, n, seed) for seed in (0, 1)]
    boxes = torch.from_numpy(np.stack([c[0] for c in cases])).to(dev)
    valid = torch.from_numpy(np.stack([c[1] for c in cases])).to(dev)
    _, _, t, max_out = cases[0]
    want = nms_cuda.nms_keep_plain(boxes, valid, t, max_out)
    got = nms_cuda.nms_keep(boxes, valid, t, max_out)
    torch.cuda.synchronize()
    wi, wv = _compact(want, n, max_out)
    gi, gv = _compact(got, n, max_out)
    assert torch.equal(gv, wv) and torch.equal(gi, wi)
    assert torch.equal(got, want)
    assert int(got.sum(1).max()) <= max_out


# --------------------------------------------------------------------------
# K2 ROIAlign, K3 stem, K4 chains
# --------------------------------------------------------------------------

def _roi_case(seed=0, b=2, c=32, base=64, n=50, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    feats = [torch.from_numpy(rng.standard_normal(
        (b, base >> l, base >> l, c)).astype(np.float32)).to(dtype)
        for l in range(4)]
    yx1 = rng.uniform(0, 0.7, size=(b * n, 2))
    wh = rng.uniform(0.02, 0.6, size=(b * n, 2))
    rois = np.concatenate([yx1, np.minimum(yx1 + wh, 1.0)], -1)
    rois[::7] = 0.0
    ys, xs, level, valid = roi_align.prepare(
        torch.from_numpy(rois.astype(np.float32)),
        [(f.shape[1], f.shape[2]) for f in feats], (1024, 1024), 224.0, 7)
    return feats, ys, xs, level, valid, n


@pytest.mark.gpu
def test_gpu_roi_align_kernel_matches_plain():
    dev = _card()
    for dtype in (torch.float32, torch.bfloat16):
        feats, ys, xs, level, valid, n = _roi_case(dtype=dtype)
        args = ([f.to(dev) for f in feats], ys.to(dev), xs.to(dev),
                level.to(dev), valid.to(dev), n)
        want = roi_align_cuda.roi_align_plain(*args).float()
        got = roi_align_cuda.roi_align(*args).float()
        # same float32 operations in the same order; one output rounding
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=tol * want.abs().max().item())


@pytest.mark.gpu
def test_gpu_stem_kernel_matches_plain():
    dev = _card()
    rng = np.random.default_rng(0)
    sp = {k: {w: torch.from_numpy(v).to(dev) for w, v in d.items()}
          for k, d in stem_params(rng).items()}
    w, bias = stem_cuda.fold_stem_weights(sp["conv1"], sp["bn_conv1"])
    images = torch.from_numpy(rng.uniform(-124, 132, (2, 128, 128, 3))
                              .astype(np.float32)).to(dev)
    want = stem_cuda.stem_plain(images, w, bias).float()
    got = stem_cuda.stem(images, w, bias).float()
    # float32 sums in another order, then one bf16 rounding: 1 bf16 ulp
    torch.testing.assert_close(got, want, rtol=2 ** -7,
                               atol=1e-3 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 96, 160), (3, 128, 128),
                                   (1, 1024, 1024)],
                         ids=["1x96x160", "3x128x128", "1x1024x1024"])
def test_gpu_stem_kernel_shapes(shape):
    """Pooled grids the kernel's 12 x 7 tile does not divide (24 x 40 in
    width, 32 x 32 and 256 x 256 in both directions), several images, and
    the main path's 1024^2."""
    dev = _card()
    rng = np.random.default_rng(sum(shape))
    sp = {k: {w: torch.from_numpy(v).to(dev) for w, v in d.items()}
          for k, d in stem_params(rng).items()}
    w, bias = stem_cuda.fold_stem_weights(sp["conv1"], sp["bn_conv1"])
    images = torch.from_numpy(rng.uniform(-124, 132, (*shape, 3))
                              .astype(np.float32)).to(dev)
    want = stem_cuda.stem_plain(images, w, bias).float()
    got = stem_cuda.stem(images, w, bias).float()
    # float32 sums in another order, then one bf16 rounding: 1 bf16 ulp
    torch.testing.assert_close(got, want, rtol=2 ** -7,
                               atol=1e-3 * want.abs().max().item())


def _roi_edge_case(b, n, c, crop, dtype, seed=0):
    """Pool inputs at 1024^2 level choice: ROIs touching every image edge
    first in each image, every ninth ROI invalid, and the last image's ROIs
    all invalid."""
    rng = np.random.default_rng(seed)
    feats = [torch.from_numpy(rng.standard_normal(
        (b, 64 >> l, 64 >> l, c)).astype(np.float32)).to(dtype)
        for l in range(4)]
    yx1 = rng.uniform(0, 0.7, size=(b * n, 2))
    rois = np.concatenate([yx1, np.minimum(
        yx1 + rng.uniform(0.02, 0.6, size=(b * n, 2)), 1.0)], -1)
    for i in range(b):
        k = min(n, len(EDGE_ROIS))
        rois[i * n:i * n + k] = EDGE_ROIS[:k]
    rois[8::9] = 0.0
    rois[(b - 1) * n:] = 0.0
    ys, xs, level, valid = roi_align.prepare(
        torch.from_numpy(rois.astype(np.float32)),
        [(f.shape[1], f.shape[2]) for f in feats], (1024, 1024), 224.0, crop)
    assert valid[:n].any() and not valid[(b - 1) * n:].any()
    return feats, ys, xs, level, valid, n


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("c,crop,b,n", [(256, 7, 2, 37), (256, 7, 2, 300),
                                        (256, 14, 2, 37), (2, 7, 3, 20),
                                        (2, 14, 2, 20)],
                         ids=["c256-pool7", "c256-pool7-m600",
                              "c256-pool14", "c2-pool7", "c2-pool14"])
def test_gpu_roi_align_kernel_equals_plain(dtype, c, crop, b, n):
    """The kernel does the plain version's float32 operations in its order
    and rounds once: its output equals the plain version's. C = 256 takes
    16-byte chunks, C = 2 channel pairs; 2 x 300 ROIs at pool 7 split each
    ROI's 7 rows over blocks of 4 and 3 on a 132-SM card."""
    dev = _card()
    feats, ys, xs, level, valid, n = _roi_edge_case(b, n, c, crop, dtype)
    args = ([f.to(dev) for f in feats], ys.to(dev), xs.to(dev),
            level.to(dev), valid.to(dev), n)
    want = roi_align_cuda.roi_align_plain(*args)
    got = roi_align_cuda.roi_align(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b * n, crop, crop, c)
    assert torch.equal(got, want)
    assert not got[(b - 1) * n:].any()


def _chain_case(seed=0, stage=2, cin=64, mid=64, cout=256, hw=(32, 32)):
    """A projection block, then two identity blocks."""
    rng = np.random.default_rng(seed)
    params = stage_params(rng, stage, cin, mid, cout, "abc", True)
    blocks = bottleneck_cuda.fold_bottleneck_chain(
        params_from_numpy(params), stage, "abc")
    x = torch.from_numpy(rng.standard_normal((2, *hw, cin))
                         .astype(np.float32)).to(torch.bfloat16)
    return x, blocks


@pytest.mark.gpu
@pytest.mark.parametrize("stage,cin,mid,cout,hw", [
    (2, 64, 64, 256, (32, 32)), (2, 64, 64, 256, (20, 37)),
    (3, 256, 128, 512, (16, 32)), (3, 256, 128, 512, (13, 21)),
    (2, 64, 64, 192, (9, 17))],
    ids=["mid64", "mid64-ragged", "mid128", "mid128-ragged", "cout192"])
def test_gpu_chain_kernel_matches_plain(stage, cin, mid, cout, hw):
    """Mid widths 64 and 128, a projection then identity blocks, edge tiles
    the 8 x 16 tile does not divide, and 64-column output chunks."""
    dev = _card()
    x, blocks = _chain_case(stage=stage, cin=cin, mid=mid, cout=cout, hw=hw)
    x = x.to(dev)
    blocks = [{k: v.to(dev) for k, v in b.items()} for b in blocks]
    want = bottleneck_cuda.chain_plain(x, blocks).float()
    got = bottleneck_cuda.fused_bottleneck_chain(x, blocks).float()
    # bf16 intermediates rounded at the same points, float32 sums in
    # another order: an ulp that later blocks carry on
    torch.testing.assert_close(got, want, rtol=0.02,
                               atol=0.01 * want.abs().max().item())


# --------------------------------------------------------------------------
# K5 classifier head, K6 mask head
# --------------------------------------------------------------------------

EDGE_ROIS = np.float32([
    [0.0, 0.0, 0.3, 0.4],      # top-left corner
    [0.6, 0.7, 1.0, 1.0],      # bottom-right corner
    [0.0, 0.2, 1.0, 0.5],      # top to bottom
    [0.3, 0.0, 0.5, 1.0],      # left to right
    [0.0, 0.0, 1.0, 1.0],      # the whole image
])


def _head_case(seed=0, b=2, n=20, crop=7, c=256, dtype=torch.float32):
    """Features, the pool's prepared positions, the packed head (K5 at
    pool 7, K6 at pool 14, 81 classes, BN statistics from the seed) and
    class ids: ROIs touching each image edge first, every ninth ROI
    invalid, class ids 0 and 80 among 1..80."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    feats = [torch.from_numpy(rng.standard_normal(
        (b, 64 >> l, 64 >> l, c)).astype(np.float32)).to(dtype)
        for l in range(4)]
    yx1 = rng.uniform(0, 0.7, size=(b * n, 2))
    rois = np.concatenate([yx1, np.minimum(
        yx1 + rng.uniform(0.02, 0.6, size=(b * n, 2)), 1.0)], -1)
    for i in range(b):
        k = min(n, len(EDGE_ROIS))
        rois[i * n:i * n + k] = EDGE_ROIS[:k]
    rois[8::9] = 0.0
    prep = roi_align.prepare(torch.from_numpy(rois.astype(np.float32)),
                             [(f.shape[1], f.shape[2]) for f in feats],
                             (1024, 1024), 224.0, crop)
    if crop == 7:
        params = pt_heads.init_classifier_head(gen, 81, c, 7, 1024)
    else:
        params = pt_heads.init_mask_head(gen, 81, c, c)
    for w in params.values():
        if "moving_variance" in w:
            k = w["gamma"].shape[0]
            w.update(gamma=torch.rand(k, generator=gen) + 0.5,
                     beta=torch.rand(k, generator=gen) * 0.4 - 0.2,
                     moving_mean=torch.rand(k, generator=gen) * 0.4 - 0.2,
                     moving_variance=torch.rand(k, generator=gen) + 0.5)
    packed = (roi_align_cuda.pack_classifier_head(params, 81, dtype)
              if crop == 7 else roi_align_cuda.pack_mask_head(params, dtype))
    ids = rng.integers(1, 81, b * n).astype(np.int32)
    ids[1::7] = 0
    ids[3::7] = 80
    return feats, prep, n, packed, torch.from_numpy(ids)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [20, 37])
def test_gpu_classifier_head_kernel_matches_plain(n):
    """Full widths (C = 256, 12544 -> 1024 -> 1024 -> 512), 2 x n ROIs (not
    a multiple of the 128-row tile), every ninth ROI invalid."""
    dev = _card()
    feats, prep, n, head, _ = _head_case(n=n, dtype=torch.bfloat16)
    assert not prep[3].all()
    args = ([f.to(dev) for f in feats], *[t.to(dev) for t in prep], n,
            {k: v.to(dev) for k, v in head.items()})
    want = roi_align_cuda.classifier_head_plain(*args)
    got = roi_align_cuda.roi_classifier_head(*args)
    # bf16 h1/h2 rounded at the same points after float32 sums in another
    # order: an ulp of h1 moves the outputs by far less than 2% of the max
    torch.testing.assert_close(got, want, rtol=0,
                               atol=0.02 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(1, 1), (1, 37), (2, 100)],
                         ids=["m1", "m37", "m200"])
def test_gpu_mask_head_kernel_matches_plain(b, n):
    """M = b x n ROIs: edge-touching ROIs (the 3x3 convs read past the
    14 x 14 grid on every side), invalid ROIs, class ids 0 and 80."""
    dev = _card()
    feats, prep, n, mask, ids = _head_case(b=b, n=n, crop=14,
                                           dtype=torch.bfloat16)
    args = ([f.to(dev) for f in feats], *[t.to(dev) for t in prep], n,
            {k: v.to(dev) for k, v in mask.items()}, ids.to(dev))
    want = roi_align_cuda.mask_head_plain(*args)
    cuda_lib.reset_launches()
    got = roi_align_cuda.roi_mask_head(*args)
    torch.cuda.synchronize()
    assert cuda_lib.launches["roi_mask_head"] == 1
    assert got.shape == (b * n, 28, 28)
    # four bf16 activation roundings after float32 sums in another order,
    # through a sigmoid (slope <= 1/4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("key,delta", [("conv_grid", -1), ("conv_grid", 1),
                                       ("conv_chunks", -4),
                                       ("deconv_chunks", 1)])
def test_gpu_mask_head_kernel_runs_its_plan(monkeypatch, key, delta):
    """K6 launches the grid and K chunks of `mask_head_plan`: one that
    does not cover the M x 196 positions once, or whose chunks do not match
    the weights' K, is refused with nothing launched."""
    dev = _card()
    feats, prep, n, mask, ids = _head_case(b=1, n=37, crop=14,
                                           dtype=torch.bfloat16)
    args = ([f.to(dev) for f in feats], *[t.to(dev) for t in prep], n,
            {k: v.to(dev) for k, v in mask.items()}, ids.to(dev))
    plan = roi_align_cuda.mask_head_plan(n)
    bad = dict(plan, **{key: (plan[key][0] + delta,) if key == "conv_grid"
                        else plan[key] + delta})
    monkeypatch.setattr(roi_align_cuda, "mask_head_plan", lambda m: bad)
    cuda_lib.reset_launches()
    with pytest.raises(RuntimeError, match="roi_mask_head failed"):
        roi_align_cuda.roi_mask_head(*args)
    assert cuda_lib.launches["roi_mask_head"] == 0
    monkeypatch.undo()
    torch.testing.assert_close(roi_align_cuda.roi_mask_head(*args),
                               roi_align_cuda.mask_head_plain(*args),
                               rtol=0, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("head", ["classifier", "mask"])
def test_gpu_fused_head_unbiased_against_float64(head):
    """K5 (its h1, logits and deltas) and K6 (its conv 3 and conv 4
    outputs and masks) against their float32 and float64 plain versions
    under the rule of `tools/kernel_bias.py`, TF32 off, over four inputs of
    2 x 100 ROIs (K6: 2 x 50), valid ROIs only. The tensor cores' own
    accumulation (d += A * B, rounded toward zero) failed it: mean |error|
    3.4-6.9x the plain version's (PERF.md)."""
    from maskrcnn_tpu_torch.tools import kernel_bias as kb
    from maskrcnn_tpu_torch.tools.flagship_proof import NoTF32

    dev = _card()
    stats = kb.head_stats()
    with NoTF32():
        for seed in range(4):
            if head == "classifier":
                feats, prep, n, packed, _ = _head_case(
                    seed, n=100, dtype=torch.bfloat16)
            else:
                feats, prep, n, packed, ids = _head_case(
                    seed, n=50, crop=14, dtype=torch.bfloat16)
            args = ([f.to(dev) for f in feats], *[t.to(dev) for t in prep],
                    n, {k: v.to(dev) for k, v in packed.items()})
            keep = kb.head_rows(2, n, args[4])
            if head == "classifier":
                kb.audit_classifier_head(stats, *args, 81, keep)
            else:
                kb.audit_mask_head(stats, *args, ids.to(dev), keep)
    for name in kb.K5_ROWS if head == "classifier" else kb.K6_ROWS:
        row = kb.decided(stats[name])
        assert row["elements"] > 0, name
        assert row["rule"]["unbiased"], (name, row["rule"])


# --------------------------------------------------------------------------
# K2, K3, K4 under autograd (training), and a full-width training step
# --------------------------------------------------------------------------

def _leaf_grads(fn, params, x, cot):
    """fn(params, x), then the gradients of sum(out * cot) for each param
    leaf (and x where it is a float tensor)."""
    leaves = [(k, w) for k, d in params.items() for w in d]
    p = {k: {w: v.detach().clone().requires_grad_(True)
             for w, v in d.items()} for k, d in params.items()}
    xx = x.detach().clone().requires_grad_(True)
    out = fn(p, xx)
    got = torch.autograd.grad((out.float() * cot.float()).sum(),
                              [p[k][w] for k, w in leaves] + [xx])
    return out, {**{f"{k}/{w}": g for (k, w), g in zip(leaves, got)},
                 "x": got[-1]}


def _assert_grads_close(got, want, frac):
    for k, w in want.items():
        scale = w.float().abs().max().item()
        err = (got[k].float() - w.float()).abs().max().item()
        assert err <= frac * scale, (k, err, scale)


@pytest.mark.gpu
def test_gpu_stem_function_runs_kernel_with_plain_graph_grads():
    """`StemFusedDiff` on the card: its forward is K3 (one launch, the
    kernel's output), its gradients those of the layer graph
    `_stem_layers` in bf16 (cuDNN's backward accumulates in an order that
    may change between runs: within 1% of each leaf's largest)."""
    from maskrcnn_tpu_torch.models import resnet
    dev = _card()
    rng = np.random.default_rng(0)
    sp = {k: {w: torch.from_numpy(v).to(dev) for w, v in d.items()}
          for k, d in stem_params(rng).items()}
    images = torch.from_numpy(rng.uniform(-124, 132, (2, 256, 256, 3))
                              .astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.standard_normal((2, 64, 64, 64))
                           .astype(np.float32)).to(dev)
    cuda_lib.reset_launches()
    out, g_fn = _leaf_grads(stem_cuda.stem_fused_diff, sp, images, cot)
    assert cuda_lib.launches["stem"] == 1
    assert torch.equal(out, stem_cuda.apply_stem(sp, images))
    _, g_pl = _leaf_grads(
        lambda p, x: resnet._stem_layers(p, x, torch.bfloat16), sp, images,
        cot)
    _assert_grads_close(g_fn, g_pl, 1e-2)


@pytest.mark.gpu
def test_gpu_chain_function_runs_kernel_with_plain_graph_grads():
    """`ChainFusedDiff` over res2 a-c on the card: K4 forward (one launch a
    block), the `_bottleneck` layers' gradients."""
    from maskrcnn_tpu_torch.models import resnet
    dev = _card()
    rng = np.random.default_rng(1)
    sp = {k: {w: torch.from_numpy(v).to(dev) for w, v in d.items()}
          for k, d in stage_params(rng, 2, 64, 64, 256, "abc",
                                   True).items()}
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 64))
                         .astype(np.float32)).to(dev).to(torch.bfloat16)
    cot = torch.from_numpy(rng.standard_normal((2, 64, 64, 256))
                           .astype(np.float32)).to(dev)

    def plain(p, xx):
        for letter in "abc":
            xx = resnet._bottleneck(xx, p, 2, letter, letter == "a", 1,
                                    torch.bfloat16)
        return xx

    cuda_lib.reset_launches()
    out, g_fn = _leaf_grads(
        lambda p, xx: bottleneck_cuda.chain_fused_diff(p, 2, "abc", xx), sp,
        x, cot)
    assert cuda_lib.launches["bottleneck"] == 3
    blocks = bottleneck_cuda.fold_bottleneck_chain(sp, 2, "abc")
    assert torch.equal(out, bottleneck_cuda.fused_bottleneck_chain(x, blocks))
    _, g_pl = _leaf_grads(plain, sp, x, cot)
    _assert_grads_close(g_fn, g_pl, 1e-2)


# the plain pool's feature gradient is an atomic scatter on the card, in
# the features' dtype: within 1e-5 of each level's largest in float32, 2e-2
# (a few bf16 ulps of a sum in another order) in bf16
ROI_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("crop", [7, 14])
def test_gpu_roi_align_function_runs_kernel_with_plain_grads(crop, dtype):
    """`pyramid_roi_align` on features that need a gradient, at the
    training path's 200 ROIs an image, pool 7 and 14, in float32 and in
    bf16 (what training pools): K2 forward (bit-equal to the plain pool),
    the plain pool's feature gradients."""
    dev = _card()
    rng = np.random.default_rng(2)
    feats = [torch.from_numpy(rng.standard_normal((2, s, s, 256))
                              .astype(np.float32)).to(dev).to(dtype)
             for s in (256, 128, 64, 32)]
    yx1 = rng.uniform(0, 0.7, (2, 200, 2))
    wh = rng.uniform(0.02, 0.6, (2, 200, 2))
    rois = np.concatenate([yx1, np.minimum(yx1 + wh, 1.0)], -1)
    rois[:, ::9] = 0.0
    rois = torch.from_numpy(rois.astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.standard_normal((2, 200, crop, crop, 256))
                           .astype(np.float32)).to(dev)

    def grads(fn):
        fs = [f.clone().requires_grad_(True) for f in feats]
        out = fn(fs)
        g = torch.autograd.grad((out * cot).sum(), fs, allow_unused=True)
        return out, [torch.zeros_like(f) if x is None else x
                     for f, x in zip(fs, g)]

    def plain(fs):
        ys, xs, level, valid = roi_align.prepare(
            rois.reshape(-1, 4), [(f.shape[1], f.shape[2]) for f in fs],
            (1024, 1024), 224.0, crop)
        return roi_align_cuda.roi_align_plain(
            fs, ys, xs, level, valid, 200).reshape(2, 200, crop, crop, 256)

    cuda_lib.reset_launches()
    out, g_fn = grads(lambda fs: roi_align.pyramid_roi_align(
        fs, rois, crop, (1024, 1024)))
    assert cuda_lib.launches["roi_align"] == 1
    want, g_pl = grads(plain)
    assert torch.equal(out, want)
    for a, b in zip(g_fn, g_pl):
        scale = b.float().abs().max().item()
        assert scale > 0
        torch.testing.assert_close(
            a.float(), b.float(), rtol=0,
            atol=ROI_GRAD_TOL[dtype] * scale)


def _live_bn(params, gen):
    """Every BN's parameters drawn from the seed (random init zeroes each
    block's last gamma, which makes every branch2a/2b kernel's gradient
    exactly zero)."""
    for w in params.values():
        if "moving_variance" in w:
            c = w["gamma"].shape[0]
            u = lambda lo, hi: torch.rand(c, generator=gen) * (hi - lo) + lo
            w["gamma"], w["beta"] = u(0.3, 0.8), u(-0.2, 0.2)
            w["moving_mean"], w["moving_variance"] = u(-0.2, 0.2), u(0.5, 2.0)


@pytest.mark.gpu
@pytest.mark.parametrize("frozen", [False, True], ids=["batch_bn",
                                                       "frozen_bn_fused"])
def test_gpu_full_width_train_step(frozen):
    """One training step at R101-FPN @ 1024^2, 81 classes, bf16, batch 1:
    finite losses, a nonzero gradient for every conv and dense kernel
    (conv1 and res2/res3 behind K3 and K4, the FPN behind K2), K1 and K2
    launched, K3 and K4 only with frozen BN + `train_fused_kernels`; with
    batch BN a nonzero gradient for every BN gamma and beta and none for
    the moving statistics, with frozen BN no gradient for any BN tensor
    and none changed by the update."""
    from maskrcnn_tpu_torch.core.anchors import generate_anchors
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    from maskrcnn_tpu_torch.models.mask_rcnn import (init_mask_rcnn,
                                                     params_to)
    from maskrcnn_tpu_torch.train.data import synthetic_train_batch
    from maskrcnn_tpu_torch.train import step as train
    dev = _card()
    cfg = MaskRCNNConfig(train_bn="frozen" if frozen else "batch",
                         train_fused_kernels=frozen)
    gen = torch.Generator().manual_seed(0)
    params = init_mask_rcnn(gen, cfg)
    _live_bn(params, gen)
    state, opt = train.make_train_state(params_to(params, dev), cfg)
    batch = synthetic_train_batch(cfg, 1, dev)
    anchors = torch.from_numpy(generate_anchors(cfg)).to(dev)
    cuda_lib.reset_launches()
    grads, metrics = train.compute_gradients(state, batch, anchors, cfg, opt)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
    zero = [layer for layer, ws in state.params.items() if "kernel" in ws
            and not grads[layer]["kernel"].abs().max().item() > 0]
    assert not zero, zero
    assert launches["nms"] >= 1 and launches["roi_align"] == 2
    if frozen:
        assert launches["stem"] == 1 and launches["bottleneck"] == 6
    else:
        assert launches["stem"] == 0 and launches["bottleneck"] == 0
    for layer, ws in state.params.items():
        if "moving_variance" not in ws:
            continue
        got = grads.get(layer, {})
        if frozen:
            # make_optimizer masks the whole BN layer
            assert all(got.get(w) is None for w in ws), layer
        else:
            for w in ("gamma", "beta"):
                assert got[w] is not None and got[w].abs().max().item() > 0, \
                    (layer, w)
            for w in ("moving_mean", "moving_variance"):
                assert got.get(w) is None or not got[w].any(), (layer, w)
    new = train.apply_gradients(state, grads, opt)
    for layer, ws in state.params.items():
        if "moving_variance" in ws:
            for w, v in ws.items():
                # frozen BN stays whole; batch BN never reads (nor moves)
                # the moving statistics
                if frozen or w.startswith("moving"):
                    assert torch.equal(new.params[layer][w], v), (layer, w)


# --------------------------------------------------------------------------
# the kernels as custom ops, and the paths of MobileNetV2, export and DP
# --------------------------------------------------------------------------

def _gpu_op_cases(dev):
    """name -> (op args on `dev`, wrapper call, plain call, tolerance as a
    fraction of the plain output's largest value, launches of one call) at
    the shapes of the tests above."""
    nms = [nms_case("clustered", 6000, seed) for seed in (0, 1)]
    boxes = torch.from_numpy(np.stack([c[0] for c in nms])).to(dev)
    valid = torch.from_numpy(np.stack([c[1] for c in nms])).to(dev)
    feats, ys, xs, level, valid_r, n = _roi_case(dtype=torch.bfloat16)
    roi = ([f.to(dev) for f in feats], ys.to(dev), xs.to(dev),
           level.to(dev), valid_r.to(dev), n)
    hf, hp, hn, head, _ = _head_case(n=20, dtype=torch.bfloat16)
    hargs = ([f.to(dev) for f in hf], *[t.to(dev) for t in hp], hn)
    head = {k: v.to(dev) for k, v in head.items()}
    mf, mp, mn, mask, ids = _head_case(b=2, n=37, crop=14,
                                       dtype=torch.bfloat16)
    margs = ([f.to(dev) for f in mf], *[t.to(dev) for t in mp], mn)
    mask = {k: v.to(dev) for k, v in mask.items()}
    ids = ids.to(dev)
    rng = np.random.default_rng(0)
    sp = {k: {w: torch.from_numpy(v).to(dev) for w, v in d.items()}
          for k, d in stem_params(rng).items()}
    w, bias = stem_cuda.fold_stem_weights(sp["conv1"], sp["bn_conv1"])
    images = torch.from_numpy(rng.uniform(-124, 132, (2, 128, 128, 3))
                              .astype(np.float32)).to(dev)
    x, blocks = _chain_case()
    x = x.to(dev)
    blocks = [{k: v.to(dev) for k, v in b.items()} for b in blocks]
    rac = roi_align_cuda
    return {
        "nms_keep": ((boxes, valid, 0.7, 1000),
                     lambda: nms_cuda.nms_keep(boxes, valid, 0.7, 1000),
                     lambda: nms_cuda.nms_keep_plain(boxes, valid, 0.7,
                                                     1000), 0.0, 1),
        "roi_align": (roi, lambda: rac.roi_align(*roi),
                      lambda: rac.roi_align_plain(*roi), 1e-2, 1),
        "roi_classifier_head": (
            (*hargs, [head[k] for k in rac.HEAD_KEYS]),
            lambda: rac.roi_classifier_head(*hargs, head),
            lambda: rac.classifier_head_plain(*hargs, head), 0.02, 1),
        "roi_mask_head": (
            (*margs, [mask[k] for k in rac.MASK_KEYS], ids),
            lambda: rac.roi_mask_head(*margs, mask, ids),
            lambda: rac.mask_head_plain(*margs, mask, ids), 1e-2, 1),
        "stem": ((images, w, bias), lambda: stem_cuda.stem(images, w, bias),
                 lambda: stem_cuda.stem_plain(images, w, bias), 1e-2, 1),
        "bottleneck_chain": (
            (x, bottleneck_cuda._flatten_blocks(blocks)),
            lambda: bottleneck_cuda.fused_bottleneck_chain(x, blocks),
            lambda: bottleneck_cuda.chain_plain(x, blocks), 0.05, 3),
    }


OP_FAMILY = {"nms_keep": "nms", "bottleneck_chain": "bottleneck"}
OPS = ("nms_keep", "roi_align", "roi_classifier_head", "roi_mask_head",
       "stem", "bottleneck_chain")
PLAINS = {"nms_keep": (nms_cuda, "nms_keep_plain"),
          "roi_align": (roi_align_cuda, "roi_align_plain"),
          "roi_classifier_head": (roi_align_cuda, "classifier_head_plain"),
          "roi_mask_head": (roi_align_cuda, "mask_head_plain"),
          "stem": (stem_cuda, "stem_plain"),
          "bottleneck_chain": (bottleneck_cuda, "chain_plain")}


@pytest.mark.gpu
@pytest.mark.parametrize("name", OPS)
def test_gpu_custom_op_launches_kernel_and_matches_plain(name):
    """`torch.ops.maskrcnn_tpu_torch.<name>` on CUDA tensors launches its
    kernel (the launch count moves) and equals the plain version within
    the tolerances of the kernel tests above."""
    dev = _card()
    args, _, plain, tol, launches = _gpu_op_cases(dev)[name]
    cuda_lib.reset_launches()
    got = getattr(torch.ops.maskrcnn_tpu_torch, name)(*args)
    torch.cuda.synchronize()
    assert cuda_lib.launches[OP_FAMILY.get(name, name)] == launches
    want = plain()
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "nms_keep":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol * want.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("name", OPS)
def test_gpu_wrapper_never_takes_the_plain_version(monkeypatch, name):
    """With the plain version made to raise, the wrapper still runs on
    CUDA tensors: the card has no fallback to it."""
    dev = _card()
    cases = _gpu_op_cases(dev)
    module, attr = PLAINS[name]

    def refuse(*a, **k):
        raise AssertionError(f"{attr} reached on the card")

    monkeypatch.setattr(module, attr, refuse)
    out = cases[name][1]()
    torch.cuda.synchronize()
    assert out.is_cuda


def _tiny(**overrides):
    from maskrcnn_tpu_torch.core.config import tiny_test_config
    return tiny_test_config().replace(**overrides)


@pytest.fixture
def no_tf32():
    """float32 convolutions and products in full float32 on the card."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.gpu
def test_gpu_mobilenet_forward_matches_cpu(no_tf32):
    """MobileNetV2-FPN at the tiny config in float32: the card's forward
    (K1 and K2; no K3 or K4, which are ResNet's) against the CPU's."""
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    dev = _card()
    cfg = _tiny(architecture="mobilenetv2", compute_dtype="float32",
                detection_score_threshold=0.25)
    gen = torch.Generator().manual_seed(0)
    params = M.init_mask_rcnn(gen, cfg)
    _live_bn(params, gen)
    images = torch.rand((2, 128, 128, 3), generator=gen) * 255
    want = M.to_numpy(M.forward(params, images, cfg, device="cpu"))
    cuda_lib.reset_launches()
    got = M.to_numpy(M.forward(params, images, cfg, device=dev))
    launches = dict(cuda_lib.launches)
    assert launches["nms"] == 2 and launches["roi_align"] == 2
    assert launches["stem"] == launches["bottleneck"] == 0
    np.testing.assert_array_equal(got["roi_valid"], want["roi_valid"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in ("rois", "detections", "masks"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.gpu
def test_gpu_export_round_trip(tmp_path):
    """A bf16 tiny-config program exported on the card reloads and runs
    K1-K4 there, within 1e-4 of the eager forward."""
    from maskrcnn_tpu_torch.io import export
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    dev = _card()
    cfg = _tiny(detection_score_threshold=0.0)
    gen = torch.Generator().manual_seed(1)
    params = M.init_mask_rcnn(gen, cfg)
    _live_bn(params, gen)
    export.export_program(params, cfg, str(tmp_path), batch=2, device=dev)
    program = export.load_program(str(tmp_path))
    images = (torch.rand((2, 128, 128, 3), generator=gen) * 255).to(dev)
    cuda_lib.reset_launches()
    with torch.no_grad():
        got = program(images)
    torch.cuda.synchronize()
    assert all(cuda_lib.launches[k] > 0
               for k in ("nms", "roi_align", "stem", "bottleneck"))
    want = M.forward(params, images, cfg, device=dev)
    assert torch.equal(got["valid"], want["valid"])
    for k in ("detections", "masks"):
        assert float((got[k].float() - want[k].float()).abs().max()) <= 1e-4
    assert export.verify_program(str(tmp_path), params, cfg, batch=2,
                                 device=dev) <= 1e-4


@pytest.mark.gpu
def test_gpu_data_parallel_1_equals_single_device():
    """`MaskRCNNDetector(data_parallel=1)` on the card against the plain
    detector: the same outputs bit for bit, an odd uint8 batch too."""
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    dev = _card()
    cfg = _tiny(detection_score_threshold=0.0)
    params = M.init_mask_rcnn(torch.Generator().manual_seed(2), cfg)
    one = MaskRCNNDetector(cfg, params, device=dev)
    dp = MaskRCNNDetector(cfg, params, device=dev, data_parallel=1)
    images = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (3, 128, 128, 3), dtype=np.uint8))
    want, got = one.run_batch(images), dp.run_batch(images)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
def test_gpu_dryrun_step_over_nccl(capfd):
    """`dryrun_step`'s default: rank i on card i over NCCL, one image a
    rank, within the JAX package's bounds of the single-process step,
    then the DP forward over the same cards."""
    from maskrcnn_tpu_torch.parallel import mesh
    _card()
    n = torch.cuda.device_count()
    mesh.dryrun_step(n)
    assert f"over {n} cuda ranks" in capfd.readouterr().out
