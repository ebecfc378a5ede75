"""Each CUDA kernel of the PyTorch port against its plain version on the
card, the K2/K3/K4 autograd Functions against the plain graph's gradients,
and one full-width training step (marked `gpu`; each test skips with a
reason where there is none).

This file imports neither JAX nor the JAX package, and uses no conftest
fixture, so it runs on a machine that has only PyTorch and the CUDA
toolkit:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Inputs are made with numpy from a seed, by the cases of
`tests/torch_support.py`, which the CPU tests share. This file alone of
the port's tests keeps torch's threads: it runs alone on the card."""

import numpy as np
import pytest
import torch

from maskrcnn_tpu_torch.models import nn as pt_nn
from maskrcnn_tpu_torch.models import resnet as pt_resnet
from maskrcnn_tpu_torch.ops import (bottleneck_cuda, conv_epilogue_cuda,
                                    cuda_lib, nms_cuda, roi_align,
                                    roi_align_cuda, stem_cuda)
from maskrcnn_tpu_torch.ops.nms import _compact
from tests.torch_support import (EDGE_ROIS, NMS_KINDS, chain_case,
                                 epilogue_case, head_case, live_bn, nms_case,
                                 off_identity, resnet_case, roi_case,
                                 stage_params, stem_params)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    cuda_lib.load()
    return torch.device("cuda")


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

@pytest.mark.gpu
def test_gpu_roi_align_kernel_matches_plain():
    dev = _card()
    for dtype in (torch.float32, torch.bfloat16):
        feats, ys, xs, level, valid, n = roi_case(dtype=dtype)
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


def layer_sequence(y, params, residual=None):
    """The layers' ops on a raw conv output as `models/resnet.py::
    _bottleneck` runs them: `nn.conv2d`'s bias add, `nn.batch_norm`,
    `nn.relu`, the residual add (the shortcut conv's output finished by
    its own bias add and BN first)."""
    bf16 = torch.bfloat16

    def bias_bn(t, conv, bn):
        return pt_nn.batch_norm((t + conv["bias"].to(bf16)).to(bf16), bn)

    t = bias_bn(y, params["conv"], params["bn"])
    if residual is None:
        return pt_nn.relu(t)
    if "sconv" in params:
        residual = bias_bn(residual, params["sconv"], params["sbn"])
    return pt_nn.relu(t + residual)


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
    x, blocks = chain_case(stage=stage, cin=cin, mid=mid, cout=cout, hw=hw)
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

@pytest.mark.gpu
@pytest.mark.parametrize("n", [20, 37])
def test_gpu_classifier_head_kernel_matches_plain(n):
    """Full widths (C = 256, 12544 -> 1024 -> 1024 -> 512), 2 x n ROIs (not
    a multiple of the 128-row tile), every ninth ROI invalid."""
    dev = _card()
    feats, prep, n, head, _ = head_case(n=n, dtype=torch.bfloat16)
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
    feats, prep, n, mask, ids = head_case(b=b, n=n, crop=14,
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
    feats, prep, n, mask, ids = head_case(b=1, n=37, crop=14,
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
                feats, prep, n, packed, _ = head_case(
                    seed, n=100, dtype=torch.bfloat16)
            else:
                feats, prep, n, packed, ids = head_case(
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
    live_bn(params, gen)
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
    assert launches["conv_epilogue"] == 0
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
# the conv epilogue of ResNet's layer path
# --------------------------------------------------------------------------

def _bits(t):
    return t.view(torch.int16)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["bn_relu", "identity", "projection"])
@pytest.mark.parametrize("b,side,mid,out", [(1, 128, 128, 512),
                                            (2, 64, 256, 1024),
                                            (2, 32, 512, 2048)],
                         ids=["res3a", "res4", "res5"])
def test_gpu_conv_epilogue_bit_equal_to_layers(form, b, side, mid, out):
    """Each form of the pass on the card equals the layers' op sequence on
    the same raw conv output bit for bit (-0.0 and infinities among the
    inputs), at the shapes of res3a, res4 and res5 (2a / 2b outputs `mid`
    wide, 2c and the shortcut `out`), in one launch."""
    dev = _card()
    c = mid if form == "bn_relu" else out
    y, layer, res, short, params = epilogue_case(b=b, side=side, c=c,
                                                  form=form, dev=dev)
    cuda_lib.reset_launches()
    got = conv_epilogue_cuda.conv_epilogue(y, layer, res, short)
    torch.cuda.synchronize()
    assert cuda_lib.launches["conv_epilogue"] == 1
    want = layer_sequence(y, params, res)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.equal(_bits(got), _bits(want))
    s = (None,) * 3 if short is None else short[1:]
    plain = conv_epilogue_cuda.epilogue_plain(y, *layer[1:], res, *s)
    assert torch.equal(_bits(got), _bits(plain))


@pytest.mark.gpu
def test_gpu_conv_epilogue_refuses_what_it_cannot_take():
    """The wrapper raises on channels that are not a multiple of 8 and on
    a non-contiguous input, the launch on an input off a 16-byte
    boundary: no fallback on the card."""
    dev = _card()
    y, layer, res, short, _ = epilogue_case(c=12, dev=dev)
    with pytest.raises(ValueError, match="channels % 8"):
        conv_epilogue_cuda.conv_epilogue(y, layer, res, short)
    y, layer, res, short, _ = epilogue_case(c=64, dev=dev)
    with pytest.raises(ValueError, match="contiguous"):
        conv_epilogue_cuda.conv_epilogue(y.transpose(1, 2), layer, res,
                                         short)
    with pytest.raises(ValueError, match="contiguous"):
        conv_epilogue_cuda.conv_epilogue(y, layer, res.transpose(1, 2),
                                         short)
    one = y[:1]
    off = y.reshape(-1)[1:1 + one.numel()].view(one.shape)  # 2 bytes off
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(RuntimeError, match="failed to launch"):
        conv_epilogue_cuda.conv_epilogue(off, layer, res[:1], short)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,passes", [("resnet101", 81),
                                         ("resnet50", 30)])
def test_gpu_resnet_epilogue_path_bit_equal_to_layers(monkeypatch, arch,
                                                      passes):
    """The backbone (C2-C5) on the card at 256^2, batch 2, with the
    epilogue pass finishing every layer-path conv (one launch a conv but
    the shortcut's: 81 for R101, 30 for R50) equals the layers bit for
    bit, K3 and K4 running in both."""
    dev = _card()
    params, images = resnet_case(arch=arch, side=256, b=2, dev=dev)
    cuda_lib.reset_launches()
    with torch.no_grad():
        got = pt_resnet.apply_resnet(params, images, arch)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    assert launches["conv_epilogue"] == passes
    assert launches["stem"] == 1 and launches["bottleneck"] == 6
    monkeypatch.setattr(conv_epilogue_cuda, "epilogue_supported",
                        lambda x, dtype: False)
    cuda_lib.reset_launches()
    with torch.no_grad():
        want = pt_resnet.apply_resnet(params, images, arch)
    torch.cuda.synchronize()
    assert cuda_lib.launches["conv_epilogue"] == 0
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(_bits(g), _bits(w))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,passes", [("resnet101", 81), ("resnet50", 30),
                                         ("mobilenetv2", 0),
                                         ("vitdet_b", 0), ("swin_s", 0)])
def test_gpu_forward_conv_epilogue_launches(arch, passes):
    """One bf16 forward on the card launches the pass once a ResNet
    layer-path conv but the shortcut's; MobileNetV2, ViTDet and Swin
    never."""
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    dev = _card()
    cfg = _tiny(architecture=arch)
    params = M.init_mask_rcnn(torch.Generator().manual_seed(0), cfg)
    images = torch.rand((1, 128, 128, 3),
                        generator=torch.Generator().manual_seed(1)) * 255
    cuda_lib.reset_launches()
    M.forward(params, images, cfg, device=dev)
    torch.cuda.synchronize()
    assert cuda_lib.launches["conv_epilogue"] == passes


# --------------------------------------------------------------------------
# the ViT epilogue of ViTDet-B's linears
# --------------------------------------------------------------------------

# case -> (form, where y lies, where the LayerNorm output goes (None: no
# LayerNorm), the channels y has)
VIT_CASES = {"qkv_windowed": ("bias", "windows", None, 2304),
             "qkv_global": ("bias", "grid", None, 2304),
             "fc1": ("bias_gelu", "grid", None, 3072),
             "proj_windowed": ("residual", "windows", "grid", 768),
             "proj_global": ("residual", "grid", "grid", 768),
             "fc2_to_windowed": ("residual", "grid", "windows", 768),
             "fc2_to_global": ("residual", "grid", "grid", 768),
             "fc2_last": ("residual", "grid", None, 768)}
# `vitdet_b.batch8`: batch 8, a 64x64 grid, windows of 14 padded to 70x70
VIT_B, VIT_GRID, VIT_WINDOW, VIT_WIDTH = 8, 64, 14, 768
VIT_WINDOWS = VIT_B * 25


def vit_epilogue_case(case, dev, seed=0):
    """A raw GEMM output `y` in the case's layout (bf16, -0.0 and
    infinities among it in the bias forms), its dense layer {kernel, bias}
    (float32), the float32 stream `x` and a LayerNorm {scale, bias} with
    the case's arguments for `bias_residual_norm`."""
    form, y_at, norm_at, c = VIT_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = ((VIT_WINDOWS, VIT_WINDOW, VIT_WINDOW, c) if y_at == "windows"
             else (VIT_B, VIT_GRID, VIT_GRID, c))
    if form == "bias" and y_at == "windows":
        shape = (VIT_WINDOWS, VIT_WINDOW ** 2, c)   # qkv's (n, tokens, 3C)
    y = (torch.randn(shape, generator=g, device=dev) * 2).to(torch.bfloat16)
    if form != "residual":
        flat = y.view(-1)
        flat[:4] = torch.tensor([-0.0, float("inf"), float("-inf"), 0.0])
    dense = {"kernel": torch.randn((VIT_WIDTH, c), generator=g, device=dev),
             "bias": torch.randn(c, generator=g, device=dev)}
    x = torch.randn((VIT_B, VIT_GRID, VIT_GRID, VIT_WIDTH), generator=g,
                    device=dev) * 4
    norm = {"scale": torch.rand(VIT_WIDTH, generator=g, device=dev) + 0.5,
            "bias": torch.randn(VIT_WIDTH, generator=g, device=dev) * 0.2}
    kw = {"window": VIT_WINDOW if "windows" in (y_at, norm_at) else 0,
          "norm_windowed": norm_at == "windows"}
    return form, y, dense, x, (None if norm_at is None else norm), kw


def vit_layers(form, y, dense, x, norm, window, norm_windowed, shift=0,
               eps=1e-6):
    """`models/vit.py`'s and `models/swin.py`'s layers on the raw output:
    `nn.dense`'s bias add, `F.gelu`, `window_unpartition`, the float32
    residual add, `layer_norm`, `window_partition` (Swin's windows rolled
    by `shift`) and the cast the next linear takes."""
    from maskrcnn_tpu_torch.models import vit
    t = y + dense["bias"].to(y.dtype)
    if form == "bias":
        return [t]
    if form == "bias_gelu":
        return [torch.nn.functional.gelu(t)]
    if window and not norm_windowed:
        hw = tuple(x.shape[1:3])
        pad = tuple(-(-n // window) * window for n in hw)
        t = vit.window_unpartition(t, window, pad, hw, shift)
    x = x + t.float()
    if norm is None:
        return [x]
    n = torch.nn.functional.layer_norm(x, (x.shape[-1],), norm["scale"],
                                       norm["bias"], eps)
    if window and norm_windowed:
        n, _ = vit.window_partition(n, window, shift)
    return [x, n.to(torch.bfloat16)]


def run_vit_epilogue(form, y, dense, x, norm, window, norm_windowed,
                     shift=0, eps=1e-6):
    from maskrcnn_tpu_torch.ops import vit_epilogue_cuda as ve
    consts = ve.prepare(dense)
    if form == "bias":
        return [ve.bias(y, consts)]
    if form == "bias_gelu":
        return [ve.bias_gelu(y, consts)]
    x, n = ve.bias_residual_norm(y, consts, x, norm, eps, window=window,
                                 norm_windowed=norm_windowed, shift=shift)
    return [x] if n is None else [x, n]


def ln_ulps(got, want, x, norm, window, shift=0, eps=1e-6):
    """|got - want| of a LayerNorm output in bf16 ulps at the magnitude of
    its largest term, elementwise: the output, gamma * x_hat or beta
    (x_hat = LN(x) without scale and shift, in the output's layout). Where
    gamma * x_hat and beta cancel, the output is far smaller than either,
    and a float32 difference of an ulp in the statistics moves it by many
    of its own ulps, though by less than one of the terms'."""
    from maskrcnn_tpu_torch.models import vit
    got, want = got.float(), want.float()
    x_hat = torch.nn.functional.layer_norm(x, (x.shape[-1],), eps=eps)
    if window:
        x_hat, _ = vit.window_partition(x_hat, window, shift)
    big = torch.maximum(torch.maximum(got.abs(), want.abs()),
                        torch.maximum((norm["scale"] * x_hat).abs(),
                                      norm["bias"].abs().expand_as(x_hat)))
    _, e = torch.frexp(big)
    return (got - want).abs() / torch.ldexp(torch.ones_like(got), e - 8)


# LayerNorm outputs that differ from `F.layer_norm`'s, as a share of the
# elements: the statistics are summed in another order, so a float32
# value at a bf16 rounding boundary may round the other way (1.4e-5 to
# 1.9e-5 of them at `vitdet_b.batch8`'s shapes on an H100)
LN_ULP_SHARE = 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(VIT_CASES))
def test_gpu_vit_epilogue_matches_layers(case):
    """Each form of the pass on the card against the layers' op sequence
    on the same raw output, at `vitdet_b.batch8`'s shapes, in one launch:
    the bias and GELU forms and the float32 stream x' bit for bit (-0.0
    and infinities among the bias forms' inputs); the LayerNorm output
    within one bf16 ulp of its largest term everywhere (`ln_ulps`), the
    share that differs at most LN_ULP_SHARE, and the windowed output's
    pad rows zero."""
    dev = _card()
    form, y, dense, x, norm, kw = vit_epilogue_case(case, dev)
    cuda_lib.reset_launches()
    got = run_vit_epilogue(form, y, dense, x, norm, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.launches["vit_epilogue"] == 1
    want = vit_layers(form, y, dense, x, norm, **kw)
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    if form != "residual":
        assert torch.equal(_bits(got[0]), _bits(want[0]))
        return
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    if norm is None:
        return
    ulps = ln_ulps(got[1], want[1], want[0], norm,
                   kw["window"] if kw["norm_windowed"] else 0)
    share = float((got[1] != want[1]).float().mean())
    print(f"{case}: LayerNorm output differs in {share:.3e} of the "
          f"elements, by at most {float(ulps.max())} ulp of its largest "
          f"term")
    assert float(ulps.max()) <= 1.0 and share <= LN_ULP_SHARE
    if kw["norm_windowed"]:
        # the last window of each image holds its 6 pad rows and columns
        last = got[1].view(VIT_B, 25, VIT_WINDOW, VIT_WINDOW, -1)[:, -1]
        assert float(last[:, 8:].abs().max()) == 0.0
        assert float(last[:, :, 8:].abs().max()) == 0.0


@pytest.mark.gpu
def test_gpu_vit_epilogue_refuses_what_it_cannot_take():
    """The wrapper raises on channels that are not a multiple of 8, a
    residual width outside the LayerNorm form's set, a float32 or a
    non-contiguous input, a y whose layout does not fit x and a windowed
    LayerNorm output without the LayerNorm; the launch on an input off a
    16-byte boundary: no fallback on the card."""
    from maskrcnn_tpu_torch.ops import vit_epilogue_cuda as ve
    dev = _card()
    bf = torch.bfloat16
    y = torch.randn((4, 12), device=dev).to(bf)
    with pytest.raises(ValueError, match="channels % 8"):
        ve.bias(y, ve.DenseConstants(None, torch.zeros(12, device=dev,
                                                       dtype=bf)))
    for width in (256, 1024):
        x = torch.randn((1, 4, 4, width), device=dev)
        dense = ve.DenseConstants(None, torch.zeros(width, device=dev,
                                                    dtype=bf))
        with pytest.raises(ValueError,
                           match="width of 96, 192, 384 or 768"):
            ve.bias_residual_norm(x.to(bf), dense, x)
    x = torch.randn((1, 4, 4, 768), device=dev)
    dense = ve.DenseConstants(None, torch.zeros(768, device=dev, dtype=bf))
    with pytest.raises(ValueError, match="bfloat16"):
        ve.bias_residual_norm(x, dense, x)
    with pytest.raises(ValueError, match="contiguous"):
        ve.bias_residual_norm(x.to(bf).transpose(1, 2), dense, x)
    with pytest.raises(ValueError, match="shape"):
        ve.bias_residual_norm(x.to(bf), dense, x, window=3)
    with pytest.raises(ValueError, match="needs the LayerNorm"):
        ve.bias_residual_norm(x.to(bf), dense, x, window=3,
                              norm_windowed=True)
    flat = torch.randn(2 * 16 * 768 + 8, device=dev).to(bf)
    off = flat[1:1 + 16 * 768].view(1, 4, 4, 768)     # 2 bytes off
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(RuntimeError, match="failed to launch"):
        ve.bias_residual_norm(off, dense, x)


@pytest.mark.gpu
def test_gpu_vit_epilogue_op_never_takes_the_plain_version(monkeypatch):
    """`torch.ops.maskrcnn_tpu_torch.vit_epilogue` on CUDA tensors with the
    plain version made to raise: the kernel runs (the launch count moves),
    in each form."""
    from maskrcnn_tpu_torch.ops import vit_epilogue_cuda as ve
    dev = _card()

    def refuse(*a, **k):
        raise AssertionError("epilogue_plain reached on the card")

    monkeypatch.setattr(ve, "epilogue_plain", refuse)
    cuda_lib.reset_launches()
    for case in ("qkv_global", "fc1", "proj_windowed", "fc2_last"):
        form, y, dense, x, norm, kw = vit_epilogue_case(case, dev)
        out = run_vit_epilogue(form, y, dense, x, norm, **kw)
        assert all(t.is_cuda for t in out)
    torch.cuda.synchronize()
    assert cuda_lib.launches["vit_epilogue"] == 4


# Swin-S's stages at `swin_s.batch8`'s shapes: batch 8, 1024^2, windows of
# 7; width -> grid side (256, 128, 64 and 32, padded to 259, 133, 70, 35)
SWIN_B, SWIN_WINDOW = 8, 7
SWIN_GRIDS = {96: 256, 192: 128, 384: 64, 768: 32}
# where the residual form's windowed side lies: y (proj's output read in
# the block's windows), the LayerNorm output (fc2's pass writing the next
# block's LN1), or neither (the grid, whatever the shift)
SWIN_LAYOUTS = ("y_windows", "norm_windows", "grid")


def swin_epilogue_case(width, shift, layout, dev, seed=0):
    """At a Swin-S stage of `width`: qkv's raw output over the padded
    windows and fc1's over the grid (bf16, -0.0 and infinities among
    them), the residual form's y in the layout, their dense layers
    {kernel, bias} (float32), the float32 stream x and a LayerNorm, with
    the residual form's arguments."""
    grid = SWIN_GRIDS[width]
    side = -(-grid // SWIN_WINDOW)
    nwin = SWIN_B * side * side
    g = torch.Generator(device=dev).manual_seed(seed)

    def raw(shape, specials):
        y = (torch.randn(shape, generator=g, device=dev) * 2).to(
            torch.bfloat16)
        if specials:
            y.view(-1)[:4] = torch.tensor([-0.0, float("inf"),
                                           float("-inf"), 0.0])
        return y

    def dense(c):
        return {"kernel": torch.randn((width, c), generator=g, device=dev),
                "bias": torch.randn(c, generator=g, device=dev)}

    qkv = (raw((nwin, SWIN_WINDOW ** 2, 3 * width), True), dense(3 * width))
    fc1 = (raw((SWIN_B, grid, grid, 4 * width), True), dense(4 * width))
    y = raw((nwin, SWIN_WINDOW, SWIN_WINDOW, width) if layout == "y_windows"
            else (SWIN_B, grid, grid, width), False)
    x = torch.randn((SWIN_B, grid, grid, width), generator=g,
                    device=dev) * 4
    norm = {"scale": torch.rand(width, generator=g, device=dev) + 0.5,
            "bias": torch.randn(width, generator=g, device=dev) * 0.2}
    kw = {"window": 0 if layout == "grid" else SWIN_WINDOW,
          "norm_windowed": layout == "norm_windows", "shift": shift,
          "eps": 1e-5}
    return qkv, fc1, (y, dense(width), x, norm), kw


@pytest.mark.gpu
@pytest.mark.parametrize("layout", SWIN_LAYOUTS)
@pytest.mark.parametrize("shift", [0, 3], ids=["plain", "shifted"])
@pytest.mark.parametrize("width", sorted(SWIN_GRIDS))
def test_gpu_vit_epilogue_matches_layers_at_swin_shapes(width, shift,
                                                        layout):
    """The pass at a Swin-S stage's width (4, 8, 16 or 32 lanes a row) and
    `swin_s.batch8`'s grid, plain or shifted windows, against the layers'
    op sequence (`models/swin.py`'s eps 1e-5): the qkv bias over the
    padded windows and fc1's bias and GELU bit for bit; the residual form
    with proj's output read in the rolled windows, the next LN1 written
    into them, or both sides in the grid: x' bit for bit, the LayerNorm
    output within one bf16 ulp of its largest term (at most LN_ULP_SHARE
    of it differing), the pad rows zero; three launches."""
    from maskrcnn_tpu_torch.models import vit
    from maskrcnn_tpu_torch.ops import vit_epilogue_cuda as ve
    dev = _card()
    qkv, fc1, (y, dense, x, norm), kw = swin_epilogue_case(
        width, shift, layout, dev, seed=width + shift)
    cuda_lib.reset_launches()
    got_qkv = ve.bias(qkv[0], ve.prepare(qkv[1]))
    got_fc1 = ve.bias_gelu(fc1[0], ve.prepare(fc1[1]))
    got = run_vit_epilogue("residual", y, dense, x, norm, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.launches["vit_epilogue"] == 3
    for out, (raw, layer), form in ((got_qkv, qkv, "bias"),
                                    (got_fc1, fc1, "bias_gelu")):
        want = vit_layers(form, raw, layer, None, None, 0, False)[0]
        assert torch.equal(_bits(out), _bits(want))
    want = vit_layers("residual", y, dense, x, norm, **kw)
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    windows = kw["window"] if kw["norm_windowed"] else 0
    ulps = ln_ulps(got[1], want[1], want[0], norm, windows, shift, 1e-5)
    share = float((got[1] != want[1]).float().mean())
    print(f"{width} {layout} shift {shift}: LayerNorm output differs in "
          f"{share:.3e} of the elements, by at most {float(ulps.max())} "
          f"ulp of its largest term")
    assert float(ulps.max()) <= 1.0 and share <= LN_ULP_SHARE
    if kw["norm_windowed"]:
        ones = torch.ones((SWIN_B, *x.shape[1:3], 1), device=dev)
        pads = vit.window_partition(ones, SWIN_WINDOW, shift)[0][..., 0] == 0
        assert pads.any() and float(got[1][pads].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("width", [48, 120, 256, 1024, 1536])
def test_gpu_vit_epilogue_refuses_a_width_outside_the_set(width):
    """The residual form raises on a width outside (96, 192, 384, 768),
    a multiple of 24 or of 8 alike, and on a window shift outside [0,
    window): no fallback on the card."""
    from maskrcnn_tpu_torch.ops import vit_epilogue_cuda as ve
    dev = _card()
    bf = torch.bfloat16
    x = torch.randn((1, 9, 9, width), device=dev)
    dense = ve.DenseConstants(None, torch.zeros(width, device=dev, dtype=bf))
    with pytest.raises(ValueError, match="width of 96, 192, 384 or 768"):
        ve.bias_residual_norm(x.to(bf), dense, x)
    x = torch.randn((1, 9, 9, 96), device=dev)
    dense = ve.DenseConstants(None, torch.zeros(96, device=dev, dtype=bf))
    norm = {"scale": torch.ones(96, device=dev),
            "bias": torch.zeros(96, device=dev)}
    for shift in (-1, 7):
        with pytest.raises(ValueError, match="window shift"):
            ve.bias_residual_norm(x.to(bf), dense, x, norm, window=7,
                                  norm_windowed=True, shift=shift)


def swin_params_case(dev, side=1024, b=2, seed=13):
    """Swin-S's parameters on `dev` with LayerNorms and biases drawn off
    their init and bias tables of +-1.5 (as the benchmark's), and
    mean-subtracted images at `side`^2."""
    from maskrcnn_tpu_torch.models import swin
    g = torch.Generator().manual_seed(seed)
    params = off_identity(swin.init_swin(g, "swin_s"), g)
    params = {k: {w: t.to(dev) for w, t in p.items()}
              for k, p in params.items()}
    images = (torch.rand((b, side, side, 3), generator=g) * 255 - 120)
    return params, images.to(dev)


# The fused Swin-S against the layers on the card, over C2..C5 (each a
# stage's output LayerNorm): as VIT_FORWARD_TOL, a LayerNorm output one
# bf16 ulp off moves the next linear's input, through up to 18 blocks
SWIN_FORWARD_TOL = 2 ** -4


@pytest.mark.gpu
def test_gpu_swin_fused_route_matches_layers(monkeypatch):
    """`apply_swin` at 1024^2, batch 2, in bf16 on the card: the fused route
    (96 passes: 4 a block, a stage's first LN1 the layers'; 24 card
    attention calls) against the layers (gate closed, no pass) over
    C2..C5, within SWIN_FORWARD_TOL of the largest output; the largest
    and mean differences printed."""
    from maskrcnn_tpu_torch.models import swin
    from maskrcnn_tpu_torch.ops import attention
    from maskrcnn_tpu_torch.ops import vit_epilogue_cuda as ve
    dev = _card()
    params, images = swin_params_case(dev)
    cuda_lib.reset_launches()
    attention.reset_calls()
    with torch.no_grad():
        got = swin.apply_swin(params, images, "swin_s")
    torch.cuda.synchronize()
    assert cuda_lib.launches["vit_epilogue"] == 96
    assert attention.calls == {"card": 24, "plain": 0}
    monkeypatch.setattr(ve, "epilogue_supported", lambda *a: False)
    cuda_lib.reset_launches()
    with torch.no_grad():
        want = swin.apply_swin(params, images, "swin_s")
    torch.cuda.synchronize()
    assert cuda_lib.launches["vit_epilogue"] == 0
    for level, (gt, w) in enumerate(zip(got, want), 2):
        assert gt.dtype == w.dtype == torch.bfloat16
        assert gt.shape == w.shape
        big = float(w.float().abs().max())
        err = (gt.float() - w.float()).abs()
        print(f"C{level}: largest difference {float(err.max()):.4e}, mean "
              f"{float(err.mean()):.4e}, largest output {big:.4e}")
        assert float(err.max()) <= SWIN_FORWARD_TOL * big
        assert float(err.mean()) <= SWIN_FORWARD_TOL / 10 * big


def vit_case(dev, side=1024, b=2, seed=11):
    """ViT-B's parameters at `side`^2 on `dev` with LayerNorms off the
    identity and non-zero relative positions, and mean-subtracted
    images."""
    from maskrcnn_tpu_torch.models import vit
    g = torch.Generator().manual_seed(seed)
    params = vit.init_vit(g, "vitdet_b", (side, side))
    for name, p in params.items():
        if "norm" in name:
            c = p["scale"].shape[0]
            p["scale"] = torch.rand(c, generator=g) + 0.5
            p["bias"] = torch.randn(c, generator=g) * 0.2
        if name.endswith("rel_pos"):
            for k in p:
                p[k] = torch.randn(p[k].shape, generator=g) * 0.1
    params = {k: {w: t.to(dev) for w, t in p.items()}
              for k, p in params.items()}
    images = (torch.rand((b, side, side, 3), generator=g) * 255 - 120)
    return params, images.to(dev)


# The fused ViT-B against the layers on the card, over P2-P6 (LayerNormed,
# std ~1): the LayerNorm outputs that differ by one bf16 ulp (under
# LN_ULP_SHARE of them) move the next linear's input, and the difference
# travels through 12 blocks and the pyramid's bf16 convs: the largest
# stays under this share of the largest output, the mean under a tenth of
# it (on an H100: largest 0.0625 against an output of 7.125, means
# 4.2e-3 to 5.7e-3)
VIT_FORWARD_TOL = 2 ** -4


@pytest.mark.gpu
def test_gpu_vit_fused_route_matches_layers(monkeypatch):
    """`apply_vit` at 1024^2, batch 2, in bf16 on the card: the fused route
    (48 passes: 4 a block, block 0's LN1 the layers') against the layers
    (gate closed, no pass) over P2-P6, within VIT_FORWARD_TOL of the
    largest output; the largest and mean differences printed."""
    from maskrcnn_tpu_torch.models import vit
    from maskrcnn_tpu_torch.ops import vit_epilogue_cuda as ve
    dev = _card()
    params, images = vit_case(dev)
    cuda_lib.reset_launches()
    with torch.no_grad():
        got = vit.apply_vit(params, images, "vitdet_b")
    torch.cuda.synchronize()
    assert cuda_lib.launches["vit_epilogue"] == 48
    monkeypatch.setattr(ve, "epilogue_supported", lambda *a: False)
    cuda_lib.reset_launches()
    with torch.no_grad():
        want = vit.apply_vit(params, images, "vitdet_b")
    torch.cuda.synchronize()
    assert cuda_lib.launches["vit_epilogue"] == 0
    for level, (gt, w) in enumerate(zip(got, want), 2):
        assert gt.dtype == w.dtype == torch.bfloat16
        assert gt.shape == w.shape
        big = float(w.float().abs().max())
        err = (gt.float() - w.float()).abs()
        print(f"P{level}: largest difference {float(err.max()):.4e}, mean "
              f"{float(err.mean()):.4e}, largest output {big:.4e}")
        assert float(err.max()) <= VIT_FORWARD_TOL * big
        assert float(err.mean()) <= VIT_FORWARD_TOL / 10 * big


@pytest.mark.gpu
@pytest.mark.parametrize("arch,passes", [("vitdet_b", 48), ("resnet101", 0),
                                         ("mobilenetv2", 0), ("swin_s", 96)])
def test_gpu_forward_vit_epilogue_launches(arch, passes):
    """One bf16 forward on the card launches the ViT epilogue four times a
    ViT-B block but block 0's LN1 (48), four times a Swin-S block (96);
    R101 and MobileNetV2 never."""
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    dev = _card()
    cfg = _tiny(architecture=arch)
    params = M.init_mask_rcnn(torch.Generator().manual_seed(0), cfg)
    images = torch.rand((1, 128, 128, 3),
                        generator=torch.Generator().manual_seed(1)) * 255
    cuda_lib.reset_launches()
    M.forward(params, images, cfg, device=dev)
    torch.cuda.synchronize()
    assert cuda_lib.launches["vit_epilogue"] == passes


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
    feats, ys, xs, level, valid_r, n = roi_case(dtype=torch.bfloat16)
    roi = ([f.to(dev) for f in feats], ys.to(dev), xs.to(dev),
           level.to(dev), valid_r.to(dev), n)
    hf, hp, hn, head, _ = head_case(n=20, dtype=torch.bfloat16)
    hargs = ([f.to(dev) for f in hf], *[t.to(dev) for t in hp], hn)
    head = {k: v.to(dev) for k, v in head.items()}
    mf, mp, mn, mask, ids = head_case(b=2, n=37, crop=14,
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
    x, blocks = chain_case()
    x = x.to(dev)
    blocks = [{k: v.to(dev) for k, v in b.items()} for b in blocks]
    y, layer, res, short, _ = epilogue_case(dev=dev)
    ep = conv_epilogue_cuda
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
        "conv_epilogue": (
            (y, *layer[1:], res, *short[1:]),
            lambda: ep.conv_epilogue(y, layer, res, short),
            lambda: ep.epilogue_plain(y, *layer[1:], res, *short[1:]),
            0.0, 1),
    }


OP_FAMILY = {"nms_keep": "nms", "bottleneck_chain": "bottleneck"}
OPS = ("nms_keep", "roi_align", "roi_classifier_head", "roi_mask_head",
       "stem", "bottleneck_chain", "conv_epilogue")
PLAINS = {"nms_keep": (nms_cuda, "nms_keep_plain"),
          "roi_align": (roi_align_cuda, "roi_align_plain"),
          "roi_classifier_head": (roi_align_cuda, "classifier_head_plain"),
          "roi_mask_head": (roi_align_cuda, "mask_head_plain"),
          "stem": (stem_cuda, "stem_plain"),
          "bottleneck_chain": (bottleneck_cuda, "chain_plain"),
          "conv_epilogue": (conv_epilogue_cuda, "epilogue_plain")}


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
    if name in ("nms_keep", "conv_epilogue"):
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
    live_bn(params, gen)
    images = torch.rand((2, 128, 128, 3), generator=gen) * 255
    want = M.to_numpy(M.forward(params, images, cfg, device="cpu"))
    cuda_lib.reset_launches()
    got = M.to_numpy(M.forward(params, images, cfg, device=dev))
    launches = dict(cuda_lib.launches)
    assert launches["nms"] == 2 and launches["roi_align"] == 2
    assert launches["stem"] == launches["bottleneck"] == 0
    assert launches["conv_epilogue"] == 0
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
    live_bn(params, gen)
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


# --------------------------------------------------------------------------
# ViTDet's biased attention (ops/attention.py)
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("block", ["window", "global"])
def test_gpu_rel_pos_attention_card_route_matches_float32(block):
    """The card route (bfloat16 SDPA on the augmented q', k') against the
    float32 plain route on the same bfloat16-rounded q, k, v, at
    `vitdet_b.batch8`'s shapes: 25 windows of 14x14 per image, or the
    64x64 grid (two images: the global case is per image alike). The
    gap is bfloat16's: rel_h and rel_w rounded into q' (2^-9 of a bias
    up to ~4), the probabilities and the output rounded to it; the
    largest may reach 2^-7 of the largest output, the mean stays near
    2^-11 of it. Dropping the bias moves the output by far more."""
    from maskrcnn_tpu_torch.ops import attention as A
    dev = _card()
    n, grid = (50, 14) if block == "window" else (2, 64)
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((n, 12, grid * grid, 64), generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    th, tw = (torch.rand((2 * grid - 1, 64), generator=g, device=dev) * 0.3
              - 0.15 for _ in range(2))
    scale = 64 ** -0.5
    got = A.rel_pos_attention(q, k, v, th, tw, (grid, grid), scale)
    assert got.dtype == torch.bfloat16 and got.shape == v.shape
    want = torch.cat([A._plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], th, tw,
                               (grid, grid), scale) for i in range(n)])
    big = float(want.abs().max())
    err = (got.float() - want).abs()
    assert float(err.max()) <= 2 ** -7 * big, float(err.max()) / big
    assert float(err.mean()) <= 2 ** -10 * big, float(err.mean()) / big
    unbiased = A._plain(q[:1], k[:1], v[:1], th * 0, tw * 0, (grid, grid),
                        scale)
    assert float((unbiased - want[:1]).abs().mean()) > 8 * float(
        err[:1].mean())


# --------------------------------------------------------------------------
# Swin's window attention (ops/attention.py)
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("stage", ["stage1", "stage3"])
def test_gpu_window_attention_card_route_matches_float32(stage, shifted):
    """The card route (one bfloat16 SDPA call, the table and the region
    mask folded into one additive mask) against the float32 plain route on
    the same bfloat16-rounded q, k, v, at `swin_s.batch8`'s shapes: 8
    images of stage 1's 1369 windows, 3 heads, or stage 3's 100 windows,
    12 heads, 49 tokens of 32 channels. The gap is bfloat16's: the bias
    rounded into the mask (2^-9 of a bias up to 1.5), the probabilities
    and the output rounded to it; the largest may reach 2^-7 of the
    largest output, the mean stays near 2^-11 of it. Dropping the table,
    or in a shifted block the region mask (the roll kept), moves the
    output out of both bounds' reach."""
    from maskrcnn_tpu_torch.ops import attention as A
    from maskrcnn_tpu_torch.tools.probe_attention import swin_case
    _card()
    grid, heads = {"stage1": (256, 3), "stage3": (64, 12)}[stage]
    case = swin_case(8, grid, heads, shifted, seed=7)
    q, k, v, table, window, scale, regions = case
    A.reset_calls()
    got = A.window_attention(*case)
    assert A.calls == {"card": 1, "plain": 0}
    assert got.dtype == torch.bfloat16 and got.shape == v.shape
    want = torch.cat([A._window_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                      table, window, scale, regions)
                      for i in range(8)])
    big = float(want.abs().max())

    def within(out):
        err = (out.float() - want).abs()
        return (float(err.max()) <= 2 ** -7 * big,
                float(err.mean()) <= 2 ** -10 * big)

    assert within(got) == (True, True)
    assert within(A.window_attention(q, k, v, table * 0, window, scale,
                                     regions)) != (True, True)
    if shifted:
        assert within(A.window_attention(q, k, v, table, window, scale,
                                         None)) != (True, True)
