"""ViTDet-B in the port (`models/vit.py`, `ops/attention.py`) on the CPU, at
ViT-B's published widths and depth and a 256^2 input (a 16x16 grid: the
windowed blocks pad it to 28x28, four 14x14 windows, 144 padded tokens):
the pyramid and the whole forward against the benchmark's plain float32
reference (`benchmark/reference/backbones/vitdet_b.py`, which imports
nothing of the port) on the benchmark's seeded weights; the attention
against a per-head loop written from the equations; the bias and the
global blocks shown to matter; the detector, the spans, the config
check, the weight files and the training guard.

One intra-op thread, by `tests/torch_support.py`'s rule."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import model as R
from benchmark.weights import make_params
from maskrcnn_tpu_torch.core.config import MaskRCNNConfig, tiny_test_config
from maskrcnn_tpu_torch.io import weights as W
from maskrcnn_tpu_torch.models import mask_rcnn as M
from maskrcnn_tpu_torch.models import vit
from maskrcnn_tpu_torch.ops import attention as A
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from tests.torch_support import one_thread  # noqa: F401  (autouse)

SEED = 2 ** 31 + 19
# float32 on both sides: the port and the reference sum in other orders
# (F.linear against matmul, F.layer_norm against its formula, the
# einsums' contractions) through 12 blocks and the pyramid; their
# LayerNormed outputs (std ~1, |max| ~5) part by 1.2e-5 at this file's
# seed, so 1e-4 leaves 8x room, and anything that changes the arithmetic
# moves them by orders more.
PYRAMID_ATOL = 1e-4


def config(size=256, **kw):
    return tiny_test_config().replace(
        architecture="vitdet_b", input_image_shape=(size, size, 3),
        compute_dtype="float32", detection_score_threshold=0.0, **kw)


@pytest.fixture(scope="module")
def case():
    cfg = config()
    params = make_params(cfg, SEED, "cpu")
    images = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 256, 256, 3), dtype=np.uint8))
    out = M.forward(params, images, cfg, device="cpu", with_features=True)
    ref = R.backbone_fpn(params, images, cfg, R.Numerics("float32"))
    return cfg, params, images, out, ref


def port_pyramid(params, images, cfg):
    x = M.preprocess(images, cfg)
    return M.backbone_fpn(params, x, cfg, torch.float32)


def pyramid_gap(got, ref) -> float:
    return max(float((g.permute(0, 3, 1, 2) - r).abs().max())
               for g, r in zip(got, ref))


def test_pyramid_matches_the_reference(case):
    cfg, _, _, out, ref = case
    assert [tuple(p.shape[1:3]) for p in out["pyramid"]] == \
        list(cfg.feature_shapes)
    assert all(p.shape[-1] == 256 for p in out["pyramid"])
    assert pyramid_gap(out["pyramid"], ref) <= PYRAMID_ATOL


def test_forward_matches_the_references_detect(case):
    """The reference's own pipeline from the same weights gives the port's
    proposals, detections and masks (float32 both)."""
    cfg, params, images, out, _ = case
    want = R.detect(params, images, cfg, R.Numerics("float32"))
    assert out["valid"].any()
    assert torch.equal(want["valid"], out["valid"])
    assert torch.equal(want["roi_valid"], out["roi_valid"])
    torch.testing.assert_close(want["rois"], out["rois"], atol=1e-5, rtol=0)
    torch.testing.assert_close(want["detections"], out["detections"],
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(want["masks"], out["masks"], atol=1e-4,
                               rtol=0)


def _windowed_everywhere(monkeypatch):
    """Every block windowed: the global blocks' tables cut to the rows of
    the window's offsets (the middle 2 * 14 - 1)."""
    spec = vit.VIT["vitdet_b"]
    monkeypatch.setitem(vit.VIT, "vitdet_b", spec._replace(global_blocks=()))
    orig = vit.rel_pos_attention

    def windowed(q, k, v, th, tw, hw, scale):
        c, r = th.shape[0] // 2, hw[0] - 1
        return orig(q, k, v, th[c - r:c + r + 1], tw[c - r:c + r + 1], hw,
                    scale)
    monkeypatch.setattr(vit, "rel_pos_attention", windowed)


def _no_bias(monkeypatch):
    orig = vit.rel_pos_attention
    monkeypatch.setattr(vit, "rel_pos_attention",
                        lambda q, k, v, th, tw, hw, scale: orig(
                            q, k, v, th * 0, tw * 0, hw, scale))


@pytest.mark.parametrize("broken", [_no_bias, _windowed_everywhere],
                         ids=["bias_dropped", "global_run_windowed"])
def test_a_broken_attention_leaves_the_tolerance(case, monkeypatch, broken):
    cfg, params, images, _, ref = case
    broken(monkeypatch)
    assert pyramid_gap(port_pyramid(params, images, cfg), ref) > \
        100 * PYRAMID_ATOL


# --------------------------------------------------------------------------
# The attention against the equations
# --------------------------------------------------------------------------

def naive_attention(q, k, v, th, tw, grid, scale):
    """Per head, per query token: scale q.k + q.Rh + q.Rw over every key,
    softmax, times v; the bias from the unscaled q. (n, heads, T, d)."""
    h, w = grid
    out = torch.zeros_like(v, dtype=torch.float64)
    q, k, v, th, tw = (t.double() for t in (q, k, v, th, tw))
    for a in range(q.shape[1]):
        for t in range(h * w):
            i, j = divmod(t, w)
            logits = torch.zeros((q.shape[0], h * w), dtype=torch.float64)
            for s in range(h * w):
                kh, kw = divmod(s, w)
                logits[:, s] = (scale * (q[:, a, t] * k[:, a, s]).sum(-1)
                                + (q[:, a, t] * th[i - kh + h - 1]).sum(-1)
                                + (q[:, a, t] * tw[j - kw + w - 1]).sum(-1))
            out[:, a, t] = torch.einsum("ns,nsd->nd",
                                        torch.softmax(logits, -1), v[:, a])
    return out


@pytest.mark.parametrize("grid", [(3, 3), (2, 4)])
def test_attention_is_the_equations(grid):
    g = torch.Generator().manual_seed(1)
    h, w = grid
    q, k, v = (torch.randn((2, 3, h * w, 8), generator=g) for _ in range(3))
    th = torch.randn((2 * h - 1, 8), generator=g) * 0.5
    tw = torch.randn((2 * w - 1, 8), generator=g) * 0.5
    got = A.rel_pos_attention(q, k, v, th, tw, grid, 8 ** -0.5)
    want = naive_attention(q, k, v, th, tw, grid, 8 ** -0.5)
    assert float((got.double() - want).abs().max()) <= 1e-5
    scaled = naive_attention(q, k, v, th * 8 ** -0.5, tw * 8 ** -0.5, grid,
                             8 ** -0.5)
    assert float((got.double() - scaled).abs().max()) > 1e-2


def naive_block(x, params, i, spec, windowed):
    """x + proj(attn(LN1(x))) from the equations: LN1(x) zero-padded to a
    multiple of the window, every window's tokens (padding too) through
    qkv, `naive_attention` per window, proj, the padding cropped."""
    b, h, w, c = x.shape
    p = f"vit_b{i}_"
    y = torch.nn.functional.layer_norm(x, (c,), params[p + "norm1"]["scale"],
                                       params[p + "norm1"]["bias"], 1e-6)
    wh, ww = (spec.window, spec.window) if windowed else (h, w)
    hp, wp = math.ceil(h / wh) * wh, math.ceil(w / ww) * ww
    y = torch.nn.functional.pad(y, (0, 0, 0, wp - w, 0, hp - h))
    out = torch.zeros((b, hp, wp, c))
    hd = c // spec.heads
    rel = params[p + "attn_rel_pos"]
    for bi in range(b):
        for y0 in range(0, hp, wh):
            for x0 in range(0, wp, ww):
                t = y[bi, y0:y0 + wh, x0:x0 + ww].reshape(-1, c)
                qkv = t @ params[p + "attn_qkv"]["kernel"] + \
                    params[p + "attn_qkv"]["bias"]
                q, k, v = qkv.view(-1, 3, spec.heads, hd).permute(1, 2, 0, 3)
                o = naive_attention(q[None], k[None], v[None],
                                    rel["rel_pos_h"], rel["rel_pos_w"],
                                    (wh, ww), hd ** -0.5)[0].float()
                o = o.permute(1, 0, 2).reshape(-1, c) @ \
                    params[p + "attn_proj"]["kernel"] + \
                    params[p + "attn_proj"]["bias"]
                out[bi, y0:y0 + wh, x0:x0 + ww] = o.view(wh, ww, c)
    return x + out[:, :h, :w]


@pytest.mark.parametrize("windowed", [True, False],
                         ids=["windowed", "global"])
def test_block_attention_is_the_equations(windowed):
    """A block at a small width, on a 5x6 grid: windowed (window 4, padded
    to 8x8, padded tokens attending and attended) or global."""
    spec = vit.ViTSpec(width=16, depth=1, heads=2, mlp=32, patch=16,
                       window=4, global_blocks=() if windowed else (0,),
                       pretrain_grid=14, pyramid=(8, 8, 16, 16))
    g = torch.Generator().manual_seed(2)
    rows = 2 * spec.window - 1 if windowed else (2 * 5 - 1, 2 * 6 - 1)
    rh, rw = (rows, rows) if windowed else rows
    params = {"vit_b0_norm1": {"scale": torch.rand(16, generator=g) + 0.5,
                               "bias": torch.randn(16, generator=g) * 0.1},
              "vit_b0_attn_qkv": {"kernel": torch.randn((16, 48),
                                                        generator=g) * 0.3,
                                  "bias": torch.randn(48, generator=g)},
              "vit_b0_attn_proj": {"kernel": torch.randn((16, 16),
                                                         generator=g) * 0.3,
                                   "bias": torch.randn(16, generator=g)},
              "vit_b0_attn_rel_pos": {
                  "rel_pos_h": torch.randn((rh, 8), generator=g) * 0.3,
                  "rel_pos_w": torch.randn((rw, 8), generator=g) * 0.3}}
    x = torch.randn((2, 5, 6, 16), generator=g)
    got = vit._attention(x, params, spec, 0, torch.float32)
    want = naive_block(x, params, 0, spec, windowed)
    assert float((got - want).abs().max()) <= 1e-4
    if windowed:
        # the qkv bias gives the padded keys a value: masking them moves
        # the result, so the comparison above sees whether they attend
        zeroed = dict(params, vit_b0_attn_qkv={
            "kernel": params["vit_b0_attn_qkv"]["kernel"],
            "bias": torch.zeros(48)})
        assert float((vit._attention(x, zeroed, spec, 0, torch.float32)
                      - got).abs().max()) > 1e-2


def test_window_partition_round_trip():
    x = torch.randn((2, 16, 16, 4))
    wins, padded = vit.window_partition(x, 14)
    assert wins.shape == (8, 14, 14, 4) and padded == (28, 28)
    assert float(wins[1, :, 2:].abs().max()) == 0.0   # the padded columns
    assert torch.equal(vit.window_unpartition(wins, 14, padded, (16, 16)), x)


# --------------------------------------------------------------------------
# Through the port's entry points
# --------------------------------------------------------------------------

def test_detector_runs_vitdet_on_the_cpu():
    cfg = config(size=128)
    det = MaskRCNNDetector.from_random(cfg, seed=4, device="cpu")
    images = np.random.default_rng(6).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    out = det.run_batch(images)
    assert out["detections"].shape == (2, cfg.max_detections, 6)
    assert out["masks"].shape == (2, cfg.max_detections, 28, 28)
    assert bool(torch.isfinite(out["masks"]).all())


def test_forward_spans_the_vit_inside_backbone_fpn():
    cfg = config(size=128)
    params = M.init_mask_rcnn(torch.Generator().manual_seed(0), cfg)
    images = torch.zeros((1, 128, 128, 3), dtype=torch.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        M.forward(params, images, cfg, device="cpu")
    counts = {}
    for e in prof.events():
        if not e.name.startswith("vit."):
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name != "backbone_fpn":
            parent = parent.cpu_parent
        assert parent is not None, e.name
        counts[e.name] = counts.get(e.name, 0) + 1
    assert counts == {"vit.patch_embed": 1, "vit.window_attention": 8,
                      "vit.global_attention": 4, "vit.mlp": 12,
                      "vit.pyramid": 1}


def test_config_rejects_an_input_off_the_patch_grid():
    from maskrcnn_tpu_torch.core.config import _VIT_PATCH
    assert _VIT_PATCH == {a: s.patch for a, s in vit.VIT.items()}
    with pytest.raises(ValueError, match="patch size 16"):
        MaskRCNNConfig(architecture="vitdet_b",
                       input_image_shape=(1000, 1000, 3))
    MaskRCNNConfig(architecture="vitdet_b")


def test_weight_files_round_trip(tmp_path):
    """npz and h5 give the param dict back; the pyramid's deconvs are
    stored as Keras Conv2DTranspose kernels (kh, kw, out, in)."""
    h5py = pytest.importorskip("h5py")
    cfg = config(size=128)
    params = M.init_mask_rcnn(torch.Generator().manual_seed(1), cfg)
    flat = W.params_to_numpy(params)
    W.save_npz_checkpoint(params, str(tmp_path / "w.npz"))
    W.save_h5_weights(params, str(tmp_path / "w.h5"))
    for loaded in (W.load_npz_checkpoint(str(tmp_path / "w.npz")),
                   W.load_h5_weights(str(tmp_path / "w.h5"))):
        assert sorted(loaded) == sorted(flat)
        for layer, weights in flat.items():
            assert sorted(loaded[layer]) == sorted(weights), layer
            for name, arr in weights.items():
                assert np.array_equal(loaded[layer][name], arr), (layer, name)
    with h5py.File(tmp_path / "w.h5", "r") as f:
        stored = f["sfp_p2_deconv1/sfp_p2_deconv1/kernel:0"].shape
    assert stored == (2, 2, 384, 768)


def test_training_raises_naming_the_architecture():
    from maskrcnn_tpu_torch.train.data import synthetic_train_batch
    from maskrcnn_tpu_torch.train.step import (compute_losses,
                                               draw_uniforms)
    cfg = config(size=128)
    params = M.init_mask_rcnn(torch.Generator().manual_seed(2), cfg)
    batch = synthetic_train_batch(cfg, 1, "cpu")
    anchors = M.anchor_table(cfg, torch.device("cpu"))
    draws = draw_uniforms(torch.Generator().manual_seed(0), 1,
                          cfg.num_anchors, cfg.max_proposals + 8, "cpu")
    with pytest.raises(ValueError, match="vitdet_b"):
        compute_losses(params, batch, anchors, cfg, draws)
