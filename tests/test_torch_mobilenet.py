"""MobileNetV2-FPN in the port against the JAX package on the CPU, float32:
the init's names and shapes, the backbone's C2-C5 (at 64^2 and at an odd
72 x 88, where TF SAME padding is asymmetric), the whole forward, the
`mbv2_*` layers through the weight bridge, the training losses with the
JAX package's draws, and one inverted-residual block's batch-BN gradients.
Inputs come from numpy seeds; the params are the JAX package's own, with
every BN's statistics redrawn from a seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskrcnn_tpu.core.anchors import generate_anchors as jax_anchors
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
from maskrcnn_tpu.io import weights as jax_weights
from maskrcnn_tpu.models import mask_rcnn as jax_model
from maskrcnn_tpu.models import mobilenet as jax_mbv2
from maskrcnn_tpu.train import step as jax_step
from maskrcnn_tpu_torch.core.anchors import generate_anchors as pt_anchors
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.io import weights as pt_weights
from maskrcnn_tpu_torch.models import mask_rcnn as pt_model
from maskrcnn_tpu_torch.models import mobilenet as pt_mbv2
from maskrcnn_tpu_torch.ops import cuda_lib
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from maskrcnn_tpu_torch.train import step as pt_step
from tests.torch_support import (TOL, crowd_batch, jax_draws, jax_tree,
                                 jit_live_bn_params, t)
from tests.torch_support import one_thread  # noqa: F401  (autouse)

MBV2 = dict(architecture="mobilenetv2", compute_dtype="float32",
            detection_score_threshold=0.25)
BATCH_BN = {"use_batch_stats": True, "collect": None}


def _shapes(params):
    return {k: {w: tuple(v.shape) for w, v in d.items()}
            for k, d in params.items()}


@pytest.fixture(scope="module")
def flat():
    return jit_live_bn_params(3, jax_tiny().replace(**MBV2))


def test_init_names_and_shapes_match_jax():
    """The backbone's `mbv2_*` layers (no expand conv where t == 1) and the
    whole model's, FPN laterals at (24, 32, 96, 320) channels; the stem
    kernel scaled by 1/128 at init."""
    gen = torch.Generator().manual_seed(0)
    bb = pt_mbv2.init_mobilenetv2(gen)
    assert _shapes(bb) == _shapes(jax.eval_shape(
        jax_mbv2.init_mobilenetv2, jax.random.PRNGKey(0)))
    assert "mbv2_g0b0_expand" not in bb and "mbv2_g1b0_expand" in bb
    assert float(bb["mbv2_stem"]["kernel"].std()) < 0.02
    cfg = pt_tiny().replace(architecture="mobilenetv2")
    pt = pt_model.init_mask_rcnn(gen, cfg)
    jx = jax.eval_shape(lambda k: jax_model.init_mask_rcnn(
        k, jax_tiny().replace(architecture="mobilenetv2")),
        jax.random.PRNGKey(0))
    assert _shapes(pt) == _shapes(jx)
    assert pt["fpn_c5p5"]["kernel"].shape == (1, 1, 320, 256)


@pytest.mark.parametrize("hw", [(64, 64), (72, 88)])
def test_backbone_c2_c5_match_jax(flat, hw):
    x = np.random.default_rng(hw[1]).uniform(
        -120, 130, (2, *hw, 3)).astype(np.float32)
    want = jax_mbv2.apply_mobilenetv2(jax_tree(flat), jnp.asarray(x),
                                      dtype=jnp.float32)
    got = pt_mbv2.apply_mobilenetv2(pt_weights.params_from_numpy(flat),
                                    torch.from_numpy(x), dtype=torch.float32)
    strides = (4, 8, 16, 32)
    for w, g, s in zip(want, got, strides):
        assert g.shape == w.shape == (2, -(-hw[0] // s), -(-hw[1] // s),
                                      g.shape[-1])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.fixture(scope="module")
def forwards(flat):
    images = np.random.default_rng(1).uniform(
        0, 255, (2, 128, 128, 3)).astype(np.float32)
    jcfg = jax_tiny().replace(**MBV2)
    want = jax_model.forward(jax_tree(flat), jnp.asarray(images),
                             jnp.asarray(jax_anchors(jcfg)), jcfg)
    want = jax.tree_util.tree_map(np.asarray, want)
    cuda_lib.reset_launches()
    got = pt_model.to_numpy(pt_model.forward(
        pt_weights.params_from_numpy(flat), torch.from_numpy(images),
        pt_tiny().replace(**MBV2), device="cpu"))
    return want, got, images


def test_forward_matches_jax(forwards):
    """Proposal and detection decisions exact, values within the ResNet
    forward's tolerances (`tests/test_torch_model.py`)."""
    want, got, _ = forwards
    np.testing.assert_array_equal(got["roi_valid"], want["roi_valid"])
    np.testing.assert_allclose(got["rois"], want["rois"], **TOL)
    assert want["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["detections"][..., 4],
                                  want["detections"][..., 4])
    np.testing.assert_allclose(got["detections"], want["detections"], **TOL)
    np.testing.assert_allclose(got["masks"], want["masks"], **TOL)
    assert not any(cuda_lib.launches.values())


def test_fused_heads_on_cpu_match_unfused(flat, forwards):
    """Both fused-head flags on the CPU (K5 and K6's plain versions): in
    float32 the same detections and masks as the layer-by-layer heads."""
    _, got, images = forwards
    cfg = pt_tiny().replace(fuse_classifier_head=True, fuse_mask_head=True,
                            **MBV2)
    fused = pt_model.to_numpy(pt_model.forward(
        pt_weights.params_from_numpy(flat), torch.from_numpy(images), cfg,
        device="cpu"))
    np.testing.assert_array_equal(fused["valid"], got["valid"])
    np.testing.assert_allclose(fused["detections"], got["detections"], **TOL)
    np.testing.assert_allclose(fused["masks"], got["masks"], **TOL)


def test_mbv2_layers_cross_the_weight_bridge(flat, tmp_path):
    """A JAX-written `.npz` of MobileNetV2-FPN loads into the port's
    detector with every layer present, and back."""
    path = str(tmp_path / "mbv2.npz")
    jax_weights.save_npz_checkpoint(flat, path)
    cfg = pt_tiny().replace(**MBV2)
    det = MaskRCNNDetector.from_checkpoint(cfg, path, device="cpu")
    assert _shapes(det.params) == _shapes(flat)
    for layer in ("mbv2_stem", "mbv2_g6b0_project_bn", "fpn_c2p2"):
        for w, v in flat[layer].items():
            np.testing.assert_array_equal(det.params[layer][w].numpy(), v)
    back = str(tmp_path / "back.npz")
    pt_weights.save_npz_checkpoint(det.params, back)
    loaded = jax_weights.load_npz_checkpoint(back)
    assert _shapes(loaded) == _shapes(flat)


def test_frozen_bn_losses_match_jax(flat):
    """`compute_losses` at MobileNetV2-FPN, frozen BN, float32, with the
    JAX package's draws: the five losses within the bounds of
    `tests/test_torch_train.py` (rtol 1e-4, atol 1e-6);
    `train_fused_kernels` is ignored here (K3 and K4 are ResNet's)."""
    overrides = dict(MBV2, train_bn="frozen", train_sampling_topk="exact")
    jcfg = jax_tiny().replace(**overrides)
    pcfg = pt_tiny().replace(train_fused_kernels=True, **overrides)
    batch = crowd_batch(np.random.default_rng(5), jcfg)
    anchors = jax_anchors(jcfg)
    key = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jm = jax.jit(lambda p: jax_step.compute_losses(
        p, jb, jnp.asarray(anchors), jcfg, key))(jax_tree(flat))
    pool = jcfg.max_proposals + batch["gt_boxes"].shape[1]
    draws = {k: t(v) for k, v in jax_draws(key, 2, anchors.shape[0],
                                           pool).items()}
    _, pm = pt_step.compute_losses(
        pt_weights.params_from_numpy(flat),
        {k: t(v) for k, v in batch.items()}, t(pt_anchors(pcfg)), pcfg,
        draws)
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_train_step_runs_with_fused_head_flags(flat):
    """A batch-BN `train_step` at MobileNetV2-FPN with both fused-head
    flags set (training takes the unfused heads, as the JAX package does)
    moves every layer it trains, the depthwise ones included."""
    cfg = pt_tiny().replace(fuse_classifier_head=True, fuse_mask_head=True,
                            **MBV2)
    batch = crowd_batch(np.random.default_rng(7), cfg, b=1)
    state, opt = pt_step.make_train_state(
        pt_weights.params_from_numpy(flat), cfg)
    new, metrics = pt_step.train_step(state, batch, pt_anchors(cfg), cfg,
                                      opt, seed=2)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for layer in ("mbv2_stem", "mbv2_g1b0_dw", "mbv2_g6b0_project",
                  "fpn_c2p2", "mrcnn_mask"):
        moved = (new.params[layer]["kernel"]
                 - state.params[layer]["kernel"]).abs().max()
        assert float(moved) > 0, layer


@pytest.mark.parametrize("block,stride,hw", [("g1b0", 2, (16, 16)),
                                             ("g2b1", 1, (8, 8))])
def test_batch_bn_block_grads_match_jax(flat, block, stride, hw):
    """One inverted-residual block with batch statistics, as
    `tests/test_torch_train.py` holds ResNet's modules one by one: g1b0
    (expand 16 -> 96, depthwise stride 2 with its asymmetric SAME pad) and
    g2b1 (stride 1, the residual). Every leaf within 1% of its largest JAX
    gradient, and JAX itself moves by under 1% when the input changes by
    +-2^-18; the conv biases that a batch BN follows get ~0 in both."""
    gi = int(block[1])
    t_, c, _, _ = jax_mbv2._GROUPS[gi]
    cin = jax_mbv2._GROUPS[gi - 1][1] if block.endswith("b0") else c
    base = f"mbv2_{block}"
    layers = [k for k in flat if k.startswith(base + "_")]
    sub = {k: flat[k] for k in layers}
    rng = np.random.default_rng(gi)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)

    def jfn(p, xx):
        return jax_mbv2._block(xx, p, base, t_, c, stride, jnp.float32,
                               BATCH_BN)

    out = jfn(jax_tree(sub), jnp.asarray(x))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    jgrad = jax.jit(jax.grad(lambda p, xx: jnp.sum(jfn(p, xx) * cot)))
    jg = jax.tree_util.tree_map(np.asarray, jgrad(jax_tree(sub),
                                                  jnp.asarray(x)))
    moved = [jax.tree_util.tree_map(np.asarray, jgrad(
        jax_tree(sub), jnp.asarray(x * np.float32(1 + s * 2 ** -18))))
        for s in (1, -1)]
    pp = pt_weights.params_from_numpy(sub)
    leaves = [(k, w) for k, d in pp.items() for w in d
              if not w.startswith("moving")]
    for k, w in leaves:
        pp[k][w].requires_grad_(True)
    y = pt_mbv2._block(torch.from_numpy(x), pp, base, t_, c, stride,
                       torch.float32, BATCH_BN)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), **TOL)
    got = torch.autograd.grad((y * t(cot)).sum(),
                              [pp[k][w] for k, w in leaves])
    for (layer, w), g in zip(leaves, got):
        want = jg[layer][w]
        if w == "bias" and layer + "_bn" in sub:
            k_scale = np.abs(jg[layer]["kernel"]).max()
            assert np.abs(want).max() <= 1e-3 * k_scale, (layer, "jax")
            assert g.abs().max() <= 1e-3 * k_scale, (layer, "port")
            continue
        scale = np.abs(want).max()
        spread = max(np.abs(m[layer][w] - want).max() for m in moved)
        assert scale > 0 and spread <= 1e-2 * scale, (layer, w)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-2 * scale, err_msg=f"{layer}/{w}")
