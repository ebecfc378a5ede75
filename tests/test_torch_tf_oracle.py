"""The port's TensorFlow oracle (`evalkit/tf_forward.py`) on the CPU: equal
to the JAX package's on the same numpy params (the same code on the same
TF, so tolerance 0), and the port's float32 forward held to it detection
by detection under the tolerances of `tests/test_tf_full_model.py`."""

import numpy as np
import jax
import pytest

tf = pytest.importorskip("tensorflow")

from maskrcnn_tpu.core.anchors import generate_anchors as jax_anchors  # noqa: E402
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny  # noqa: E402
from maskrcnn_tpu.evalkit import tf_forward as jax_tfm  # noqa: E402
from maskrcnn_tpu.models.mask_rcnn import init_mask_rcnn  # noqa: E402
from maskrcnn_tpu_torch.core.anchors import generate_anchors  # noqa: E402
from maskrcnn_tpu_torch.core.config import tiny_test_config  # noqa: E402
from maskrcnn_tpu_torch.evalkit import tf_forward as pt_tfm  # noqa: E402
from maskrcnn_tpu_torch.io.weights import params_from_numpy  # noqa: E402
from maskrcnn_tpu_torch.models import mask_rcnn as pt_model  # noqa: E402

# the oracle's numerics: float32, exact top-k, table anchors
EXACT = dict(compute_dtype="float32", proposal_topk_recall=None,
             analytic_anchors=False)


def _case(architecture):
    """JAX random params (key 3) as numpy and two smooth 128^2 images (seed
    42): the inputs of `tests/test_tf_full_model.py`."""
    jcfg = jax_tiny().replace(architecture=architecture, **EXACT)
    params = init_mask_rcnn(jax.random.PRNGKey(3), jcfg)
    params_np = {k: {kk: np.asarray(vv, np.float32) for kk, vv in v.items()}
                 for k, v in params.items()}
    rng = np.random.default_rng(42)
    base = rng.uniform(0, 255, (2, 16, 16, 3))
    images = np.kron(base, np.ones((1, 8, 8, 1)))[:, :128, :128, :]
    return jcfg, params_np, images.astype(np.float32)


@pytest.fixture(scope="module")
def resnet():
    jcfg, params_np, images = _case("resnet50")
    pcfg = tiny_test_config().replace(**EXACT)
    oracle = pt_tfm.tf_forward(params_np, images, generate_anchors(pcfg),
                               pcfg)
    return jcfg, pcfg, params_np, images, oracle


@pytest.mark.parametrize("architecture", ["resnet50", "mobilenetv2"])
def test_oracle_copy_equals_jax(architecture, resnet):
    """Port and JAX oracles on the same params, images and config values:
    every output bit-equal (mobilenetv2 through its backbone + FPN + RPN:
    random mnv2 heads saturate, `tests/test_tf_full_model.py`)."""
    if architecture == "resnet50":
        jcfg, pcfg, params_np, images, got = resnet
        want = jax_tfm.tf_forward(params_np, images,
                                  np.asarray(jax_anchors(jcfg)), jcfg)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        return
    jcfg, params_np, images = _case(architecture)
    x = tf.constant(images - np.asarray(jcfg.mean_pixel, np.float32))
    pyr_p = pt_tfm._backbone_fpn(tf, params_np, x, architecture)
    pyr_j = jax_tfm._backbone_fpn(tf, params_np, x, architecture)
    for a, b in zip(pyr_p, pyr_j):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(pt_tfm._rpn(tf, params_np, pyr_p),
                    jax_tfm._rpn(tf, params_np, pyr_j)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_port_forward_matches_oracle(resnet):
    """The port's float32 CPU forward against its oracle: equal counts and
    class ids, scores rtol 1e-4 / atol 1e-5, boxes rtol 1e-4 / atol 1e-4,
    masks mean |diff| and thresholded disagreement under 0.02."""
    _, pcfg, params_np, images, oracle = resnet
    out = pt_model.to_numpy(pt_model.forward(
        params_from_numpy(params_np), images, pcfg, device="cpu"))
    det, valid, masks = out["detections"], out["valid"], out["masks"]
    for i in range(images.shape[0]):
        o = oracle[i]
        n = int(valid[i].sum())
        assert n == len(o["scores"]), f"image {i}"
        if n == 0:
            continue
        np.testing.assert_array_equal(det[i, :n, 4].astype(np.int32),
                                      o["class_ids"])
        np.testing.assert_allclose(det[i, :n, 5], o["scores"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(det[i, :n, :4], o["boxes"],
                                   rtol=1e-4, atol=1e-4)
        diff = np.abs(masks[i, :n] - o["masks"])
        assert diff.mean() < 0.02, diff.mean()
        binar = (masks[i, :n] >= 0.5) != (o["masks"] >= 0.5)
        assert binar.mean() < 0.02, binar.mean()


def test_oracle_finds_detections(resnet):
    """Guard: the comparison above must not pass vacuously."""
    oracle = resnet[4]
    assert sum(len(o["scores"]) for o in oracle) > 0


def test_port_mnv2_stages_match_oracle():
    """MobileNetV2: the port's backbone + FPN and RPN logits against the
    oracle's (the bounds of `tests/test_tf_full_model.py`'s mnv2 check:
    float32 reduction order through the depthwise chain)."""
    import torch

    from maskrcnn_tpu_torch.models import rpn as pt_rpn

    jcfg, params_np, images = _case("mobilenetv2")
    pcfg = tiny_test_config().replace(architecture="mobilenetv2", **EXACT)
    x = images - np.asarray(pcfg.mean_pixel, np.float32)
    pyr_t = pt_tfm._backbone_fpn(tf, params_np, tf.constant(x),
                                 "mobilenetv2")
    params = params_from_numpy(params_np)
    with torch.no_grad():
        pyr_p = pt_model.backbone_fpn(params, torch.from_numpy(x), pcfg,
                                      torch.float32)
        logits_p, _ = pt_rpn.apply_rpn(params, pyr_p, dtype=torch.float32)
    for lvl, (a, b) in enumerate(zip(pyr_p, pyr_t)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3,
                                   rtol=1e-3, err_msg=f"P{lvl + 2}")
    logits_t, _ = pt_tfm._rpn(tf, params_np, pyr_t)
    np.testing.assert_allclose(logits_p.numpy(), logits_t.numpy(),
                               atol=2e-3, rtol=1e-3)
