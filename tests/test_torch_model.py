"""The port's whole forward against the JAX package's on the CPU, stage by
stage, on `tiny_test_config()` in float32, with the JAX package's own
random parameters (BN statistics redrawn from a seed) fed to the port
through the weight bridge; plus a bf16 run and the detector API."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskrcnn_tpu.core.anchors import generate_anchors as jax_anchors
from maskrcnn_tpu.core.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
from maskrcnn_tpu.models import mask_rcnn as jax_model
from maskrcnn_tpu.models import resnet as jax_resnet
from maskrcnn_tpu_torch.core.config import MaskRCNNConfig as PtConfig
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.io import weights as pt_weights
from maskrcnn_tpu_torch.models import mask_rcnn as pt_model
from maskrcnn_tpu_torch.models import resnet as pt_resnet
from maskrcnn_tpu_torch.pipeline.detector import Detection, MaskRCNNDetector

TOL = dict(rtol=1e-4, atol=1e-4)
# random heads rarely reach 0.7; a low threshold sends real boxes to the
# detection NMS and the mask branch
OVERRIDES = dict(compute_dtype="float32", detection_score_threshold=0.25)


def live_bn_params(seed=0, config=None):
    """JAX `init_mask_rcnn` params as numpy (of `config`, default the tiny
    one), every BN's statistics redrawn so each residual branch is live."""
    params = jax_model.init_mask_rcnn(
        jax.random.PRNGKey(seed), config or jax_tiny().replace(**OVERRIDES))
    rng = np.random.default_rng(seed)
    flat = {}
    for layer, weights in params.items():
        w = {k: np.asarray(v, np.float32) for k, v in weights.items()}
        if "moving_variance" in w:
            c = w["gamma"].shape[0]
            w = {"gamma": rng.uniform(0.3, 0.8, c),
                 "beta": rng.uniform(-0.2, 0.2, c),
                 "moving_mean": rng.uniform(-0.2, 0.2, c),
                 "moving_variance": rng.uniform(0.5, 2.0, c)}
            w = {k: v.astype(np.float32) for k, v in w.items()}
        flat[layer] = w
    return flat


@pytest.fixture(scope="module")
def forwards():
    flat = live_bn_params()
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    jcfg = jax_tiny().replace(**OVERRIDES)
    pcfg = pt_tiny().replace(**OVERRIDES)
    jp = {k: {w: jnp.asarray(v) for w, v in d.items()}
          for k, d in flat.items()}
    want = jax_model.forward(jp, jnp.asarray(images),
                             jnp.asarray(jax_anchors(jcfg)), jcfg,
                             with_features=True)
    want = jax.tree_util.tree_map(np.asarray, want)
    pp = pt_weights.params_from_numpy(flat)
    got = pt_model.to_numpy(pt_model.forward(
        pp, torch.from_numpy(images), pcfg, with_features=True,
        device="cpu"))
    x = images - np.asarray(jcfg.mean_pixel, np.float32)
    c_want = [np.asarray(c) for c in jax_resnet.apply_resnet(
        jp, jnp.asarray(x), jcfg.architecture, dtype=jnp.float32)]
    c_got = [c.numpy() for c in pt_resnet.apply_resnet(
        pp, torch.from_numpy(x), pcfg.architecture, dtype=torch.float32)]
    return want, got, c_want, c_got


def test_backbone_c2_c5_match(forwards):
    _, _, c_want, c_got = forwards
    for w, g in zip(c_want, c_got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_fpn_and_rpn_match(forwards):
    want, got, _, _ = forwards
    for w, g in zip(want["pyramid"], got["pyramid"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got["rpn_logits"], want["rpn_logits"], **TOL)
    np.testing.assert_allclose(got["rpn_deltas"], want["rpn_deltas"], **TOL)


def test_proposals_match(forwards):
    want, got, _, _ = forwards
    np.testing.assert_array_equal(got["roi_valid"], want["roi_valid"])
    np.testing.assert_allclose(got["rois"], want["rois"], **TOL)


def test_detections_and_masks_match(forwards):
    want, got, _, _ = forwards
    assert want["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["detections"][..., 4],
                                  want["detections"][..., 4])
    np.testing.assert_allclose(got["detections"], want["detections"], **TOL)
    assert got["masks"].shape == want["masks"].shape == (2, 16, 28, 28)
    np.testing.assert_allclose(got["masks"], want["masks"], **TOL)


def test_bf16_plain_path_runs_on_cpu():
    cfg = pt_tiny().replace(detection_score_threshold=0.25)
    params = pt_weights.params_from_numpy(live_bn_params(1))
    images = np.random.default_rng(2).uniform(0, 255, (1, 128, 128, 3))
    out = pt_model.forward(params, images.astype(np.float32), cfg,
                           device="cpu")
    assert out["detections"].shape == (1, cfg.max_detections, 6)
    assert out["masks"].shape == (1, cfg.max_detections, 28, 28)
    assert out["rois"].shape == (1, cfg.max_proposals, 4)
    for k in ("detections", "masks", "rois"):
        assert torch.isfinite(out[k]).all(), k


def test_detector_detect_images_on_cpu(tmp_path):
    cfg = pt_tiny().replace(detection_score_threshold=0.25)
    path = str(tmp_path / "ckpt.npz")
    pt_weights.save_npz_checkpoint(live_bn_params(2), path)
    det = MaskRCNNDetector.from_checkpoint(cfg, path, device="cpu")
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (90, 140, 3), dtype=np.uint8),
            rng.integers(0, 256, (200, 120, 3), dtype=np.uint8)]
    res = det.detect_images(imgs, batch_size=2)
    assert len(res) == 2
    assert sum(len(r) for r in res) > 0
    for img, dets in zip(imgs, res):
        for d in dets:
            assert isinstance(d, Detection)
            y1, x1, y2, x2 = d.box
            assert 0 <= y1 <= y2 <= img.shape[0]
            assert 0 <= x1 <= x2 <= img.shape[1]
            assert 0 < d.class_id < cfg.num_classes
            assert d.mask.shape == img.shape[:2] and d.mask.dtype == bool
    boxes_only = det.detect_images(imgs[:1], paste_masks=False)
    assert all(d.mask is None for d in boxes_only[0])


def test_letterbox_and_paste_match_jax(monkeypatch):
    """The port pastes with PIL's bilinear resample, the JAX package's
    reference path; with its native resampler switched off the JAX package
    must give the same pixels."""
    import maskrcnn_tpu.native
    from maskrcnn_tpu.pipeline import detector as jax_det
    from maskrcnn_tpu.pipeline import preprocess as jax_pre
    from maskrcnn_tpu_torch.pipeline import detector as pt_det
    from maskrcnn_tpu_torch.pipeline import preprocess as pt_pre
    monkeypatch.setattr(maskrcnn_tpu.native, "get_imageio_lib", lambda: None)
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (77, 130, 3), dtype=np.uint8)
    got_c, got_w = pt_pre.letterbox_numpy(img, 128)
    want_c, want_w = jax_pre.letterbox_numpy(img, 128)
    np.testing.assert_array_equal(got_c, want_c)
    assert tuple(got_w.__dict__.values()) == tuple(want_w.__dict__.values())
    for _ in range(20):
        mask = rng.uniform(size=(28, 28)).astype(np.float32)
        y1, x1 = rng.uniform(-10, 60, 2)
        box = (y1, x1, y1 + rng.uniform(1, 70), x1 + rng.uniform(1, 90))
        shape = (77, 130)
        np.testing.assert_array_equal(pt_det.paste_mask(mask, box, shape),
                                      jax_det.paste_mask(mask, box, shape))
        got, gy, gx = pt_det.paste_mask_region(mask, box, shape)
        want, wy, wx = jax_det.paste_mask_region(mask, box, shape)
        assert (gy, gx) == (wy, wx)
        np.testing.assert_array_equal(got, want)


def test_merge_pretrained_reports_and_checks(tmp_path):
    flat = live_bn_params(3)
    init = pt_weights.params_from_numpy(flat)
    loaded = {k: v for k, v in flat.items() if k != "fpn_p2"}
    loaded["extra_layer"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="missing 1 model layers"):
        pt_weights.merge_pretrained(init, loaded)
    params, missing, unused = pt_weights.merge_pretrained(init, loaded,
                                                          strict=False)
    assert missing == ["fpn_p2"] and unused == ["extra_layer"]
    torch.testing.assert_close(params["conv1"]["kernel"],
                               torch.tensor(flat["conv1"]["kernel"]))
    bad = dict(loaded, fpn_p2={"kernel": np.zeros((1, 1, 1, 1), np.float32),
                               "bias": flat["fpn_p2"]["bias"]})
    with pytest.raises(ValueError, match="file shape"):
        pt_weights.merge_pretrained(init, bad)
    path = str(tmp_path / "w.npz")
    pt_weights.save_npz_checkpoint(init, path)
    back = pt_weights.load_npz_checkpoint(path)
    assert set(back) == set(flat)
    np.testing.assert_array_equal(back["fpn_p2"]["kernel"],
                                  flat["fpn_p2"]["kernel"])


def stage_by_stage(jcfg, pcfg, batch=1, seed=0):
    """The port's forward against the JAX forward, float32, on the same
    live-BN params, each port stage fed the JAX stage before it, so that a
    decision (top-k, NMS, level, class) differs only if the stage decides
    differently: C2-C5 from the images, the pyramid and the RPN outputs
    within `TOL`; proposals, then detections, with equal validity, equal
    classes and boxes within `TOL`; pooled features, head outputs and
    masks within `TOL`. Returns the JAX forward's outputs."""
    from maskrcnn_tpu.models import fpn as jax_fpn
    from maskrcnn_tpu.models import heads as jax_heads
    from maskrcnn_tpu.models import rpn as jax_rpn
    from maskrcnn_tpu.ops import roi_align as jax_ra
    from maskrcnn_tpu.ops.detection import refine_detections as jax_refine
    from maskrcnn_tpu_torch.core.anchors import anchor_spec
    from maskrcnn_tpu_torch.models import fpn as pt_fpn
    from maskrcnn_tpu_torch.models import heads as pt_heads
    from maskrcnn_tpu_torch.models import rpn as pt_rpn
    from maskrcnn_tpu_torch.ops.detection import refine_detections
    from maskrcnn_tpu_torch.ops.proposals import generate_proposals
    from maskrcnn_tpu_torch.ops.roi_align import pyramid_roi_align

    f32, t32 = jnp.float32, torch.float32
    flat = live_bn_params(seed, jcfg)
    rng = np.random.default_rng(seed + 1)
    images = rng.uniform(0, 255, (batch, jcfg.image_height,
                                  jcfg.image_width, 3)).astype(np.float32)
    jp = {k: {w: jnp.asarray(v) for w, v in d.items()}
          for k, d in flat.items()}
    pp = pt_weights.params_from_numpy(flat)
    want = jax.tree_util.tree_map(np.asarray, jax_model.forward(
        jp, jnp.asarray(images), jnp.asarray(jax_anchors(jcfg)), jcfg,
        with_features=True))

    def close(got, ref):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.shape == np.shape(ref)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)

    def t(a):
        return torch.from_numpy(np.array(a))

    x = images - np.asarray(jcfg.mean_pixel, np.float32)
    c_want = jax_resnet.apply_resnet(jp, jnp.asarray(x), jcfg.architecture,
                                     dtype=f32)
    c_got = pt_resnet.apply_resnet(pp, t(x), pcfg.architecture, dtype=t32)
    for g, w in zip(c_got, c_want):
        close(g, w)
    pyr = jax_fpn.apply_fpn(jp, *c_want, dtype=f32)
    for g, w, f in zip(pt_fpn.apply_fpn(pp, *map(t, c_want), dtype=t32),
                       pyr, want["pyramid"]):
        close(g, w)
        close(g, f)
    pyr_t = [t(f) for f in want["pyramid"]]
    logits, deltas = pt_rpn.apply_rpn(pp, pyr_t, dtype=t32)
    close(logits, want["rpn_logits"])
    close(deltas, want["rpn_deltas"])

    fg = want["rpn_logits"][..., 1] - want["rpn_logits"][..., 0]
    rois, roi_valid = generate_proposals(
        t(fg), t(want["rpn_deltas"]), None,
        bbox_std_dev=pcfg.bbox_std_dev,
        pre_nms_max_proposals=pcfg.pre_nms_max_proposals,
        max_proposals=pcfg.max_proposals,
        nms_threshold=pcfg.proposal_nms_threshold,
        anchor_spec=anchor_spec(pcfg))
    np.testing.assert_array_equal(roi_valid.numpy(), want["roi_valid"])
    close(rois, want["rois"])

    hw = (jcfg.image_height, jcfg.image_width)
    flat_pyr = jax.vmap(lambda *f: jax_ra.build_flat_pyramid(f))(
        *[jnp.asarray(f) for f in want["pyramid"][:4]])

    def jax_pool(boxes, crop):
        return jax.vmap(lambda f, r: jax_ra.pyramid_roi_align_flat(
            f, r, crop, hw, jcfg.roi_canonical_scale))(
                flat_pyr, jnp.asarray(boxes))

    def pt_pool(boxes, crop):
        return pyramid_roi_align(pyr_t[:4], t(boxes), crop, hw,
                                 pcfg.roi_canonical_scale)

    r, d, k = jcfg.max_proposals, jcfg.max_detections, jcfg.num_classes
    pooled = jax_pool(want["rois"], jcfg.pool_size)
    close(pt_pool(want["rois"], jcfg.pool_size), pooled)
    probs, bdeltas = jax_heads.apply_classifier_head(
        jp, pooled.reshape((batch * r,) + pooled.shape[2:]), k, dtype=f32)
    g_probs, g_deltas = pt_heads.apply_classifier_head(
        pp, t(pooled).reshape((batch * r,) + pooled.shape[2:]), k,
        dtype=t32)
    close(g_probs, probs)
    close(g_deltas, bdeltas)
    probs = probs.reshape(batch, r, k)
    bdeltas = bdeltas.reshape(batch, r, k, 4)
    refine = dict(bbox_std_dev=jcfg.bbox_std_dev,
                  score_threshold=jcfg.detection_score_threshold,
                  nms_threshold=jcfg.detection_nms_threshold,
                  max_detections=d)
    det_w, valid_w, _ = jax.vmap(lambda a, b, c: jax_refine(
        a, b, c, **refine))(jnp.asarray(want["rois"]), probs, bdeltas)
    det_g, valid_g, _ = refine_detections(t(want["rois"]), t(probs),
                                          t(bdeltas), **refine)
    np.testing.assert_array_equal(valid_g.numpy(), np.asarray(valid_w))
    np.testing.assert_array_equal(det_g[..., 4].numpy(),
                                  np.asarray(det_w)[..., 4])
    close(det_g, det_w)
    np.testing.assert_array_equal(np.asarray(valid_w), want["valid"])
    close(np.asarray(det_w), want["detections"])

    boxes = want["detections"][..., :4]
    ids = want["detections"][..., 4].astype(np.int32).reshape(batch * d)
    mpooled = jax_pool(boxes, jcfg.mask_pool_size)
    close(pt_pool(boxes, jcfg.mask_pool_size), mpooled)
    masks = jax_heads.apply_mask_head(
        jp, mpooled.reshape((batch * d,) + mpooled.shape[2:]), dtype=f32,
        class_ids=jnp.asarray(ids))
    g_masks = pt_heads.apply_mask_head(
        pp, t(mpooled).reshape((batch * d,) + mpooled.shape[2:]), dtype=t32,
        class_ids=t(ids).long())
    close(g_masks, masks)
    return want


@pytest.mark.slow
def test_full_size_forward_matches_jax_stage_by_stage():
    """R101-FPN @ 1024^2, 81 classes, float32, JAX `init_mask_rcnn` params
    with live BN statistics: the stages of the forward at the full size,
    score threshold 0 so that all 100 detections go through the class NMS
    and the mask head."""
    full = dict(OVERRIDES, detection_score_threshold=0.0)
    want = stage_by_stage(JaxConfig().replace(**full),
                          PtConfig().replace(**full))
    assert want["roi_valid"].sum() > 0 and want["valid"].all()
