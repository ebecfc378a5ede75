"""The PyTorch port's box, NMS, proposal, detection and ROIAlign ops against
the JAX package on the CPU, with the same numpy inputs fed to both.

Decisions (kept indices, validity, classes) must be equal; float outputs
agree to float32 rounding of the same operation order (1e-6 on [0, 1]
boxes, 1e-5 on pooled features)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from maskrcnn_tpu.core import anchors as jax_anchors
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
from maskrcnn_tpu.ops import boxes as jax_boxes
from maskrcnn_tpu.ops.detection import refine_detections as jax_refine
from maskrcnn_tpu.ops.nms import _compact as jax_compact
from maskrcnn_tpu.ops.nms import nms_padded as jax_nms
from maskrcnn_tpu.ops.nms_pallas import nms_keep_pallas
from maskrcnn_tpu.ops.proposals import generate_proposals as jax_proposals
from maskrcnn_tpu.ops.roi_align import pyramid_roi_align as jax_roi_align
from maskrcnn_tpu_torch.core import anchors as pt_anchors
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.ops import boxes as pt_boxes
from maskrcnn_tpu_torch.ops.detection import refine_detections as pt_refine
from maskrcnn_tpu_torch.ops.nms import nms_gather, nms_padded
from maskrcnn_tpu_torch.ops.proposals import generate_proposals as pt_proposals
from maskrcnn_tpu_torch.ops.roi_align import pyramid_roi_align, roi_levels
from tests.test_boxes import random_boxes
from tests.torch_support import NMS_KINDS, clustered_boxes, nms_case
from tests.torch_support import one_thread  # noqa: F401  (autouse)

T = torch.from_numpy


def test_box_ops_match_jax(rng):
    a = random_boxes(rng, 40, degenerate_frac=0.2)
    b = random_boxes(rng, 30, degenerate_frac=0.2)
    d = rng.normal(0, 0.3, size=(40, 4)).astype(np.float32)
    np.testing.assert_allclose(
        pt_boxes.apply_box_deltas(T(a), T(d)).numpy(),
        np.asarray(jax_boxes.apply_box_deltas(jnp.asarray(a),
                                              jnp.asarray(d))),
        rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        pt_boxes.clip_boxes(T(d)).numpy(),
        np.asarray(jax_boxes.clip_boxes(jnp.asarray(d))))
    np.testing.assert_allclose(
        pt_boxes.box_iou(T(a), T(b)).numpy(),
        np.asarray(jax_boxes.box_iou(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)
    for t in (0.3, 0.5, 0.7):
        np.testing.assert_array_equal(
            pt_boxes.box_overlap_mask(T(a), T(b), t).numpy(),
            np.asarray(jax_boxes.box_overlap_mask(jnp.asarray(a),
                                                  jnp.asarray(b), t)))


def test_anchors_match_jax_table():
    jcfg, pcfg = jax_tiny(), pt_tiny()
    table = jax_anchors.generate_anchors(jcfg)
    np.testing.assert_array_equal(pt_anchors.generate_anchors(pcfg), table)
    assert pt_anchors.anchor_spec(pcfg) == jax_anchors.anchor_spec(jcfg)
    idx = np.arange(table.shape[0], dtype=np.int64)
    got = pt_anchors.anchors_at(T(idx), pt_anchors.anchor_spec(pcfg)).numpy()
    # closed form vs a table rounded once from float64: <= 2 ulp
    np.testing.assert_allclose(got, table, rtol=0, atol=4e-7)
    want = np.asarray(jax_anchors.anchors_at(
        jnp.asarray(idx, jnp.int32), jax_anchors.anchor_spec(jcfg)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)


NMS_CASES = [(n, t) for n in (40, 300, 1000) for t in (0.3, 0.7)]


def _nms_inputs(n, seed):
    rng = np.random.default_rng(seed)
    boxes, valid = clustered_boxes(rng, n)
    return boxes, valid, max(n // 8, 4)


@pytest.mark.parametrize("n,iou", NMS_CASES)
def test_nms_matches_jax_xla(n, iou):
    boxes, valid, max_out = _nms_inputs(n, n + int(iou * 10))
    want_idx, want_v = jax_nms(jnp.asarray(boxes), jnp.asarray(valid), iou,
                               max_out, tile_size=128, impl="xla")
    got_idx, got_v = nms_padded(T(boxes), T(valid), iou, max_out)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.any()


@pytest.mark.parametrize("n,iou", NMS_CASES)
def test_nms_matches_pallas_kernel(n, iou):
    boxes, valid, max_out = _nms_inputs(n, n + int(iou * 10))
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(valid & (area > 0)),
                           iou, max_out, tile_size=128, interpret=True)
    want_idx, want_v = jax_compact(keep, n, max_out, False)
    got_idx, got_v = nms_padded(T(boxes), T(valid), iou, max_out)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_nms_batched_equals_per_image(rng):
    b0, v0 = clustered_boxes(rng, 200)
    b1, v1 = clustered_boxes(rng, 200)
    idx, val = nms_padded(T(np.stack([b0, b1])), T(np.stack([v0, v1])),
                          0.5, 30)
    for i, (bb, vv) in enumerate(((b0, v0), (b1, v1))):
        i1, v1_ = nms_padded(T(bb), T(vv), 0.5, 30)
        np.testing.assert_array_equal(idx[i].numpy(), i1.numpy())
        np.testing.assert_array_equal(val[i].numpy(), v1_.numpy())
    rows = nms_gather(T(np.stack([b0, b1])), idx)
    assert rows.shape == (2, 30, 4)
    assert (rows[~val] == 0).all()


@pytest.mark.parametrize("analytic", [False, True])
def test_proposals_match_jax(rng, analytic):
    jcfg, pcfg = jax_tiny(), pt_tiny()
    table = jax_anchors.generate_anchors(jcfg)
    a = table.shape[0]
    fg = rng.normal(size=(2, a)).astype(np.float32)
    fg[:, :600] = 0.25      # a run of exact ties across the top-k cut
    deltas = rng.normal(0, 0.5, size=(2, a, 4)).astype(np.float32)
    kw = dict(pre_nms_max_proposals=jcfg.pre_nms_max_proposals,
              max_proposals=jcfg.max_proposals, nms_threshold=0.7)
    got_r, got_v = pt_proposals(
        T(fg), T(deltas), T(table),
        anchor_spec=pt_anchors.anchor_spec(pcfg) if analytic else None, **kw)
    for i in range(2):
        want_r, want_v = jax_proposals(
            jnp.asarray(fg[i]), jnp.asarray(deltas[i]), jnp.asarray(table),
            topk_recall=None,
            anchor_spec=jax_anchors.anchor_spec(jcfg) if analytic else None,
            **kw)
        np.testing.assert_array_equal(got_v[i].numpy(), np.asarray(want_v))
        np.testing.assert_allclose(got_r[i].numpy(), np.asarray(want_r),
                                   rtol=0, atol=1e-6)
        assert np.asarray(want_v).sum() > 10


def test_refine_detections_matches_jax(rng):
    r, k = 64, 5
    rois = random_boxes(rng, r, degenerate_frac=0.1)
    logits = rng.normal(0, 2.0, size=(r, k)).astype(np.float32)
    logits[10:20] = logits[3]        # tied scores: stable order decides
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    deltas = rng.normal(0, 0.3, size=(r, k, 4)).astype(np.float32)
    kw = dict(score_threshold=0.3, nms_threshold=0.3, max_detections=16)
    want_d, want_v, want_i = jax_refine(jnp.asarray(rois), jnp.asarray(probs),
                                        jnp.asarray(deltas), **kw)
    got_d, got_v, got_i = pt_refine(T(rois)[None], T(probs)[None],
                                    T(deltas)[None], **kw)
    want_d = np.asarray(want_d)
    np.testing.assert_array_equal(got_v[0].numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d[0, :, 4].numpy(), want_d[:, 4])
    np.testing.assert_allclose(got_d[0].numpy(), want_d, rtol=0, atol=1e-6)
    assert np.asarray(want_v).sum() > 2


def _pyramid_and_rois(rng, b=2, c=8, base=32, n=40):
    feats = [rng.standard_normal((b, base >> l, base >> l, c))
             .astype(np.float32) for l in range(4)]
    yx1 = rng.uniform(0, 0.7, size=(b, n, 2))
    wh = rng.uniform(0.02, 0.6, size=(b, n, 2))
    rois = np.concatenate([yx1, np.minimum(yx1 + wh, 1.0)], -1)
    rois[:, 0] = 0.0                              # padding
    rois[:, 1] = [0.0, 0.0, 1.0, 1.0]             # whole image, coarsest
    rois[:, 2] = [0.9, 0.9, 1.0, 1.0]             # corner
    rois[:, 3] = [0.4, 0.02, 0.42, 0.98]          # extreme aspect
    return feats, rois.astype(np.float32)


@pytest.mark.parametrize("crop", [7, 14])
def test_roi_align_matches_jax_flat(rng, crop):
    feats, rois = _pyramid_and_rois(rng)
    shape = (1024, 1024)   # level choice at the real input size
    got = pyramid_roi_align([T(f) for f in feats], T(rois), crop, shape)
    lv, _ = roi_levels(T(rois.reshape(-1, 4)), shape)
    assert len(set(lv.tolist())) == 4              # every level sampled
    for i in range(2):
        want = jax_roi_align([jnp.asarray(f[i]) for f in feats],
                             jnp.asarray(rois[i]), crop, shape)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
    assert (got[:, 0] == 0).all()


@pytest.mark.slow
def test_roi_align_matches_pallas_kernel(rng):
    """Against the TPU kernel itself (interpret mode). Its prep is compiled
    in another program than `pyramid_roi_align_flat`, and a sample that
    lands exactly on a level's last row or column can round one ulp past
    it there (and read 0); those few samples are where the two JAX
    versions disagree with each other, and the port follows the flat one."""
    from maskrcnn_tpu.ops.roi_align_pallas import pyramid_roi_align_pallas
    feats, rois = _pyramid_and_rois(rng, base=64)
    shape = (1024, 1024)
    for crop in (7, 14):
        got = pyramid_roi_align([T(f) for f in feats], T(rois), crop,
                                shape).numpy()
        want = np.asarray(pyramid_roi_align_pallas(
            [jnp.asarray(f) for f in feats], jnp.asarray(rois), crop, shape,
            interpret=True))
        flat = np.stack([np.asarray(jax_roi_align(
            [jnp.asarray(f[i]) for f in feats], jnp.asarray(rois[i]), crop,
            shape)) for i in range(2)])
        agree = np.abs(flat - want).max(-1) <= 1e-5      # per sample
        assert agree.mean() > 0.99
        np.testing.assert_allclose(got[agree], want[agree], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got, flat, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [37, 200, 1000])
@pytest.mark.parametrize("kind", NMS_KINDS)
def test_nms_walk_matches_jax(kind, n):
    """The plain version (packed mask + chunk walk) keeps the same first
    max_out boxes as the JAX package's XLA NMS and its TPU kernel in
    interpret mode, exactly: N not a multiple of 64, a stop inside a chunk,
    identical and zero-area boxes, candidate holes, pairs at the threshold
    to an ulp, class-offset boxes at IoU 0.3."""
    boxes, valid, t, max_out = nms_case(kind, n)
    got_idx, got_v = nms_padded(T(boxes), T(valid), t, max_out)
    want_idx, want_v = jax_nms(jnp.asarray(boxes), jnp.asarray(valid), t,
                               max_out, tile_size=128, impl="xla")
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(valid & (area > 0)),
                           t, max_out, tile_size=128, interpret=True)
    want_idx, want_v = jax_compact(keep, n, max_out, False)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.any()
    if kind == "identical":
        assert int(got_v.sum()) == 1
    if kind == "stop_mid_chunk":
        assert int(got_v.sum()) == max_out
