"""The port's fused ROI heads (the plain versions of K5 and K6) against the
JAX package's TPU kernel `pyramid_roi_align_pallas` run in interpret mode
with `head_params` / `mask_params`, the port's head packing against the
JAX packing (float32, small widths), and the bf16 pool against the
kernel's. Each interpret-mode run takes 25-30 s, so each has one case."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskrcnn_tpu.models.heads import init_classifier_head, init_mask_head
from maskrcnn_tpu.ops import roi_align_pallas as jax_rap
from maskrcnn_tpu_torch.io.weights import params_from_numpy
from maskrcnn_tpu_torch.ops import roi_align as pt_ra
from maskrcnn_tpu_torch.ops import roi_align_cuda as pt_rac
from tests.torch_support import jax_tree
from tests.torch_support import one_thread  # noqa: F401  (autouse)

IMAGE_SHAPE = (128, 128)
CANONICAL = 224.0
C = 8
CLS_CLASSES = 11
MASK_CLASSES = 7


def mixed_rois(rng, n):
    """Normal + padding + extreme-aspect + edge-touching ROIs (the cases of
    tests/test_roi_align_pallas.py)."""
    yx1 = rng.uniform(0, 0.7, size=(n, 2))
    wh = rng.uniform(0.02, 0.3, size=(n, 2))
    rois = np.concatenate([yx1, np.minimum(yx1 + wh, 1.0)], axis=1)
    rois[0] = 0.0                                # padding row
    rois[1] = [0.4, 0.02, 0.42, 0.98]            # aspect ~48 -> oversize
    rois[2] = [0.02, 0.45, 0.97, 0.47]           # tall sliver
    rois[3] = [0.0, 0.0, 1.0, 1.0]               # full image (P5)
    rois[4] = [0.9, 0.9, 1.0, 1.0]               # bottom-right corner
    rois[5] = [0.0, 0.0, 0.015, 0.015]           # tiny (P2, sub-cell)
    return rois.astype(np.float32)


def _inputs(rng, b=2, n=24):
    feats = [rng.standard_normal((b, 64 >> l, 64 >> l, C)).astype(np.float32)
             for l in range(4)]
    rois = np.stack([mixed_rois(rng, n) for _ in range(b)])
    return feats, rois


def _redraw_bn(rng, flat, names, scale=1.0):
    for name in names:
        c = flat[name]["gamma"].shape[0]
        flat[name] = {k: v.astype(np.float32) for k, v in {
            "gamma": rng.uniform(0.5, 1.5, c),
            "beta": rng.standard_normal(c) * scale,
            "moving_mean": rng.standard_normal(c) * scale,
            "moving_variance": rng.uniform(0.5, 2.0, c)}.items()}


def classifier_params(rng):
    params = init_classifier_head(jax.random.PRNGKey(3), CLS_CLASSES,
                                  in_channels=C, pool_size=7, fc_dim=64)
    flat = {k: {w: np.asarray(v, np.float32) for w, v in d.items()}
            for k, d in params.items()}
    _redraw_bn(rng, flat, ("mrcnn_class_bn1", "mrcnn_class_bn2"))
    flat["mrcnn_class_logits"]["bias"] = rng.standard_normal(
        CLS_CLASSES).astype(np.float32) * 0.1
    return flat


def mask_params(rng):
    params = init_mask_head(jax.random.PRNGKey(7), MASK_CLASSES,
                            in_channels=C, channels=C)
    flat = {k: {w: np.asarray(v, np.float32) for w, v in d.items()}
            for k, d in params.items()}
    _redraw_bn(rng, flat, [f"mrcnn_mask_bn{i}" for i in range(1, 5)], 0.1)
    flat["mrcnn_mask_deconv"]["bias"] = (rng.standard_normal(C)
                                         * 0.1).astype(np.float32)
    flat["mrcnn_mask"]["bias"] = (rng.standard_normal(MASK_CLASSES)
                                  * 0.1).astype(np.float32)
    return flat


@pytest.mark.parametrize("head", ["classifier", "mask"])
def test_head_packing_matches_jax(head):
    rng = np.random.default_rng(1)
    if head == "classifier":
        flat = classifier_params(rng)
        want = jax_rap.pack_classifier_head(jax_tree(flat), CLS_CLASSES,
                                            dtype=jnp.float32)
        got = pt_rac.pack_classifier_head(params_from_numpy(flat),
                                          CLS_CLASSES, dtype=torch.float32)
    else:
        flat = mask_params(rng)
        want = jax_rap.pack_mask_head(jax_tree(flat), dtype=jnp.float32)
        got = pt_rac.pack_mask_head(params_from_numpy(flat),
                                    dtype=torch.float32)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_classifier_head_matches_pallas_kernel():
    rng = np.random.default_rng(2)
    feats, rois = _inputs(rng)
    flat = classifier_params(rng)
    _, head_out = jax_rap.pyramid_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), 7, IMAGE_SHAPE,
        CANONICAL, interpret=True,
        head_params=jax_rap.pack_classifier_head(jax_tree(flat), CLS_CLASSES,
                                                 dtype=jnp.float32))
    want_p, want_d, _ = jax_rap.unpack_classifier_head(head_out, CLS_CLASSES)

    packed = pt_rac.pack_classifier_head(params_from_numpy(flat),
                                         CLS_CLASSES, dtype=torch.float32)
    out = pt_ra.pyramid_roi_align([torch.from_numpy(f) for f in feats],
                                  torch.from_numpy(rois), 7, IMAGE_SHAPE,
                                  CANONICAL, head_params=packed)
    assert out.shape == (48, pt_rac.HEAD_OUT) and out.dtype == torch.float32
    got_p, got_d, _ = pt_rac.unpack_classifier_head(out, CLS_CLASSES)
    # the JAX test's own tolerances (two float32 sum orders)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=2e-4, atol=2e-4)
    # the padding ROI pools to zeros and still goes through the head
    assert np.abs(np.asarray(want_p)[0]).sum() > 0


def test_mask_head_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    feats, rois = _inputs(rng)
    flat = mask_params(rng)
    class_ids = rng.integers(0, MASK_CLASSES, (2, 24)).astype(np.int32)
    _, raw = jax_rap.pyramid_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), 14, IMAGE_SHAPE,
        CANONICAL, interpret=True,
        mask_params=jax_rap.pack_mask_head(jax_tree(flat), dtype=jnp.float32),
        class_ids=jnp.asarray(class_ids))
    want = np.asarray(jax_rap.unpack_masks(raw, 14))

    packed = pt_rac.pack_mask_head(params_from_numpy(flat),
                                   dtype=torch.float32)
    got = pt_ra.pyramid_roi_align([torch.from_numpy(f) for f in feats],
                                  torch.from_numpy(rois), 14, IMAGE_SHAPE,
                                  CANONICAL, mask_params=packed,
                                  class_ids=torch.from_numpy(class_ids))
    assert got.shape == (48, 28, 28) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("head", ["classifier", "mask"])
def test_head_plain_sums_in_float32_by_default(head):
    """What the two Pallas tests above hold against the TPU kernel is the
    plain version with float32 sums: the default of its `acc_dtype`, bit
    for bit. Float64 sums (`tools/kernel_bias.py`'s reference) land within
    those tests' tolerances of it."""
    rng = np.random.default_rng(2 if head == "classifier" else 3)
    feats, rois = _inputs(rng)
    t_feats = [torch.from_numpy(f) for f in feats]
    crop = 7 if head == "classifier" else 14
    prep = pt_ra.prepare(torch.from_numpy(rois.reshape(-1, 4)),
                         [(f.shape[1], f.shape[2]) for f in t_feats],
                         IMAGE_SHAPE, CANONICAL, crop)
    if head == "classifier":
        packed = pt_rac.pack_classifier_head(
            params_from_numpy(classifier_params(rng)), CLS_CLASSES,
            dtype=torch.float32)
        via_op = pt_ra.pyramid_roi_align(t_feats, torch.from_numpy(rois), 7,
                                         IMAGE_SHAPE, CANONICAL,
                                         head_params=packed)
        fn, args = pt_rac.classifier_head_plain, (t_feats, *prep, 24, packed)
    else:
        packed = pt_rac.pack_mask_head(params_from_numpy(mask_params(rng)),
                                       dtype=torch.float32)
        ids = torch.from_numpy(rng.integers(0, MASK_CLASSES, (2, 24))
                               .astype(np.int32))
        via_op = pt_ra.pyramid_roi_align(t_feats, torch.from_numpy(rois), 14,
                                         IMAGE_SHAPE, CANONICAL,
                                         mask_params=packed, class_ids=ids)
        fn, args = pt_rac.mask_head_plain, (t_feats, *prep, 24, packed,
                                            ids.reshape(-1))
    assert torch.equal(fn(*args), via_op)
    assert torch.equal(fn(*args, acc_dtype=torch.float32), via_op)
    f64 = fn(*args, acc_dtype=torch.float64)
    assert f64.dtype == torch.float64 and f64.shape == via_op.shape
    np.testing.assert_allclose(via_op.numpy(), f64.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_bf16_pool_within_one_rounding_of_pallas_kernel():
    """At bf16 the TPU kernel rounds its y-blended rows and its x weights
    to bf16 before the x contraction; the port (K2, and the pool inside
    K5/K6) blends in float32 and rounds once. The two pools then differ by
    about one bf16 rounding on about a third of the values."""
    rng = np.random.default_rng(4)
    feats, rois = _inputs(rng, b=1, n=16)
    want = np.asarray(jax_rap.pyramid_roi_align_pallas(
        [jnp.asarray(f, jnp.bfloat16) for f in feats], jnp.asarray(rois), 7,
        IMAGE_SHAPE, CANONICAL, interpret=True).astype(jnp.float32))
    got = pt_ra.pyramid_roi_align(
        [torch.from_numpy(f).to(torch.bfloat16) for f in feats],
        torch.from_numpy(rois), 7, IMAGE_SHAPE, CANONICAL).float().numpy()
    delta = np.abs(got - want)
    assert delta.max() <= 2.0 ** -7 * np.abs(want).max()
    assert 0.1 < (delta > 0).mean() < 0.6


@pytest.mark.parametrize("m", [1, 37, 200])
def test_mask_head_plan_covers_each_position_once(m):
    """K6's layer kernels launch this plan (its refusal of a plan off the
    tiling is a `gpu` test): the 128-position tiles, taken in (roi, y, x)
    order, cover every position of the M x 14 x 14 grid exactly once, the
    origins are each tile's first position, the K chunks are the conv's
    9 x 256 and the deconv's 256 channels, and a block's shared memory
    fits the H100's 232,448 bytes."""
    plan = pt_rac.mask_head_plan(m)
    p = pt_rac.MASK_POOL
    rows = plan["tile_rows"]
    assert rows == pt_rac.HEAD_BM == 128 and plan["rows"] == m * p * p
    cover = np.zeros(m * p * p, np.int32)
    for roi, y, x in plan["origins"]:
        first = (roi * p + y) * p + x
        assert first % rows == 0 and first < m * p * p
        cover[first:first + rows] += 1
    assert (cover == 1).all()
    tiles = len(plan["origins"])
    assert plan["conv_grid"] == (tiles,) and tiles == -(-m * p * p // rows)
    assert plan["deconv_grid"] == (tiles, 4)
    assert plan["conv_chunks"] == 9 * pt_rac.MASK_CHANNELS // 64 == 36
    assert plan["deconv_chunks"] == pt_rac.MASK_CHANNELS // 64 == 4
    assert 1.0 <= plan["padding"] < 1.0 + rows / (m * p * p)
    assert plan["smem_bytes"] <= pt_rac.SMEM_PER_BLOCK
    if m == 200:
        assert tiles == 307
