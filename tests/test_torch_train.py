"""The port's training path against the JAX package's on the CPU, at
`tiny_test_config()` in float32 unless a test says otherwise: target
assignment fed the JAX package's own `jax.random` draws (exact sampling
decisions), the five losses, `compute_losses` and its gradients in both
BN modes, the optimizer against the optax chain, the K2/K3/K4 autograd
Functions, BN calibration and whole training steps. Checkpoints, the
train loader and `cli train` are in `tests/test_torch_train_io.py`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from maskrcnn_tpu.core.anchors import generate_anchors as jax_anchors
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
from maskrcnn_tpu.models import heads as jax_heads
from maskrcnn_tpu.models import resnet as jax_resnet
from maskrcnn_tpu.train import losses as jax_L
from maskrcnn_tpu.train import step as jax_step
from maskrcnn_tpu.train import targets as jax_targets
from maskrcnn_tpu.train.calibrate import calibrate_bn_stats as jax_calibrate
from maskrcnn_tpu_torch.core.anchors import generate_anchors as pt_anchors
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.io.weights import params_from_numpy
from maskrcnn_tpu_torch.models import heads as pt_heads
from maskrcnn_tpu_torch.models import resnet as pt_resnet
from maskrcnn_tpu_torch.ops import (bottleneck_cuda, cuda_lib, roi_align,
                                    roi_align_cuda, stem_cuda)
from maskrcnn_tpu_torch.train import losses as pt_L
from maskrcnn_tpu_torch.train import step as pt_step
from maskrcnn_tpu_torch.train import targets as pt_targets
from maskrcnn_tpu_torch.train.calibrate import calibrate_bn_stats
from tests.torch_support import (crowd_batch, jax_draws, jax_tree,
                                 live_bn_params, make_gt, stage_params,
                                 starting_threads, stem_params, t)
from tests.torch_support import one_thread  # noqa: F401  (autouse)

F32 = dict(compute_dtype="float32")
# deltas: log and division of float32 values in another library
DELTA_TOL = dict(rtol=0, atol=1e-6)


def one_image_draws(key, n):
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))),
            np.asarray(jax.random.uniform(kn, (n,))))


# --------------------------------------------------------------------------
# targets
# --------------------------------------------------------------------------

def test_encode_box_deltas_matches_jax(rng):
    boxes = np.concatenate([rng.uniform(0, .5, (64, 2)),
                            rng.uniform(.5, 1., (64, 2))], 1)
    boxes = boxes.astype(np.float32)
    gt = np.concatenate([rng.uniform(0, .5, (64, 2)),
                         rng.uniform(.5, 1., (64, 2))], 1).astype(np.float32)
    boxes[:4] = 0.0                         # degenerate rows: the 1e-8 floor
    want = np.asarray(jax_targets.encode_box_deltas(jnp.asarray(boxes),
                                                    jnp.asarray(gt)))
    got = pt_targets.encode_box_deltas(t(boxes), t(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


RPN_CASES = {
    "plain": dict(g=4),
    "crowd": dict(g=4, crowd=(0,)),
    # one small GT: few eligible positives, so the positive quota is mostly
    # -1 ties and negatives back-fill
    "scarce": dict(g=1, small=True),
    "padded": dict(g=6, pad=(4, 5), crowd=(2,)),
    # GT 1 is GT 0 again with another class: its IoUs tie with GT 0's
    # (the best-anchor rule marks the anchors of both)
    "duplicate": dict(g=4, duplicate=True),
}


def _gt_case(rng, g, crowd=(), pad=(), small=False, duplicate=False,
             num_classes=5):
    boxes, classes, masks = make_gt(rng, g, num_classes)
    if duplicate:
        boxes[1] = boxes[0]
        classes[1] = classes[0] % (num_classes - 1) + 1
    if small:
        boxes[0, 2:] = boxes[0, :2] + 0.04
    for i in crowd:
        classes[i] = -classes[i]
    for i in pad:
        boxes[i], classes[i], masks[i] = 0.0, 0, 0.0
    return boxes, classes, masks


@pytest.mark.parametrize("case", sorted(RPN_CASES))
def test_rpn_targets_match_jax(rng, case):
    cfg = jax_tiny()
    anchors = jax_anchors(cfg)
    boxes, classes, _ = _gt_case(rng, **RPN_CASES[case])
    key = jax.random.PRNGKey(3)
    want = jax_targets.rpn_targets(
        jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(classes), key,
        train_anchors=cfg.rpn_train_anchors_per_image, sampling_topk="exact")
    rand_p, rand_n = one_image_draws(key, anchors.shape[0])
    got = pt_targets.rpn_targets(
        t(pt_anchors(pt_tiny())), t(boxes), t(classes), t(rand_p),
        t(rand_n), train_anchors=cfg.rpn_train_anchors_per_image)
    labels = np.asarray(want.labels)
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    valid = np.asarray(want.pos_valid)
    np.testing.assert_array_equal(got.pos_valid.numpy(), valid)
    np.testing.assert_array_equal(got.pos_idx.numpy()[valid],
                                  np.asarray(want.pos_idx)[valid])
    np.testing.assert_allclose(got.pos_deltas.numpy(),
                               np.asarray(want.pos_deltas), **DELTA_TOL)
    assert (labels == 1).sum() >= 1
    assert (labels != 0).sum() == cfg.rpn_train_anchors_per_image
    if case == "crowd" or case == "padded":
        crowd_box = boxes[classes < 0]
        from maskrcnn_tpu_torch.ops.boxes import box_iou
        overlap = box_iou(t(pt_anchors(pt_tiny())), t(crowd_box)).numpy()
        assert not (got.labels.numpy()[overlap.max(1) >= 0.001] == -1).any()


def _proposal_case(rng, case):
    boxes, classes, masks = make_gt(rng, 4)
    jitter = boxes + rng.normal(0, 0.01, boxes.shape).astype(np.float32)
    far = np.concatenate([rng.uniform(0.8, 0.9, (20, 2)),
                          rng.uniform(0.9, 1.0, (20, 2))], 1)
    near = boxes[rng.integers(0, 4, 30)] + rng.normal(0, 0.06, (30, 4))
    props = np.clip(np.concatenate([jitter, far, near]), 0, 1)
    props = props.astype(np.float32)
    valid = np.ones(len(props), bool)
    if case == "crowd":
        classes[0] = -classes[0]
        props[:3] = boxes[0]               # proposals inside the crowd box
    if case == "invalid":
        valid[::3] = False
        props[::3] = 0.0
        boxes[3], classes[3], masks[3] = 0.0, 0, 0.0
    if case == "duplicate":
        boxes[1] = boxes[0]
        classes[1] = classes[0] % 4 + 1
        masks[1] = 1.0 - masks[0]
    # the pool as compute_losses builds it: the GT boxes appended
    props = np.concatenate([props, boxes]).astype(np.float32)
    valid = np.concatenate([valid, classes > 0])
    return props, valid, boxes, classes, masks


@pytest.mark.parametrize("case", ["plain", "crowd", "invalid", "duplicate"])
@pytest.mark.parametrize("num_rois", [16, 32])
def test_proposal_targets_match_jax(rng, case, num_rois):
    props, valid, boxes, classes, masks = _proposal_case(rng, case)
    key = jax.random.PRNGKey(num_rois)
    want = jax_targets.proposal_targets(
        jnp.asarray(props), jnp.asarray(valid), jnp.asarray(boxes),
        jnp.asarray(classes), jnp.asarray(masks), key, num_rois=num_rois,
        positive_fraction=0.33, mask_size=28)
    rand_p, rand_n = one_image_draws(key, len(props))
    got = pt_targets.proposal_targets(
        t(props), t(valid), t(boxes), t(classes), t(masks), t(rand_p),
        t(rand_n), num_rois=num_rois, positive_fraction=0.33, mask_size=28)
    for name in ("rois", "roi_valid", "class_ids", "masks", "positive"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas),
                               **DELTA_TOL)
    pos = got.positive.numpy()
    assert pos.sum() >= 1 and got.masks.numpy()[pos].sum() > 0
    if case == "duplicate":
        # proposals on the shared box match GT 0 (the first maximum): its
        # class, never GT 1's
        on_box = np.isclose(got.rois.numpy(), boxes[0], atol=0.03).all(1)
        assert (got.class_ids.numpy()[on_box & pos] == classes[0]).all()
        assert (on_box & pos).any()
    if case == "crowd":
        # the crowd-covering proposals are never negatives
        rois = got.rois.numpy()
        for slot in np.nonzero(got.roi_valid.numpy() & ~pos)[0]:
            assert not np.allclose(rois[slot], boxes[0], atol=1e-5)


def test_crop_minimask_zero_outside_gt_box(rng):
    """ROIs that overhang the GT box read zero there, not the border row
    (`maskrcnn_tpu/train/targets.py:151-176`), against the JAX crop."""
    mini = (rng.random((28, 28)) > 0.3).astype(np.float32)
    rel = np.array([[-0.25, -0.5, 1.25, 1.5], [0.1, 0.2, 0.6, 0.9],
                    [0.0, 0.0, 1.0, 1.0], [0.5, 0.5, 0.5, 0.5]], np.float32)
    want = np.stack([np.asarray(jax_targets._crop_minimask(
        jnp.asarray(mini), jnp.asarray(r), 28)) for r in rel])
    got = pt_targets._crop_minimask(
        t(np.repeat(mini[None], 4, 0)), t(rel), 28).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got >= 0.5, want >= 0.5)
    # rows 0-4 and columns 0-6 of the first ROI sample outside the GT box
    assert (got[0, :5] == 0).all() and (got[0, :, :7] == 0).all()
    assert got[0, 5:, 7:].any()


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def test_losses_match_jax(rng):
    a, k, n, c, m = 300, 32, 24, 5, 28
    logits = rng.normal(0, 2, (a, 2)).astype(np.float32)
    labels = rng.integers(-1, 2, a).astype(np.int32)
    pred = rng.normal(0, 1.5, (a, 4)).astype(np.float32)
    pos_idx = rng.integers(0, a, k).astype(np.int32)
    pos_valid = rng.random(k) > 0.3
    pos_deltas = rng.normal(0, 1, (k, 4)).astype(np.float32)
    cls_logits = rng.normal(0, 2, (n, c)).astype(np.float32)
    class_ids = rng.integers(0, c, n).astype(np.int32)
    roi_valid = rng.random(n) > 0.2
    pred_deltas = rng.normal(0, 1.5, (n, c, 4)).astype(np.float32)
    tgt_deltas = rng.normal(0, 1, (n, 4)).astype(np.float32)
    masks = rng.random((n, m, m, c)).astype(np.float32)
    masks[0, :3] = 0.0                      # the clip at 1e-7
    masks[1, :3] = 1.0
    tgt_masks = (rng.random((n, m, m)) > 0.5).astype(np.float32)
    j = jnp.asarray
    pairs = [
        (jax_L.rpn_class_loss(j(logits), j(labels)),
         pt_L.rpn_class_loss(t(logits), t(labels))),
        (jax_L.rpn_bbox_loss(j(pred), j(pos_deltas), j(pos_idx),
                             j(pos_valid)),
         pt_L.rpn_bbox_loss(t(pred), t(pos_deltas), t(pos_idx).long(),
                            t(pos_valid))),
        (jax_L.mrcnn_class_loss(j(cls_logits), j(class_ids), j(roi_valid)),
         pt_L.mrcnn_class_loss(t(cls_logits), t(class_ids), t(roi_valid))),
        (jax_L.mrcnn_bbox_loss(j(pred_deltas), j(tgt_deltas), j(class_ids)),
         pt_L.mrcnn_bbox_loss(t(pred_deltas), t(tgt_deltas), t(class_ids))),
        (jax_L.mrcnn_mask_loss(j(masks), j(tgt_masks), j(class_ids)),
         pt_L.mrcnn_mask_loss(t(masks), t(tgt_masks), t(class_ids))),
    ]
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=f"loss {i}")
    # nothing valid: 0, not a division by zero
    none = torch.zeros(a, dtype=torch.int32)
    assert float(pt_L.rpn_class_loss(t(logits), none)) == 0


# --------------------------------------------------------------------------
# compute_losses and its gradients
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["batch", "frozen"])
def losses_and_grads(request):
    """Both packages' compute_losses and gradients on the same params,
    batch and draws (the JAX side jitted), plus the JAX gradients at
    images scaled by (1 +- 2^-18): how far float32 rounding alone moves
    them.

    The port's side runs at the thread count the process started with:
    the one exception to the one-thread rule (`tests/torch_support.py`).
    At one thread the batch-BN `mrcnn_bbox_loss` reads 0.671578 in the
    port against the JAX package's 0.668424, a relative gap of 4.7e-3
    where `test_compute_losses_match_jax` allows 1e-4; at the starting
    count it is inside. The JAX side does not move with torch's threads.
    So the port's batch-BN training loss depends on the CPU thread count:
    a near-tie in the proposals or the ROI sampling that the summation
    order flips, or an op of the training targets whose result depends
    on the count (open, ROADMAP Queue F)."""
    mode = request.param
    overrides = dict(F32, train_bn=mode, train_sampling_topk="exact")
    jcfg = jax_tiny().replace(**overrides)
    pcfg = pt_tiny().replace(**overrides)
    flat = live_bn_params(seed=4, config=jcfg)
    rng = np.random.default_rng(5)
    batch = crowd_batch(rng, jcfg)
    anchors = jax_anchors(jcfg)
    key = jax.random.PRNGKey(11)
    jp = {k: {w: jnp.asarray(v) for w, v in d.items()}
          for k, d in flat.items()}

    @jax.jit
    def value_and_grad(p, images):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["images"] = images
        return jax.value_and_grad(
            lambda q: jax_step.compute_losses(q, jb, jnp.asarray(anchors),
                                              jcfg, key), has_aux=True)(p)

    (_, jm), jg = value_and_grad(jp, jnp.asarray(batch["images"]))
    jg_moved = [value_and_grad(jp, jnp.asarray(
        batch["images"] * np.float32(1 + sign * 2 ** -18)))[1]
        for sign in (1, -1)]
    pool = jcfg.max_proposals + batch["gt_boxes"].shape[1]
    draws = {k: t(v) for k, v in jax_draws(key, 2, anchors.shape[0],
                                           pool).items()}
    pp = params_from_numpy(flat)
    leaves = [(k, w) for k, d in pp.items() for w in d]
    for k, w in leaves:
        pp[k][w].requires_grad_(True)
    with starting_threads():
        total, pm = pt_step.compute_losses(
            pp, {k: t(v) for k, v in batch.items()}, t(anchors), pcfg,
            draws)
        grads = torch.autograd.grad(total, [pp[k][w] for k, w in leaves],
                                    allow_unused=True)
    pg = {}
    for (k, w), g in zip(leaves, grads):
        pg.setdefault(k, {})[w] = (np.zeros(pp[k][w].shape, np.float32)
                                   if g is None else g.numpy())
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    return (mode, {k: float(v) for k, v in jm.items()},
            {k: float(v.detach()) for k, v in pm.items()}, as_np(jg),
            [as_np(g) for g in jg_moved], pg)


def test_compute_losses_match_jax(losses_and_grads):
    mode, jm, pm, _, _, _ = losses_and_grads
    assert set(jm) == set(pm)
    for k in jm:
        # float32 layers summed in another order through the backbone
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{mode}: {k}")
    assert all(np.isfinite(v) for v in pm.values())


# leaves whose spread term (below) exceeds 5% of their largest gradient, at
# most: 244 of 384 with batch BN and 2 with frozen BN in this fixture
LOOSE_LEAVES = {"batch": 256, "frozen": 8}


def test_compute_losses_grads_match_jax(losses_and_grads, record_property):
    """Each leaf's gradient against the JAX one, within 1e-2 of its
    largest |grad| plus twice the JAX gradient's own move when the images
    change by +-2^-18 of themselves (the larger of the two; 2^-18 is about
    the port's own float32 distance from JAX at C2, 3e-6). That move is
    float32 rounding flipping ReLU gates near zero (and proposal and
    sampling decisions downstream), which batch statistics carry through
    every later layer: with batch BN it exceeds 5% of the leaf's largest
    gradient for most leaves at this size, so this check is loose there,
    and `test_batch_bn_module_grads_match_jax` holds the batch-BN layers
    tightly one module at a time; with frozen BN it is nil but for two
    leaves, and the port stays within 0.5%. The leaves whose spread term
    exceeds 5% are recorded (`loose_leaves` in the JUnit report) and
    bounded by LOOSE_LEAVES."""
    mode, _, _, jg, jg_moved, pg = losses_and_grads
    assert set(jg) == set(pg)
    bad, loose = [], []
    for layer, ws in jg.items():
        for w, want in ws.items():
            got = pg[layer][w]
            scale = np.abs(want).max()
            err = np.abs(got - want).max()
            spread = max(np.abs(g[layer][w] - want).max() for g in jg_moved)
            if 2 * spread > 0.05 * scale:
                loose.append(f"{layer}/{w}")
            if err > 1e-2 * scale + 2 * spread + 1e-9:
                bad.append((layer, w, err, spread, scale))
    record_property("loose_leaves", " ".join(loose))
    assert not bad, bad[:10]
    assert len(loose) <= LOOSE_LEAVES[mode], (len(loose), loose)
    # batch BN never reads the moving statistics; frozen BN does
    mm = np.abs(pg["bn_conv1"]["moving_mean"]).max()
    assert (mm == 0) if mode == "batch" else (mm > 0)
    assert np.abs(pg["conv1"]["kernel"]).max() > 0


BATCH_BN = {"use_batch_stats": True, "collect": None}
HEAD_ROIS = 4


def _bn_after(layer, params):
    """The BN that normalizes `layer`'s output, or None."""
    bn = ("bn_conv1" if layer == "conv1" else
          "bn" + layer[3:] if layer.startswith("res") else
          layer.replace("_conv", "_bn") if "_conv" in layer else None)
    return bn if bn in params else None


def _module_case(name, rng, cfg):
    """(layers, JAX fn, port fn, inputs) of one batch-BN module at a small
    size: fn(params, inputs) -> the module's outputs."""
    nc = cfg.num_classes
    if name == "stem":
        return (("conv1", "bn_conv1"),
                lambda p, xs: [jax_resnet._stem_xla(p, xs[0], jnp.float32,
                                                    BATCH_BN)],
                lambda p, xs: [pt_resnet._stem_layers(p, xs[0], torch.float32,
                                                      BATCH_BN)],
                [rng.uniform(-124, 132, (2, 64, 64, 3)).astype(np.float32)])
    if name == "res3ab":
        def chain(resnet, dtype):
            def fn(p, xs):
                y = resnet._bottleneck(xs[0], p, 3, "a", True, 2, dtype,
                                       BATCH_BN)
                return [resnet._bottleneck(y, p, 3, "b", False, 1, dtype,
                                           BATCH_BN)]
            return fn
        return (tuple(f"{k}3{b}_branch{c}" for k in ("res", "bn")
                      for b in "ab" for c in ("2a", "2b", "2c", "1")
                      if b == "a" or c != "1"),
                chain(jax_resnet, jnp.float32), chain(pt_resnet, torch.float32),
                [rng.standard_normal((2, 16, 16, 256)).astype(np.float32)])

    def heads(h, dtype):
        def fn(p, xs):
            _, deltas, logits = h.apply_classifier_head(
                p, xs[0], nc, dtype=dtype, with_logits=True, bn_ctx=BATCH_BN)
            return [logits, deltas,
                    h.apply_mask_head(p, xs[1], dtype=dtype, bn_ctx=BATCH_BN)]
        return fn
    c = cfg.fpn_channels
    return (tuple(k for k in live_bn_params(seed=4, config=cfg)
                  if k.startswith("mrcnn_")),
            heads(jax_heads, jnp.float32), heads(pt_heads, torch.float32),
            [rng.standard_normal((HEAD_ROIS, s, s, c)).astype(np.float32)
             for s in (7, 14)])


@pytest.mark.parametrize("name", ["stem", "res3ab", "heads"])
def test_batch_bn_module_grads_match_jax(name):
    """The batch-BN layers one module at a time, at sizes where float32
    rounding flips no ReLU gate (unlike the whole model, see
    `test_compute_losses_grads_match_jax`; the mask head flips some from 8
    ROIs on, hence HEAD_ROIS): JAX's own gradients move by under 1% of each
    leaf's largest when the inputs change by +-2^-18 (here by under 1e-4),
    and every leaf of the port is held within 1% of its largest of JAX's
    (here it comes within 3e-5). A
    conv bias that a batch BN follows has a gradient of zero but for
    rounding (the BN takes the shift out again): both packages' within
    1e-3 of the layer's largest kernel gradient. The moving statistics get
    none."""
    cfg = jax_tiny().replace(**F32)
    flat = live_bn_params(seed=4, config=cfg)
    rng = np.random.default_rng(6)
    layers, jfn, pfn, xs = _module_case(name, rng, cfg)
    sub = {k: flat[k] for k in layers}
    outs = jfn(jax_tree(sub), [jnp.asarray(x) for x in xs])
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]

    @jax.jit
    def jax_grads(p, inputs):
        return jax.grad(lambda q: sum(
            jnp.sum(o * c) for o, c in zip(jfn(q, inputs), cots)))(p)

    jg = jax.tree_util.tree_map(np.asarray, jax_grads(
        jax_tree(sub), [jnp.asarray(x) for x in xs]))
    moved = [jax.tree_util.tree_map(np.asarray, jax_grads(
        jax_tree(sub), [jnp.asarray(x * np.float32(1 + sign * 2 ** -18))
                         for x in xs])) for sign in (1, -1)]

    pp = params_from_numpy(sub)
    leaves = [(k, w) for k, d in pp.items() for w in d]
    for k, w in leaves:
        pp[k][w].requires_grad_(True)
    total = sum((o * t(c)).sum() for o, c in zip(pfn(pp, [t(x) for x in xs]),
                                                 cots))
    got = dict(zip(leaves, torch.autograd.grad(
        total, [pp[k][w] for k, w in leaves], allow_unused=True)))

    checked = 0
    for (layer, w), g in got.items():
        want = jg[layer][w]
        if w.startswith("moving"):
            assert g is None and not want.any(), (layer, w)
            continue
        g = g.numpy()
        if w == "bias" and _bn_after(layer, flat):
            k_scale = np.abs(jg[layer]["kernel"]).max()
            assert np.abs(want).max() <= 1e-3 * k_scale, (layer, "jax")
            assert np.abs(g).max() <= 1e-3 * k_scale, (layer, "port")
            continue
        scale = np.abs(want).max()
        assert scale > 0, (layer, w)
        spread = max(np.abs(m[layer][w] - want).max() for m in moved)
        assert spread <= 1e-2 * scale, (layer, w, spread / scale)
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-2 * scale,
                                   err_msg=f"{layer}/{w}")
        checked += 1
    assert checked >= len(layers)


# --------------------------------------------------------------------------
# the optimizer against the optax chain
# --------------------------------------------------------------------------

def _opt_params(rng):
    return {
        "conv1": {"kernel": rng.normal(size=(3, 3, 4, 8)),
                  "bias": rng.normal(size=(8,))},
        "bn_conv1": {"gamma": rng.normal(size=(8,)),
                     "beta": rng.normal(size=(8,)),
                     "moving_mean": np.zeros(8),
                     "moving_variance": np.ones(8)},
        "rpn_conv_shared": {"kernel": rng.normal(size=(1, 1, 8, 8))},
        "mrcnn_class_logits": {"kernel": rng.normal(size=(8, 5)),
                               "bias": rng.normal(size=(5,))},
    }


@pytest.mark.parametrize("momentum", ["float32", "bfloat16"])
@pytest.mark.parametrize("trainable", ["all", "heads"])
@pytest.mark.parametrize("train_bn", ["batch", "frozen"])
@pytest.mark.parametrize("grad_scale", [10.0, 0.01], ids=["clip", "noclip"])
def test_optimizer_matches_optax(train_bn, trainable, momentum, grad_scale):
    """`apply_gradients` (the update `train_step` makes) against
    `make_optimizer`'s optax chain for 3 steps, atol 1e-7 (the global norm
    is summed in another order); `grad_scale` 10 puts the norm over the
    clip, 0.01 under it."""
    import optax
    rng = np.random.default_rng(0)
    flat = {k: {w: np.asarray(v, np.float32) for w, v in d.items()}
            for k, d in _opt_params(rng).items()}
    grads = [{k: {w: (rng.normal(size=v.shape) * grad_scale)
                  .astype(np.float32) for w, v in d.items()}
              for k, d in flat.items()} for _ in range(3)]
    cfg = dict(train_bn=train_bn, train_momentum_dtype=momentum)
    tx, mask_fn = jax_step.make_optimizer(jax_tiny().replace(**cfg),
                                          trainable)
    jp = jax.tree_util.tree_map(jnp.asarray, flat)
    js = tx.init(jp)
    state, opt = pt_step.make_train_state(params_from_numpy(flat),
                                          pt_tiny().replace(**cfg), trainable)
    for g in grads:
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        mask = mask_fn(jp)
        if mask is not None:
            jg = jax.tree_util.tree_map(
                lambda gg, m: gg * jnp.asarray(m, gg.dtype), jg, mask)
        up, js = tx.update(jg, js, jp)
        jp = optax.apply_updates(jp, up)
        state = pt_step.apply_gradients(state, params_from_numpy(g), opt)
    assert state.step == 3
    for layer, ws in jp.items():
        for w, want in ws.items():
            got = state.params[layer][w]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-7,
                                       err_msg=f"{layer}/{w}")
    want_dtype = torch.bfloat16 if momentum == "bfloat16" else torch.float32
    assert all(v.dtype == want_dtype for ws in state.momentum.values()
               for v in ws.values())
    frozen_bn = train_bn == "frozen"
    moved = not np.array_equal(state.params["bn_conv1"]["gamma"].numpy(),
                               flat["bn_conv1"]["gamma"])
    assert moved == (trainable == "all" and not frozen_bn)


def test_optimizer_masks_match_jax():
    """`trainable_mask` / `decay_mask` leaf for leaf, over the tiny model's
    layer names and every preset."""
    from maskrcnn_tpu_torch.models.mask_rcnn import init_mask_rcnn
    params = init_mask_rcnn(torch.Generator().manual_seed(0), pt_tiny())
    jparams = {k: {w: jnp.zeros(()) for w in d} for k, d in params.items()}
    for train_bn in ("batch", "frozen"):
        for trainable in list(pt_step.FREEZE_PRESETS) + ["res[45].*"]:
            cfg = dict(train_bn=train_bn)
            _, mask_fn = jax_step.make_optimizer(jax_tiny().replace(**cfg),
                                                 trainable)
            opt = pt_step.make_optimizer(pt_tiny().replace(**cfg), trainable)
            assert opt.trainable_mask(params) == mask_fn(jparams)


# --------------------------------------------------------------------------
# the kernels under autograd (their plain forwards on the CPU)
# --------------------------------------------------------------------------

def _grads(fn, params, x, cot):
    """Gradients of sum(fn(params, x) * cot) for every param and x."""
    leaves = [(k, w) for k, d in params.items() for w in d]
    p = {k: {w: v.detach().clone().requires_grad_(True)
             for w, v in d.items()} for k, d in params.items()}
    xx = x.detach().clone().requires_grad_(x.is_floating_point())
    y = fn(p, xx)
    g = torch.autograd.grad((y.float() * cot.float()).sum(),
                            [p[k][w] for k, w in leaves] + [xx])
    return {f"{k}/{w}": v for (k, w), v in zip(leaves, g)}, g[-1], y


def test_stem_function_grads_equal_plain_graph_and_jax():
    """`StemFusedDiff`: gradients bit-equal to the port's own layer graph
    (its backward is that graph's vjp), within bf16 rounding of JAX's
    `_stem_fused_diff` in interpret mode; the forward is the kernel's
    plain version."""
    rng = np.random.default_rng(0)
    sp = stem_params(rng)
    images = rng.uniform(-124, 132, (1, 64, 64, 3)).astype(np.float32)
    cot = rng.standard_normal((1, 16, 16, 64)).astype(np.float32)
    pp = params_from_numpy(sp)
    cot_t = t(cot).to(torch.bfloat16)
    cuda_lib.reset_launches()
    g_fn, gi_fn, y_fn = _grads(stem_cuda.stem_fused_diff, pp, t(images),
                               cot_t)
    g_pl, gi_pl, _ = _grads(
        lambda p, x: pt_resnet._stem_layers(p, x, torch.bfloat16), pp,
        t(images), cot_t)
    for k in g_pl:
        assert torch.equal(g_fn[k], g_pl[k]), k
    assert torch.equal(gi_fn, gi_pl)
    assert torch.equal(y_fn, stem_cuda.apply_stem(pp, t(images)))
    assert not any(cuda_lib.launches.values())

    jp = jax_tree(sp)
    jcot = jnp.asarray(cot, jnp.bfloat16)

    def loss(p, im):
        return jnp.sum(jax_resnet._stem_fused_diff(p, im).astype(jnp.float32)
                       * jcot.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        jg, _ = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(images))
    for k, got in g_fn.items():
        layer, w = k.split("/")
        want = np.asarray(jg[layer][w], np.float32)
        # bf16 activations rounded at the same points, float32 sums in
        # another order: within 2% of the leaf's largest gradient
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=0.02 * np.abs(want).max(), err_msg=k)


def test_chain_function_grads_equal_plain_graph_and_jax():
    """`ChainFusedDiff` over res2 a-b (a projection block, then an
    identity one), as `test_train_fused_kernels.py` does for the JAX
    wrapper."""
    rng = np.random.default_rng(2)
    sp = stage_params(rng, 2, 32, 16, 64, "ab", True)
    x = rng.standard_normal((1, 16, 24, 32)).astype(np.float32)
    cot = rng.standard_normal((1, 16, 24, 64)).astype(np.float32)
    pp = params_from_numpy(sp)
    xt = t(x).to(torch.bfloat16)
    cot_t = t(cot).to(torch.bfloat16)

    def plain(p, xx):
        for letter in "ab":
            xx = pt_resnet._bottleneck(xx, p, 2, letter, letter == "a", 1,
                                       torch.bfloat16)
        return xx

    g_fn, gx_fn, y_fn = _grads(
        lambda p, xx: bottleneck_cuda.chain_fused_diff(p, 2, "ab", xx), pp,
        xt, cot_t)
    g_pl, gx_pl, _ = _grads(plain, pp, xt, cot_t)
    for k in g_pl:
        assert torch.equal(g_fn[k], g_pl[k]), k
    assert torch.equal(gx_fn, gx_pl)
    blocks = bottleneck_cuda.fold_bottleneck_chain(pp, 2, "ab")
    assert torch.equal(y_fn, bottleneck_cuda.chain_plain(xt, blocks))
    assert pt_resnet._chain_keys(2, "ab") == jax_resnet._chain_keys(2, "ab")

    jp = jax_tree(sp)
    jcot = jnp.asarray(cot, jnp.bfloat16)

    def loss(p, xx):
        y = jax_resnet._chain_fused_diff(2, "ab", 8, p, xx)
        return jnp.sum(y.astype(jnp.float32) * jcot.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        jg, jgx = jax.grad(loss, argnums=(0, 1))(
            jp, jnp.asarray(x, jnp.bfloat16))
    # bf16 activations and bf16 gradients, each a float32 sum in another
    # order rounded to 8 bits, through two blocks; the bias gradients are
    # sums that partly cancel: each leaf within 8% of its norm (relative
    # L2; 0.6-5.5% here), the input's gradient too
    for k, got in list(g_fn.items()) + [("x", gx_fn)]:
        want = np.asarray(jgx if k == "x" else jg[k.split("/")[0]][
            k.split("/")[1]], np.float32)
        rel = (np.linalg.norm(got.float().numpy() - want)
               / np.linalg.norm(want))
        assert rel <= 0.08, (k, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_function_grads_equal_plain(dtype):
    """`RoiAlignDiff` (what `pyramid_roi_align` takes when a feature needs
    a gradient): forward and feature gradients bit-equal to autograd
    through `roi_align_plain`, one level without ROIs included."""
    rng = np.random.default_rng(3)
    feats = [torch.from_numpy(rng.standard_normal((2, s, s, 8))
                              .astype(np.float32)).to(dtype)
             for s in (32, 16, 8, 4)]
    rois = np.concatenate([rng.uniform(0, 0.5, (2, 12, 2)),
                           rng.uniform(0.5, 1.0, (2, 12, 2))], -1)
    rois[:, :5] *= 0.2                     # small: level 2
    rois[:, -2:] = 0.0                     # padding rows
    rois_t = t(rois.astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 12, 7, 7, 8))
                           .astype(np.float32))

    def run(fn):
        fs = [f.clone().requires_grad_(True) for f in feats]
        out = fn(fs)
        g = torch.autograd.grad((out.float() * cot).sum(), fs,
                                allow_unused=True)
        return out, [torch.zeros_like(f) if x is None else x
                     for f, x in zip(fs, g)]

    def plain(fs):
        ys, xs, level, valid = roi_align.prepare(
            rois_t.reshape(-1, 4), [(f.shape[1], f.shape[2]) for f in fs],
            (128, 128), 224.0, 7)
        return roi_align_cuda.roi_align_plain(fs, ys, xs, level, valid,
                                              12).reshape(2, 12, 7, 7, 8)

    out_fn, g_fn = run(lambda fs: roi_align.pyramid_roi_align(
        fs, rois_t, 7, (128, 128)))
    out_pl, g_pl = run(plain)
    assert "RoiAlignDiff" in str(out_fn.grad_fn.next_functions)
    assert torch.equal(out_fn, out_pl)
    for a, b in zip(g_fn, g_pl):
        assert torch.equal(a, b)
    assert any(g.abs().sum() == 0 for g in g_fn)  # a level with no ROI
    with torch.no_grad():                         # inference: no Function
        out = roi_align.pyramid_roi_align(feats, rois_t, 7, (128, 128))
    assert out.grad_fn is None and torch.equal(out, out_fn.detach())


def test_resnet_takes_functions_only_when_asked(monkeypatch):
    """Training with frozen BN and `train_fused_kernels` reaches the kernel
    wrappers only inside `stem_fused_diff` / `chain_fused_diff` (both
    chains); batch BN or the flag off keep the layers; inference calls the
    wrappers directly. The card's gates are opened on the CPU (the
    wrappers then run their plain versions)."""
    calls = []
    monkeypatch.setattr(stem_cuda, "stem_supported", lambda im, dt: True)
    monkeypatch.setattr(
        pt_resnet, "_kernel_chain", lambda p, stage, letters, x, dt:
        bottleneck_cuda.fold_bottleneck_chain(p, stage, letters))
    for mod, name in ((stem_cuda, "stem_fused_diff"),
                      (stem_cuda, "apply_stem"),
                      (bottleneck_cuda, "chain_fused_diff"),
                      (bottleneck_cuda, "fused_bottleneck_chain")):
        def record(*a, _n=name, _f=getattr(mod, name), **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, record)
    from maskrcnn_tpu_torch.models.mask_rcnn import init_mask_rcnn
    params = init_mask_rcnn(torch.Generator().manual_seed(0), pt_tiny())
    x = torch.zeros((1, 64, 64, 3))
    train = ["stem_fused_diff", "apply_stem"] + [
        "chain_fused_diff", "fused_bottleneck_chain"] * 2
    for kw, want in (
            (dict(inference=False, train_fused_kernels=True), train),
            (dict(inference=False), []),
            (dict(inference=False, train_fused_kernels=True,
                  bn_ctx={"use_batch_stats": True}), []),
            (dict(), ["apply_stem"] + ["fused_bottleneck_chain"] * 2)):
        calls.clear()
        pt_resnet.apply_resnet(params, x, "resnet50", dtype=torch.bfloat16,
                               **kw)
        assert calls == want, (kw, calls)


# --------------------------------------------------------------------------
# calibration and whole steps
# --------------------------------------------------------------------------

def _jax_calibration_rois(jp, batches, jcfg):
    """The proposals JAX's calibration pass pools, batch by batch (its
    `_collect_stats` up to `generate_proposals`)."""
    from maskrcnn_tpu.models import rpn as jax_rpn
    from maskrcnn_tpu.models.mask_rcnn import backbone_fpn, preprocess
    from maskrcnn_tpu.ops.proposals import generate_proposals
    anchors = jnp.asarray(jax_anchors(jcfg))

    @jax.jit
    def rois(images):
        pyr = backbone_fpn(jp, preprocess(images, jcfg), jcfg, jnp.float32,
                           bn_ctx={"use_batch_stats": True},
                           inference=False)
        logits, deltas = jax_rpn.apply_rpn(jp, pyr, dtype=jnp.float32)
        return jax.vmap(lambda f, d: generate_proposals(
            f, d, anchors, bbox_std_dev=jcfg.bbox_std_dev,
            pre_nms_max_proposals=jcfg.pre_nms_max_proposals,
            max_proposals=jcfg.max_proposals,
            nms_threshold=jcfg.proposal_nms_threshold,
            topk_recall=jcfg.proposal_topk_recall))(
                logits[..., 1] - logits[..., 0], deltas)

    return [tuple(np.asarray(a) for a in rois(jnp.asarray(b)))
            for b in batches]


def test_calibrate_bn_stats_matches_jax(monkeypatch):
    """Every BN layer's calibrated statistics against JAX's. Batch-BN
    forwards carry float32 rounding far enough (see the gradient test
    above) that near-ties at the proposal top-k and NMS can go the other
    way, which moves the heads' statistics; so the port's proposal stage
    runs, its proposals are compared with JAX's, and the heads then pool
    JAX's (the JAX stage fed into the port's next stage)."""
    from maskrcnn_tpu_torch.train import calibrate as pt_calibrate
    cfg = dict(F32)
    jcfg = jax_tiny().replace(**cfg)
    flat = live_bn_params(seed=6, config=jcfg)
    rng = np.random.default_rng(7)
    batches = [rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
               for _ in range(2)]
    jp = jax_tree(flat)
    want = jax_calibrate(jp, batches, jnp.asarray(jax_anchors(jcfg)), jcfg)
    jax_rois = iter(_jax_calibration_rois(jp, batches, jcfg))
    same = []
    real = pt_calibrate.generate_proposals

    def fed(*a, **k):
        rois, valid = real(*a, **k)
        j_rois, j_valid = next(jax_rois)
        # per image, the share of the port's proposals that JAX also has
        # (anywhere in its list: a near tie may also swap the order)
        for mine, theirs in zip(rois.numpy(), j_rois):
            hit = np.isclose(mine[:, None], theirs[None], rtol=0,
                             atol=1e-5).all(-1).any(1)
            same.append(float(hit.mean()))
        return t(j_rois), t(j_valid)

    monkeypatch.setattr(pt_calibrate, "generate_proposals", fed)
    got = calibrate_bn_stats(params_from_numpy(flat), batches,
                             t(pt_anchors(pt_tiny())),
                             pt_tiny().replace(**cfg))
    # most proposals are JAX's too, the rest near-tie swaps: JAX's own
    # calibration pass keeps 77% and 92% of its proposals on these images
    # when they change by 2^-20 of themselves
    assert len(same) == 4 and min(same) >= 0.5, same
    n_bn = 0
    for layer, ws in want.items():
        for w in ws:
            g = got[layer][w].numpy()
            wv = np.asarray(ws[w])
            if w in ("moving_mean", "moving_variance"):
                n_bn += 1
                # float32 statistics of float32 layers summed in another
                # order (aggregated in float64)
                np.testing.assert_allclose(g, wv, rtol=1e-3,
                                           atol=1e-3 * np.abs(wv).max(),
                                           err_msg=f"{layer}/{w}")
            else:
                np.testing.assert_array_equal(g, wv)
    assert n_bn == 2 * sum("moving_mean" in ws for ws in flat.values())
    with pytest.raises(ValueError, match="no calibration batches"):
        calibrate_bn_stats(params_from_numpy(flat), [], t(pt_anchors(
            pt_tiny())), pt_tiny().replace(**cfg))


def _step_inputs(cfg, seed=0, b=1):
    from maskrcnn_tpu_torch.models.mask_rcnn import init_mask_rcnn
    rng = np.random.default_rng(seed)
    params = init_mask_rcnn(torch.Generator().manual_seed(seed), cfg)
    batch = crowd_batch(rng, cfg, b=b)
    return params, batch, pt_anchors(cfg)


def test_train_step_freezes_as_asked():
    """trainable="heads": the backbone stays, the heads move; frozen BN:
    no BN tensor moves (`make_optimizer`'s whole-layer freeze)."""
    cfg = pt_tiny().replace(**F32)
    params, batch, anchors = _step_inputs(cfg)
    state, opt = pt_step.make_train_state(params, cfg, trainable="heads")
    new, metrics = pt_step.train_step(state, batch, anchors, cfg, opt,
                                      seed=7)
    assert torch.equal(new.params["conv1"]["kernel"],
                       params["conv1"]["kernel"])
    assert not torch.equal(new.params["rpn_conv_shared"]["kernel"],
                           params["rpn_conv_shared"]["kernel"])
    assert new.step == 1 and torch.isfinite(metrics["loss"])

    fcfg = cfg.replace(train_bn="frozen")
    state, opt = pt_step.make_train_state(params, fcfg)
    new, _ = pt_step.train_step(state, batch, anchors, fcfg, opt, seed=7)
    for layer, ws in params.items():
        if "moving_mean" in ws:
            for w in ws:
                assert torch.equal(new.params[layer][w], ws[w]), layer
    assert not torch.equal(new.params["conv1"]["kernel"],
                           params["conv1"]["kernel"])


def test_bf16_momentum_accumulator():
    """`train_momentum_dtype="bfloat16"`: the trace is stored bf16, the
    params stay float32, the loss is the same and the first update equals
    the float32 one to bf16 rounding (`tests/test_training.py`)."""
    cfg = pt_tiny().replace(**F32)
    params, batch, anchors = _step_inputs(cfg)
    out = {}
    for mom in ("float32", "bfloat16"):
        c = cfg.replace(train_momentum_dtype=mom)
        state, opt = pt_step.make_train_state(params, c)
        out[mom] = pt_step.train_step(state, batch, anchors, c, opt, seed=3)
    (sf, mf), (sh, mh) = out["float32"], out["bfloat16"]
    assert {v.dtype for ws in sh.momentum.values() for v in ws.values()} \
        == {torch.bfloat16}
    assert all(v.dtype == torch.float32 for ws in sh.params.values()
               for v in ws.values())
    assert float(mh["loss"]) == float(mf["loss"])
    for layer, ws in sf.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(sh.params[layer][w].numpy(),
                                       v.numpy(), rtol=1e-2, atol=1e-5)


def test_train_step_draws_follow_seed_and_step():
    """The sampling scores are a pure function of (seed, step): a step
    repeated from the same state repeats exactly; another seed draws
    otherwise."""
    g1 = pt_step.step_generator(5, 3, "cpu")
    g2 = pt_step.step_generator(5, 3, "cpu")
    a = pt_step.draw_uniforms(g1, 2, 100, 20, "cpu")
    b = pt_step.draw_uniforms(g2, 2, 100, 20, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = pt_step.draw_uniforms(pt_step.step_generator(5, 4, "cpu"), 2, 100,
                              20, "cpu")
    assert not torch.equal(a["rpn_p"], c["rpn_p"])
    assert a["rpn_p"].shape == (2, 100) and a["roi_n"].shape == (2, 20)


def test_train_step_remat_equals_plain():
    """`train_remat_backbone` recomputes the backbone in the backward
    (torch.utils.checkpoint): same losses and params."""
    cfg = pt_tiny().replace(**F32)
    params, batch, anchors = _step_inputs(cfg)
    out = []
    for remat in (False, True):
        c = cfg.replace(train_remat_backbone=remat)
        state, opt = pt_step.make_train_state(params, c)
        out.append(pt_step.train_step(state, batch, anchors, c, opt, seed=1))
    (s0, m0), (s1, m1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    for layer, ws in s0.params.items():
        for w, v in ws.items():
            torch.testing.assert_close(s1.params[layer][w], v, rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.slow
def test_train_step_reduces_loss():
    """Six steps on one fixed batch and draw seed lower the loss (the JAX
    package's `slow` overfit test)."""
    cfg = pt_tiny()
    params, batch, anchors = _step_inputs(cfg)
    state, opt = pt_step.make_train_state(params, cfg)
    losses = []
    for _ in range(6):
        state, metrics = pt_step.train_step(state, batch, anchors, cfg, opt,
                                            draws=None, seed=42)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses


@pytest.mark.slow
def test_flagship_train_step_runs():
    """R101-FPN @ 1024^2, 81 classes, one step at batch 1 on the CPU (the
    JAX package traces its flagship step; eager PyTorch runs it)."""
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    cfg = MaskRCNNConfig(architecture="resnet101")
    params, batch, anchors = _step_inputs(cfg)
    state, opt = pt_step.make_train_state(params, cfg)
    state, metrics = pt_step.train_step(state, batch, anchors, cfg, opt)
    assert state.step == 1
    assert all(torch.isfinite(v) for v in metrics.values())
