"""What the port's tests share: the one-thread rule, and every helper that
more than one `tests/test_torch_*.py` file uses.

The one-thread rule. Tier-1 runs the suite in several worker processes at
once on a machine with few cores. A worker at torch's default count runs
each op on an intra-op pool as wide as the machine, whose threads spin
against the other workers' (the port's longest files ran 2-10x slower so).
And the multi-threaded CPU backward accumulates some gradients (the
ROIAlign backward's scatter into the features) in an order that changes
from run to run, which bit-equality of two runs cannot allow. So every
`tests/test_torch_*.py` but `test_torch_gpu.py` imports `one_thread`, a
module-scoped autouse fixture that holds torch at one intra-op thread
while the module runs:

    from tests.torch_support import one_thread  # noqa: F401  (autouse)

A process the tests start takes the same rule: a spawned rank calls
`pin_one_thread()`, a fresh interpreter runs with `one_thread_env()`.

One exception: `tests/test_torch_train.py::losses_and_grads` runs the
port's side under `starting_threads()`, the count the process started
with, because the batch-BN `mrcnn_bbox_loss` moves with the thread count
(the fixture's docstring has the numbers).

`tests/test_torch_gpu.py` keeps torch's threads: it runs alone on the
card's machine, and every test in it skips without a card.

This is the one file of `tests/` besides the `test_torch_*` files that
imports both packages. It imports JAX only inside the helpers that use
it: `tests/test_torch_gpu.py` and `tests/test_torch_kernel_bias.py` import
this module where JAX is missing."""

import contextlib
import os

import numpy as np
import pytest
import torch

from maskrcnn_tpu_torch.io.weights import params_from_numpy
from maskrcnn_tpu_torch.models import heads as pt_heads
from maskrcnn_tpu_torch.models import resnet as pt_resnet
from maskrcnn_tpu_torch.models.mask_rcnn import init_mask_rcnn
from maskrcnn_tpu_torch.ops import (bottleneck_cuda, conv_epilogue_cuda,
                                    roi_align, roi_align_cuda)

# --------------------------------------------------------------------------
# the one-thread rule
# --------------------------------------------------------------------------

# read when the test modules are collected, before any fixture runs
STARTING_THREADS = torch.get_num_threads()


@contextlib.contextmanager
def torch_threads(n):
    """torch's intra-op pool at `n` threads inside the block, the count
    before it restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The rule of this module's docstring, for the importing module."""
    with torch_threads(1):
        yield


def starting_threads():
    """The one exception to the rule: the thread count the process started
    with, inside the block."""
    return torch_threads(STARTING_THREADS)


def pin_one_thread():
    """The rule for a process the tests spawn, for the rest of its life."""
    torch.set_num_threads(1)


def one_thread_env():
    """The environment of a fresh interpreter under the rule (torch reads
    OMP_NUM_THREADS when it starts)."""
    return dict(os.environ, OMP_NUM_THREADS="1")


# --------------------------------------------------------------------------
# numpy and torch inputs drawn from a seed
# --------------------------------------------------------------------------

TOL = dict(rtol=1e-4, atol=1e-4)
# random heads rarely reach 0.7; a low threshold sends real boxes to the
# detection NMS and the mask branch
OVERRIDES = dict(compute_dtype="float32", detection_score_threshold=0.25)


def t(a):
    return torch.from_numpy(np.array(a))


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


def live_bn(params, gen):
    """Every BN's parameters of the port's `params` drawn from `gen` (random
    init zeroes each block's last gamma, which makes every branch2a/2b
    kernel's gradient exactly zero)."""
    for w in params.values():
        if "moving_variance" in w:
            c = w["gamma"].shape[0]
            u = lambda lo, hi: torch.rand(c, generator=gen) * (hi - lo) + lo
            w["gamma"], w["beta"] = u(0.3, 0.8), u(-0.2, 0.2)
            w["moving_mean"], w["moving_variance"] = u(-0.2, 0.2), u(0.5, 2.0)


def off_identity(params, g):
    """A transformer backbone's {layer: {weight}} with its LayerNorms'
    scale and shift, its dense biases and its relative-position tables
    (`table`) drawn from `g` off their init (tables to +-1.5, as the
    benchmark's Swin weights); in place, and returned."""
    for name, p in params.items():
        if "norm" in name:
            c = p["scale"].shape[0]
            p["scale"] = torch.rand(c, generator=g) + 0.5
            p["bias"] = torch.randn(c, generator=g) * 0.2
        elif "bias" in p:
            p["bias"] = torch.randn(p["bias"].shape, generator=g) * 0.5
        if "table" in p:
            p["table"] = torch.rand(p["table"].shape, generator=g) * 3 - 1.5
    return params


def port_params(config, seed=0):
    """The port's random params, each BN's statistics redrawn from the seed
    so every residual branch is live."""
    gen = torch.Generator().manual_seed(seed)
    params = init_mask_rcnn(gen, config)
    live_bn(params, gen)
    return params


def resnet_case(seed=3, arch="resnet50", side=64, b=1, dev="cpu"):
    """`init_resnet` params with every BN and conv bias drawn from the
    seed (`rand_bn`; init zeroes the biases) and (b, side, side, 3)
    mean-subtracted images, on `dev`."""
    rng = np.random.default_rng(seed)
    params = pt_resnet.init_resnet(torch.Generator().manual_seed(seed), arch)
    for name, p in params.items():
        if name.startswith("bn"):
            p.update({k: torch.from_numpy(v) for k, v
                      in rand_bn(rng, p["gamma"].shape[0]).items()})
        else:
            p["bias"] = torch.from_numpy((rng.standard_normal(
                p["bias"].shape[0]) * 0.1).astype(np.float32))
    params = {k: {w: v.to(dev) for w, v in d.items()}
              for k, d in params.items()}
    images = torch.from_numpy(rng.uniform(-120, 130, (b, side, side, 3))
                              .astype(np.float32)).to(dev)
    return params, images


def make_gt(rng, g=4, num_classes=5, m=28):
    """`tests/test_training.py::make_gt`: random GT boxes, classes and
    mini-masks of one image."""
    yx1 = rng.uniform(0, 0.6, (g, 2))
    wh = rng.uniform(0.1, 0.3, (g, 2))
    boxes = np.concatenate([yx1, yx1 + wh], -1).astype(np.float32)
    classes = rng.integers(1, num_classes, (g,)).astype(np.int32)
    masks = (rng.random((g, m, m)) > 0.4).astype(np.float32)
    return boxes, classes, masks


def crowd_batch(rng, cfg, b=2, g=4):
    """A training batch of `b` images, each with `make_gt`'s GT, the last
    image's first region a crowd."""
    gts = [make_gt(rng, g, cfg.num_classes) for _ in range(b)]
    batch = {
        "images": rng.uniform(0, 255, (b, cfg.image_height, cfg.image_width,
                                       3)).astype(np.float32),
        "gt_boxes": np.stack([x[0] for x in gts]),
        "gt_class_ids": np.stack([x[1] for x in gts]),
        "gt_masks": np.stack([x[2] for x in gts]),
    }
    batch["gt_class_ids"][-1, 0] *= -1      # one crowd region
    return batch


def train_batch(cfg, b, seed=0):
    """`tests/test_parallel.py::_train_batch`."""
    g, m = 4, 28
    rng = np.random.default_rng(seed)
    yx1 = rng.uniform(0, 0.6, (b, g, 2))
    wh = rng.uniform(0.1, 0.3, (b, g, 2))
    return {
        "images": rng.uniform(0, 255, (b, cfg.image_height,
                                       cfg.image_width, 3)).astype(
            np.float32),
        "gt_boxes": np.concatenate([yx1, yx1 + wh], -1).astype(np.float32),
        "gt_class_ids": rng.integers(1, cfg.num_classes, (b, g)).astype(
            np.int32),
        "gt_masks": (rng.random((b, g, m, m)) > 0.5).astype(np.float32),
    }


# --------------------------------------------------------------------------
# kernel cases: each kernel's inputs, fed to its plain version on the CPU
# and to the kernel on the card
# --------------------------------------------------------------------------

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


def roi_case(seed=0, b=2, c=32, base=64, n=50, dtype=torch.float32):
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


def chain_case(seed=0, stage=2, cin=64, mid=64, cout=256, hw=(32, 32)):
    """A projection block, then two identity blocks."""
    rng = np.random.default_rng(seed)
    params = stage_params(rng, stage, cin, mid, cout, "abc", True)
    blocks = bottleneck_cuda.fold_bottleneck_chain(
        params_from_numpy(params), stage, "abc")
    x = torch.from_numpy(rng.standard_normal((2, *hw, cin))
                         .astype(np.float32)).to(torch.bfloat16)
    return x, blocks


def epilogue_case(seed=0, b=2, side=8, c=64, form="projection", dev="cpu"):
    """A raw bf16 conv output y (b, side, side, c) with -0.0 and +-inf among
    its values, its layer's constants (`conv_epilogue_cuda.prepare` of a
    1x1 conv with a bias and a BN layer drawn from the seed), for the
    identity and projection forms a residual (the block input, or the raw
    shortcut output with -0.0 among its values) and for the projection the
    shortcut's constants: (y, layer, residual, shortcut, params), params
    the conv and BN dicts ("conv", "bn", "sconv", "sbn") they came from."""
    rng = np.random.default_rng(seed)

    def raw():
        v = (rng.standard_normal((b, side, side, c)) * 2).astype(np.float32)
        v.reshape(-1)[rng.choice(v.size, 3 + v.size // 1000,
                                 replace=False)] = -0.0
        return torch.from_numpy(v).to(dev).to(torch.bfloat16)

    def layer(prefix):
        params[prefix + "conv"] = {k: torch.from_numpy(v).to(dev) for k, v
                                   in rand_conv(rng, 1, 1, 8, c).items()}
        params[prefix + "bn"] = {k: torch.from_numpy(v).to(dev)
                                 for k, v in rand_bn(rng, c).items()}
        return conv_epilogue_cuda.prepare(params[prefix + "conv"],
                                          params[prefix + "bn"])

    params = {}
    y = raw()
    y.view(-1)[:4] = torch.tensor([float("inf"), -float("inf")] * 2)
    lc = layer("")
    residual = None if form == "bn_relu" else raw()
    shortcut = layer("s") if form == "projection" else None
    return y, lc, residual, shortcut, params


EDGE_ROIS = np.float32([
    [0.0, 0.0, 0.3, 0.4],      # top-left corner
    [0.6, 0.7, 1.0, 1.0],      # bottom-right corner
    [0.0, 0.2, 1.0, 0.5],      # top to bottom
    [0.3, 0.0, 0.5, 1.0],      # left to right
    [0.0, 0.0, 1.0, 1.0],      # the whole image
])


def head_case(seed=0, b=2, n=20, crop=7, c=256, dtype=torch.float32):
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


# --------------------------------------------------------------------------
# the JAX package's side (JAX imported on first use)
# --------------------------------------------------------------------------

def jax_tree(flat):
    """Flat numpy params as the JAX package's tree of arrays."""
    import jax.numpy as jnp
    return {k: {w: jnp.asarray(v) for w, v in d.items()}
            for k, d in flat.items()}


def live_bn_params(seed=0, config=None):
    """JAX `init_mask_rcnn` params as numpy (of `config`, default the tiny
    one), every BN's statistics redrawn so each residual branch is live."""
    import jax
    from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
    from maskrcnn_tpu.models import mask_rcnn as jax_model
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


def jit_live_bn_params(seed, config):
    """`live_bn_params` with the JAX init jitted (eagerly, its random draws
    take 10-20 s): the same values."""
    import jax
    from maskrcnn_tpu.models import mask_rcnn as jax_model
    init = jax.jit(lambda k, f=jax_model.init_mask_rcnn: f(k, config))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "init_mask_rcnn", lambda key, cfg: init(key))
        return live_bn_params(seed=seed, config=config)


def jax_draws(key, b, a, p):
    """The uniform scores `compute_losses` draws from `key`
    (`maskrcnn_tpu/train/step.py:68`: split(key, 2B) -> per image one key
    for the anchors and one for the proposal pool, each split in two)."""
    import jax
    keys = jax.random.split(key, b * 2).reshape(b, 2, 2)
    out = {"rpn_p": [], "rpn_n": [], "roi_p": [], "roi_n": []}
    for i in range(b):
        for stage, n in (("rpn", a), ("roi", p)):
            kp, kn = jax.random.split(keys[i, 0 if stage == "rpn" else 1])
            out[stage + "_p"].append(np.asarray(jax.random.uniform(kp, (n,))))
            out[stage + "_n"].append(np.asarray(jax.random.uniform(kn, (n,))))
    return {k: np.stack(v) for k, v in out.items()}
