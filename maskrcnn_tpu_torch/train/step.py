"""One Mask-RCNN training step, port of `maskrcnn_tpu/train/step.py`.

`compute_losses` is the two-stage objective: RPN class and box losses over
balanced anchor samples, head class, box and mask losses over sampled
proposals (the GT boxes appended to the pool). `train_step` takes its
gradient and applies the optax chain of the JAX package, written out:
the trainable mask, `clip_by_global_norm(5.0)`, weight decay on the
kernels of the trainable layers, SGD momentum 0.9 (the trace stored in
`train_momentum_dtype`), then the learning rate (the Matterport recipe:
lr 1e-3, decay 1e-4). `torch.optim.SGD` differs: it adds the decay to
every parameter, before any clipping.

Randomness: the target sampling's uniform scores are drawn per step from
a generator seeded by (seed, step) (`step_generator`), the counterpart of
`jax.random.fold_in`, so a resumed run draws what an uninterrupted one
does; a caller (a test) may pass the draws instead.

On the card the path runs K1 (proposal NMS, on detached scores) and K2
(both pools, `ops/roi_align_cuda.RoiAlignDiff`) and, with frozen BN and
`config.train_fused_kernels`, K3 and K4 (their autograd Functions,
`models/resnet.py`). The heads are the unfused ones, as in the JAX
package (K5 and K6 are not on this path).
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
from maskrcnn_tpu_torch.models import heads as heads_mod
from maskrcnn_tpu_torch.models import rpn as rpn_mod
from maskrcnn_tpu_torch.models.mask_rcnn import (backbone_fpn, compute_dtype,
                                                 preprocess)
from maskrcnn_tpu_torch.ops.proposals import generate_proposals
from maskrcnn_tpu_torch.ops.roi_align import pyramid_roi_align
from maskrcnn_tpu_torch.train import losses as L
from maskrcnn_tpu_torch.train.targets import proposal_targets, rpn_targets

# Matterport's stage-wise fine-tuning layer regexes ("heads", "3+", ...).
FREEZE_PRESETS = {
    "all": r".*",
    "heads": r"(mrcnn_.*|rpn_.*|fpn_.*)",
    "3+": r"(res3.*|bn3.*|res4.*|bn4.*|res5.*|bn5.*|mrcnn_.*|rpn_.*|fpn_.*)",
    "4+": r"(res4.*|bn4.*|res5.*|bn5.*|mrcnn_.*|rpn_.*|fpn_.*)",
    "5+": r"(res5.*|bn5.*|mrcnn_.*|rpn_.*|fpn_.*)",
}

_BN_WEIGHTS = {"gamma", "beta", "moving_mean", "moving_variance"}
_MOMENTUM = 0.9
_CLIP_NORM = 5.0


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of training step `step` of a run seeded `seed`: a pure
    function of the two, so a resumed run draws what an uninterrupted run
    draws."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


def draw_uniforms(gen: torch.Generator, batch: int, num_anchors: int,
                  pool: int, device) -> dict[str, torch.Tensor]:
    """The target sampling's uniform scores for one step: per image, for
    the anchors (`rpn_p`, `rpn_n`: (B, A)) and for the proposal pool
    (`roi_p`, `roi_n`: (B, P), P = max_proposals + G)."""
    def u(n):
        return torch.rand((batch, n), generator=gen, device=device)
    return {"rpn_p": u(num_anchors), "rpn_n": u(num_anchors),
            "roi_p": u(pool), "roi_n": u(pool)}


def compute_losses(params, batch: dict[str, torch.Tensor],
                   anchors: torch.Tensor, config: MaskRCNNConfig,
                   draws: dict[str, torch.Tensor], group=None):
    """Forward and the five losses for one batch, on the batch's device.

    batch: images (B, S, S, 3) RGB [0, 255]; gt_boxes (B, G, 4) normalized;
    gt_class_ids (B, G) int (0 = pad, < 0 crowd); gt_masks (B, G, M, M)
    mini-masks. `draws` from `draw_uniforms`. Returns (total loss,
    metrics dict of 0-d tensors). With a process `group` the batch is
    this rank's shard of the global batch, batch statistics are the global
    batch's and each loss is this rank's share of the global batch's
    (`train/losses.py`): the ranks' losses add up to it."""
    dtype = compute_dtype(config)
    images = batch["images"]
    gt_boxes = batch["gt_boxes"].to(torch.float32)
    gt_class_ids = batch["gt_class_ids"].to(torch.int64)
    gt_masks = batch["gt_masks"]
    b = images.shape[0]
    image_hw = (config.image_height, config.image_width)

    bn_ctx = ({"use_batch_stats": True, "group": group}
              if config.train_bn == "batch" else None)
    x = preprocess(images, config)

    def backbone(xx):
        return backbone_fpn(params, xx, config, dtype, bn_ctx=bn_ctx,
                            inference=False)

    pyramid = (checkpoint(backbone, x, use_reentrant=False)
               if config.train_remat_backbone else backbone(x))
    rpn_logits, rpn_deltas = rpn_mod.apply_rpn(params, pyramid, dtype=dtype)

    # --- RPN targets and losses, per image ------------------------------
    rpn_cls, rpn_box = [], []
    for i in range(b):
        t = rpn_targets(anchors, gt_boxes[i], gt_class_ids[i],
                        draws["rpn_p"][i], draws["rpn_n"][i],
                        train_anchors=config.rpn_train_anchors_per_image,
                        bbox_std_dev=config.bbox_std_dev)
        rpn_cls.append(L.rpn_class_loss(rpn_logits[i], t.labels))
        rpn_box.append(L.rpn_bbox_loss(rpn_deltas[i], t.pos_deltas,
                                       t.pos_idx, t.pos_valid))
    loss_rpn_cls = L.mean_over_images(torch.stack(rpn_cls), group)
    loss_rpn_box = L.mean_over_images(torch.stack(rpn_box), group)

    # --- proposals: no gradient through decode and NMS (Matterport) ------
    with torch.no_grad():
        fg = torch.softmax(rpn_logits, dim=-1)[..., 1]
        rois, roi_valid = generate_proposals(
            fg, rpn_deltas.detach(), anchors,
            bbox_std_dev=config.bbox_std_dev,
            pre_nms_max_proposals=config.pre_nms_max_proposals,
            max_proposals=config.max_proposals,
            nms_threshold=config.proposal_nms_threshold)
    # The GT boxes join the proposal pool, so the heads see positives
    # before the RPN proposes any.
    rois = torch.cat([rois, gt_boxes], dim=1)
    roi_valid = torch.cat([roi_valid, gt_class_ids > 0], dim=1)

    # --- sampled proposals and their targets, per image ------------------
    tgts = [proposal_targets(
        rois[i], roi_valid[i], gt_boxes[i], gt_class_ids[i], gt_masks[i],
        draws["roi_p"][i], draws["roi_n"][i],
        num_rois=config.train_rois_per_image,
        positive_fraction=config.roi_positive_ratio,
        mask_size=config.mask_size, bbox_std_dev=config.bbox_std_dev)
        for i in range(b)]
    t = config.train_rois_per_image
    s_rois = torch.stack([g.rois for g in tgts])                # (B, T, 4)
    flat_class = torch.cat([g.class_ids for g in tgts])         # (B*T,)
    flat_valid = torch.cat([g.roi_valid for g in tgts])
    flat_deltas = torch.cat([g.deltas for g in tgts])
    flat_masks = torch.cat([g.masks for g in tgts])

    levels = list(pyramid[:4])
    align = dict(image_shape=image_hw,
                 canonical_scale=config.roi_canonical_scale)
    pooled = pyramid_roi_align(levels, s_rois, config.pool_size, **align)
    _, pred_deltas, cls_logits = heads_mod.apply_classifier_head(
        params, pooled.reshape((b * t,) + pooled.shape[2:]),
        config.num_classes, dtype=dtype, with_logits=True, bn_ctx=bn_ctx)
    loss_cls = L.mrcnn_class_loss(cls_logits, flat_class, flat_valid,
                                  group)
    loss_box = L.mrcnn_bbox_loss(pred_deltas, flat_deltas, flat_class,
                                 group)

    # --- mask head on the same sampled rois ------------------------------
    mask_pooled = pyramid_roi_align(levels, s_rois, config.mask_pool_size,
                                    **align)
    pred_masks = heads_mod.apply_mask_head(
        params, mask_pooled.reshape((b * t,) + mask_pooled.shape[2:]),
        dtype=dtype, bn_ctx=bn_ctx)                  # (B*T, m, m, C)
    loss_mask = L.mrcnn_mask_loss(pred_masks, flat_masks, flat_class,
                                  group)

    total = loss_rpn_cls + loss_rpn_box + loss_cls + loss_box + loss_mask
    metrics = {"loss": total, "rpn_class_loss": loss_rpn_cls,
               "rpn_bbox_loss": loss_rpn_box, "mrcnn_class_loss": loss_cls,
               "mrcnn_bbox_loss": loss_box, "mrcnn_mask_loss": loss_mask}
    return total, metrics


class TrainState(NamedTuple):
    params: Any       # {layer: {weight: float32 tensor}}
    momentum: Any     # the same structure, in the optimizer's trace dtype
    step: int


class Optimizer:
    """SGD with momentum, decoupled weight decay on the kernels of the
    trainable layers, global-norm clipping and a layer-name trainability
    mask (`make_optimizer`)."""

    def __init__(self, config: MaskRCNNConfig, trainable: str = "all"):
        self.pattern = re.compile(FREEZE_PRESETS.get(trainable, trainable))
        self.freeze_bn = config.train_bn == "frozen"
        self.freeze_nothing = trainable == "all" and not self.freeze_bn
        self.learning_rate = config.learning_rate
        self.weight_decay = config.weight_decay
        self.trace_dtype = (torch.bfloat16
                            if config.train_momentum_dtype == "bfloat16"
                            else torch.float32)

    def trainable_mask(self, params):
        """{layer: {weight: bool}}, or None where everything trains. With
        frozen BN every BatchNorm layer is frozen whole, whatever the
        pattern: the frozen-statistics forward gives the moving statistics
        nonzero gradients, which descent must never apply."""
        if self.freeze_nothing:
            return None
        return {layer: {w: bool(self.pattern.fullmatch(layer))
                        and not (self.freeze_bn and set(ws) <= _BN_WEIGHTS)
                        for w in ws}
                for layer, ws in params.items()}

    def decay_mask(self, params):
        return {layer: {w: w == "kernel"
                        and bool(self.pattern.fullmatch(layer)) for w in ws}
                for layer, ws in params.items()}

    def init(self, params):
        return {layer: {w: torch.zeros_like(v, dtype=self.trace_dtype)
                        for w, v in ws.items()}
                for layer, ws in params.items()}


def make_optimizer(config: MaskRCNNConfig,
                   trainable: str = "all") -> Optimizer:
    """`trainable`: a `FREEZE_PRESETS` name or a layer-name regex."""
    return Optimizer(config, trainable)


def make_train_state(params, config: MaskRCNNConfig,
                     trainable: str = "all") -> tuple[TrainState, Optimizer]:
    opt = make_optimizer(config, trainable)
    return TrainState(params, opt.init(params), 0), opt


def apply_gradients(state: TrainState, grads, opt: Optimizer) -> TrainState:
    """The optax chain of the JAX package on `grads` ({layer: {weight:
    tensor or None}}, None = zero), in its order and float32 arithmetic:
    mask; clip by the global norm (g if norm < 5, else (g / norm) * 5);
    g += decay * p on the decayed kernels; t = g + 0.9 * t (the product in
    the trace's dtype, as `optax.trace` computes it); p += t * -lr; the
    trace stored in its dtype. Returns a new state."""
    params = state.params
    mask = opt.trainable_mask(params)
    decay = opt.decay_mask(params)
    names = [(layer, w) for layer, ws in params.items() for w in ws]
    ps = [params[lw[0]][lw[1]] for lw in names]
    ts = [state.momentum[lw[0]][lw[1]] for lw in names]
    gs = []
    for (layer, w), p in zip(names, ps):
        g = grads.get(layer, {}).get(w)
        if g is None or (mask is not None and not mask[layer][w]):
            g = torch.zeros_like(p)
        gs.append(g.to(torch.float32))

    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
    # (g / 1) * 1 == g exactly: one expression for both sides of the clip
    keep = norm < _CLIP_NORM
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm),
                      torch.full_like(norm, _CLIP_NORM))
    gs = list(torch._foreach_mul(torch._foreach_div(gs, div), mul))

    dec = [i for i, (layer, w) in enumerate(names) if decay[layer][w]]
    if dec:
        added = torch._foreach_add(
            [gs[i] for i in dec],
            torch._foreach_mul([ps[i] for i in dec], opt.weight_decay))
        for i, g in zip(dec, added):
            gs[i] = g

    # optax.trace: g + decay * t, with the decay a weakly typed scalar that
    # takes the trace's dtype (0.9 rounds to 0.8984375 in bf16)
    beta = float(torch.tensor(_MOMENTUM, dtype=opt.trace_dtype))
    scaled = torch._foreach_mul(ts, beta)
    new_t = [g + t for g, t in zip(gs, scaled)]                # float32
    new_p = torch._foreach_add(
        ps, torch._foreach_mul(new_t, -opt.learning_rate))

    out_p: dict = {}
    out_t: dict = {}
    for (layer, w), p, t in zip(names, new_p, new_t):
        out_p.setdefault(layer, {})[w] = p
        out_t.setdefault(layer, {})[w] = t.to(opt.trace_dtype)
    return TrainState(out_p, out_t, state.step + 1)


def compute_gradients(state: TrainState, batch, anchors,
                      config: MaskRCNNConfig, opt: Optimizer, *,
                      seed: int = 0, draws=None, group=None):
    """The loss gradients of one step on the device of `state.params`:
    (grads {layer: {weight: tensor or None}}, metrics dict of 0-d
    tensors). Only the leaves `opt` trains require grad (the others'
    gradients would be masked to zero). The sampling scores come from
    `step_generator(seed, state.step)` unless `draws` are given. `group`:
    as in `compute_losses`."""
    first = next(iter(next(iter(state.params.values())).values()))
    dev = first.device
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    anchors = torch.as_tensor(anchors).to(dev, torch.float32)
    if draws is None:
        b, g = batch["gt_boxes"].shape[:2]
        draws = draw_uniforms(step_generator(seed, state.step, dev), b,
                              anchors.shape[0], config.max_proposals + g, dev)
    mask = opt.trainable_mask(state.params)
    params = {layer: {w: v.detach().requires_grad_(
        mask is None or mask[layer][w]) for w, v in ws.items()}
        for layer, ws in state.params.items()}
    total, metrics = compute_losses(params, batch, anchors, config, draws,
                                    group)
    names = [(layer, w) for layer, ws in params.items()
             for w, v in ws.items() if v.requires_grad]
    got = torch.autograd.grad(total, [params[lw[0]][lw[1]] for lw in names],
                              allow_unused=True)
    grads: dict = {}
    for (layer, w), g in zip(names, got):
        grads.setdefault(layer, {})[w] = g
    return grads, {k: v.detach() for k, v in metrics.items()}


def train_step(state: TrainState, batch, anchors, config: MaskRCNNConfig,
               opt: Optimizer, *, seed: int = 0, draws=None):
    """One SGD step: `compute_gradients`, then `apply_gradients`. Returns
    (new state, metrics dict of 0-d tensors on the device)."""
    grads, metrics = compute_gradients(state, batch, anchors, config, opt,
                                       seed=seed, draws=draws)
    return apply_gradients(state, grads, opt), metrics
