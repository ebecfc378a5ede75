"""Post-training BatchNorm statistics calibration, port of
`maskrcnn_tpu/train/calibrate.py`.

Training from scratch normalizes with live batch statistics
(`config.train_bn == "batch"`), so the stored moving statistics keep their
(0, 1) init. Before such a model can run the inference path (stored
statistics), they are re-estimated: K batches go through the training
forward in batch-statistic mode (backbone, proposals, heads on the pooled
proposals, so the head BNs see real inputs too), every BN layer's input
statistics are collected, and the mean of the means and, by the law of
total variance, the variance are written into the parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
from maskrcnn_tpu_torch.models import heads as heads_mod
from maskrcnn_tpu_torch.models import rpn as rpn_mod
from maskrcnn_tpu_torch.models.mask_rcnn import (backbone_fpn, compute_dtype,
                                                 preprocess)
from maskrcnn_tpu_torch.ops.proposals import generate_proposals
from maskrcnn_tpu_torch.ops.roi_align import pyramid_roi_align


@torch.no_grad()
def _collect_stats(params, images: torch.Tensor, anchors: torch.Tensor,
                   config: MaskRCNNConfig) -> dict:
    """One batch -> {bn_layer: (mean, var)} of its batch statistics."""
    dtype = compute_dtype(config)
    image_hw = (config.image_height, config.image_width)
    collect: dict = {}
    bn_ctx = {"use_batch_stats": True, "collect": collect}

    x = preprocess(images, config)
    pyramid = backbone_fpn(params, x, config, dtype, bn_ctx=bn_ctx,
                           inference=False)
    rpn_logits, rpn_deltas = rpn_mod.apply_rpn(params, pyramid, dtype=dtype)
    fg = rpn_logits[..., 1] - rpn_logits[..., 0]
    rois, _ = generate_proposals(
        fg, rpn_deltas, anchors, bbox_std_dev=config.bbox_std_dev,
        pre_nms_max_proposals=config.pre_nms_max_proposals,
        max_proposals=config.max_proposals,
        nms_threshold=config.proposal_nms_threshold)
    levels = list(pyramid[:4])
    align = dict(image_shape=image_hw,
                 canonical_scale=config.roi_canonical_scale)
    pooled = pyramid_roi_align(levels, rois, config.pool_size, **align)
    heads_mod.apply_classifier_head(
        params, pooled.reshape((-1,) + pooled.shape[2:]), config.num_classes,
        dtype=dtype, bn_ctx=bn_ctx)
    mask_pooled = pyramid_roi_align(levels, rois, config.mask_pool_size,
                                    **align)
    heads_mod.apply_mask_head(
        params, mask_pooled.reshape((-1,) + mask_pooled.shape[2:]),
        dtype=dtype, bn_ctx=bn_ctx)
    return collect


def calibrate_bn_stats(params, image_batches, anchors,
                       config: MaskRCNNConfig):
    """Fresh moving statistics from `image_batches` (an iterable of
    (B, S, S, 3) RGB [0, 255] arrays or tensors), computed on the device
    of `params`; returns the updated params (the others shared, not
    copied)."""
    first = next(iter(next(iter(params.values())).values()))
    dev = first.device
    anchors = torch.as_tensor(anchors).to(dev, torch.float32)
    sums: dict[str, np.ndarray] = {}
    sq_sums: dict[str, np.ndarray] = {}
    count = 0
    for images in image_batches:
        stats = _collect_stats(params, torch.as_tensor(images).to(dev),
                               anchors, config)
        for name, (mean, var) in stats.items():
            mean = mean.double().cpu().numpy()
            var = var.double().cpu().numpy()
            sums[name] = sums.get(name, 0.0) + mean
            # E[x^2] = var + mean^2 (law of total variance across batches)
            sq_sums[name] = sq_sums.get(name, 0.0) + var + mean * mean
        count += 1
    if count == 0:
        raise ValueError("no calibration batches provided")

    new_params = dict(params)
    for name in sums:
        mean = sums[name] / count
        var = np.maximum(sq_sums[name] / count - mean * mean, 0.0)
        layer = dict(new_params[name])
        layer["moving_mean"] = torch.tensor(mean, dtype=torch.float32,
                                            device=dev)
        layer["moving_variance"] = torch.tensor(var, dtype=torch.float32,
                                                device=dev)
        new_params[name] = layer
    return new_params
