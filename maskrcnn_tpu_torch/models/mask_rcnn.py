"""The Mask-RCNN inference forward, port of `maskrcnn_tpu/models/mask_rcnn.py`.

preprocess -> ResNet (stem K3, chains K4), MobileNetV2 or Swin
(`models/swin.py`) -> FPN P2..P6, or ViTDet-B and its simple feature
pyramid (`models/vit.py`) -> P2..P6 ->
RPN -> proposals (NMS K1) -> pool-7 ROIAlign (K2) -> classifier head ->
detection refine (NMS K1) -> pool-14 ROIAlign (K2) -> mask head with
per-class select [-> on-device mask paste].

With `config.fuse_classifier_head` the pool-7 ROIAlign and the classifier
head run as one kernel (K5), and with `config.fuse_mask_head` (pool 14)
the pool-14 ROIAlign and the mask head (K6): on the card in bfloat16
(a float32 config raises there), on the CPU as their plain versions. Unlike
the JAX package, which fuses only on a TPU, the port takes the fused route
wherever the flags are set.

Output contract of the JAX `_forward`: `detections` (B, D, 6) rows
(y1, x1, y2, x2, class_id, score) normalized and zero-padded, `masks`
(B, D, 28, 28) float32, `valid` (B, D), `rois` / `roi_valid`
(B, max_proposals, ...), with `paste_size` also `pasted` (B, D, S, S)
uint8, and with `with_features` also `rpn_logits`, `rpn_deltas`,
`pyramid`.

Parameters are one flat dict {layer: {weight: tensor}} keyed by Matterport
layer names, kernels HWIO; `io/weights.py::params_from_numpy` builds it
from the JAX package's parameters or a checkpoint.
"""

from __future__ import annotations

from typing import Any

import torch

from maskrcnn_tpu_torch.core.anchors import anchor_spec, generate_anchors
from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
from maskrcnn_tpu_torch.models import (fpn, heads, mobilenet, resnet, rpn,
                                      swin, vit)
from maskrcnn_tpu_torch.ops.common import constant_cache, device_constant
from maskrcnn_tpu_torch.ops.detection import refine_detections
from maskrcnn_tpu_torch.ops.proposals import generate_proposals
from maskrcnn_tpu_torch.ops.roi_align import pyramid_roi_align
from maskrcnn_tpu_torch.ops.roi_align_cuda import (pack_classifier_head,
                                                   pack_mask_head,
                                                   unpack_classifier_head)
from maskrcnn_tpu_torch.pipeline.paste import paste_masks
from maskrcnn_tpu_torch.utils.profiling import stage

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """`device` or the card; raises where no card is present and none was
    asked for (the port does not carry on on the CPU by itself)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return torch.device("cuda")


def compute_dtype(config: MaskRCNNConfig) -> torch.dtype:
    if config.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {config.compute_dtype!r}")
    return _DTYPES[config.compute_dtype]


def init_mask_rcnn(gen: torch.Generator,
                   config: MaskRCNNConfig) -> dict[str, Any]:
    """Random-init the flat Matterport-named parameter dict (CPU tensors);
    MobileNetV2 takes the JAX package's `mbv2_*` names, ViTDet `vit_*` and
    `sfp_*` (`models/vit.py`), Swin `swin_*` (`models/swin.py`)."""
    params: dict[str, Any] = {}
    if config.architecture in vit.VIT:
        params.update(vit.init_vit(gen, config.architecture,
                                   (config.image_height, config.image_width),
                                   config.fpn_channels))
    elif config.architecture in swin.SWIN:
        params.update(swin.init_swin(gen, config.architecture))
        params.update(fpn.init_fpn(
            gen, config.fpn_channels,
            c_channels=swin.SWIN[config.architecture].widths))
    elif config.architecture == "mobilenetv2":
        params.update(mobilenet.init_mobilenetv2(gen))
        params.update(fpn.init_fpn(gen, config.fpn_channels,
                                   c_channels=mobilenet.C_CHANNELS))
    else:
        params.update(resnet.init_resnet(gen, config.architecture))
        params.update(fpn.init_fpn(gen, config.fpn_channels))
    params.update(rpn.init_rpn(gen, config.fpn_channels,
                               config.anchors_per_location))
    params.update(heads.init_classifier_head(
        gen, config.num_classes, config.fpn_channels, config.pool_size,
        config.head_fc_dim))
    params.update(heads.init_mask_head(gen, config.num_classes,
                                       config.fpn_channels))
    return params


def params_to(params: dict[str, Any], device) -> dict[str, Any]:
    """The params with every tensor on `device` (the same dict if they are
    there already; a device without an index matches any of its kind)."""
    device = torch.device(device)
    first = next(iter(next(iter(params.values())).values())).device
    if first.type == device.type and device.index in (None, first.index):
        return params
    return {layer: {w: v.to(device) for w, v in weights.items()}
            for layer, weights in params.items()}


def preprocess(images: torch.Tensor, config: MaskRCNNConfig) -> torch.Tensor:
    """RGB [0, 255] -> mean-subtracted float32."""
    mean = device_constant(tuple(config.mean_pixel), torch.float32,
                           images.device)
    return images.to(torch.float32) - mean


@constant_cache
def anchor_table(config: MaskRCNNConfig, device) -> torch.Tensor:
    """`generate_anchors(config)` on `device`, built once per config and
    device (the forward reads it where `analytic_anchors` is off)."""
    return torch.from_numpy(generate_anchors(config)).to(device)


def backbone_fpn(params, images: torch.Tensor, config: MaskRCNNConfig,
                 dtype: torch.dtype, bn_ctx=None, inference: bool = True):
    """Preprocessed images -> P2..P6. `inference=False` (training and BN
    calibration) keeps the graph for autograd: batch-BN (`bn_ctx`) runs
    the layers; frozen BN takes K3/K4 through their autograd Functions
    when `config.train_fused_kernels` is set (`models/resnet.py`).
    MobileNetV2 has no kernel of its own (K3 and K4 are ResNet's) and
    ignores `train_fused_kernels`, as the JAX package does. ViTDet and
    Swin have no BatchNorm, and ViTDet makes its own pyramid; the port
    trains neither (no drop-path), so `inference=False` raises for them."""
    transformer = config.architecture in vit.VIT or \
        config.architecture in swin.SWIN
    if transformer and not inference:
        raise ValueError(
            f"architecture {config.architecture!r} runs inference only: "
            "the port has no training path for it (no drop-path)")
    if config.architecture in vit.VIT:
        return vit.apply_vit(params, images, config.architecture,
                             dtype=dtype)
    if config.architecture in swin.SWIN:
        c2, c3, c4, c5 = swin.apply_swin(params, images, config.architecture,
                                         dtype=dtype)
    elif config.architecture == "mobilenetv2":
        c2, c3, c4, c5 = mobilenet.apply_mobilenetv2(
            params, images, dtype=dtype, bn_ctx=bn_ctx)
    else:
        c2, c3, c4, c5 = resnet.apply_resnet(
            params, images, config.architecture, dtype=dtype, bn_ctx=bn_ctx,
            inference=inference,
            train_fused_kernels=config.train_fused_kernels)
    return fpn.apply_fpn(params, c2, c3, c4, c5, dtype=dtype)


@torch.no_grad()
def forward(params, images, config: MaskRCNNConfig,
            with_features: bool = False, device=None,
            paste_size: int | None = None) -> dict[str, torch.Tensor]:
    """(B, H, W, 3) RGB [0, 255] letterboxed images (tensor or array, any
    real dtype) -> detections + masks, computed on `device` (default: the
    card; raises where there is none). `paste_size` also pastes
    full-resolution uint8 masks on the device (`out["pasted"]`)."""
    with stage("forward"):
        return _forward(params, images, config, with_features, device,
                        paste_size)


def _forward(params, images, config, with_features, device, paste_size):
    dev = resolve_device(device)
    dtype = compute_dtype(config)
    fuse_cls = config.fuse_classifier_head
    fuse_mask = config.fuse_mask_head and config.mask_pool_size == 14
    if (fuse_cls or fuse_mask) and dev.type == "cuda" \
            and dtype != torch.bfloat16:
        raise ValueError(
            "the fused ROI heads (fuse_classifier_head / fuse_mask_head) "
            "run in bfloat16 on the card; got compute_dtype="
            f"{config.compute_dtype!r}")
    images = torch.as_tensor(images).to(dev)
    params = params_to(params, dev)
    b = images.shape[0]
    image_hw = (config.image_height, config.image_width)

    with stage("preprocess"):
        x = preprocess(images, config)
    with stage("backbone_fpn"):
        pyramid = backbone_fpn(params, x, config, dtype)
    with stage("rpn"):
        rpn_logits, rpn_deltas = rpn.apply_rpn(params, pyramid, dtype=dtype)
    fg_scores = rpn_logits[..., 1] - rpn_logits[..., 0]            # (B, A)

    with stage("proposals"):
        # The anchor table is only read when anchors are not computed from
        # the top-k indices (`analytic_anchors=False`).
        anchors = (None if config.analytic_anchors else
                   anchor_table(config, dev))
        rois, roi_valid = generate_proposals(
            fg_scores, rpn_deltas, anchors,
            bbox_std_dev=config.bbox_std_dev,
            pre_nms_max_proposals=config.pre_nms_max_proposals,
            max_proposals=config.max_proposals,
            nms_threshold=config.proposal_nms_threshold,
            anchor_spec=(anchor_spec(config) if config.analytic_anchors
                         else None))

    r = config.max_proposals
    levels = list(pyramid[:4])
    align = dict(image_shape=image_hw,
                 canonical_scale=config.roi_canonical_scale)
    if fuse_cls:
        with stage("roi_align_classifier"):
            head_out = pyramid_roi_align(
                levels, rois, config.pool_size, **align,
                head_params=pack_classifier_head(params, config.num_classes,
                                                 dtype))
            probs, deltas, _ = unpack_classifier_head(head_out,
                                                      config.num_classes)
    else:
        with stage("roi_align_classifier"):
            pooled = pyramid_roi_align(levels, rois, config.pool_size,
                                       **align)
        with stage("classifier_head"):
            probs, deltas = heads.apply_classifier_head(
                params, pooled.reshape((b * r,) + pooled.shape[2:]),
                config.num_classes, dtype=dtype)
    probs = probs.reshape(b, r, -1)
    deltas = deltas.reshape(b, r, config.num_classes, 4)

    with stage("detection"):
        detections, det_valid, _ = refine_detections(
            rois, probs, deltas, bbox_std_dev=config.bbox_std_dev,
            score_threshold=config.detection_score_threshold,
            nms_threshold=config.detection_nms_threshold,
            max_detections=config.max_detections)

    d = config.max_detections
    det_boxes = detections[..., :4]
    class_ids = detections[..., 4].to(torch.int64)
    if fuse_mask:
        with stage("roi_align_mask_fused"):
            masks = pyramid_roi_align(
                levels, det_boxes, config.mask_pool_size, **align,
                mask_params=pack_mask_head(params, dtype),
                class_ids=class_ids)
    else:
        with stage("roi_align_mask"):
            mask_pooled = pyramid_roi_align(levels, det_boxes,
                                            config.mask_pool_size, **align)
        with stage("mask_head"):
            masks = heads.apply_mask_head(
                params, mask_pooled.reshape((b * d,) + mask_pooled.shape[2:]),
                dtype=dtype, class_ids=class_ids.reshape(b * d))
    masks = masks.reshape(b, d, config.mask_size, config.mask_size)
    masks = masks * det_valid[:, :, None, None].to(masks.dtype)

    out = {"detections": detections, "masks": masks, "valid": det_valid,
           "rois": rois, "roi_valid": roi_valid}
    if paste_size is not None:
        with stage("paste"):
            out["pasted"] = paste_masks(masks, det_boxes, det_valid,
                                        paste_size)
    if with_features:
        out.update(rpn_logits=rpn_logits, rpn_deltas=rpn_deltas,
                   pyramid=pyramid)
    return out


def to_numpy(out: dict[str, Any]) -> dict[str, Any]:
    """Host copies of a forward's outputs (float32 for float tensors)."""
    def conv(v):
        if isinstance(v, (tuple, list)):
            return [conv(t) for t in v]
        if v.is_floating_point():
            v = v.to(torch.float32)
        return v.cpu().numpy()
    return {k: conv(v) for k, v in out.items()}

