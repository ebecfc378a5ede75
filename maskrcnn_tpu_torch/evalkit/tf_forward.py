"""Full-model TensorFlow oracle, port of `maskrcnn_tpu/evalkit/tf_forward.py`:
the same weights, independently executed.

The reference's de-facto correctness oracle is its `--compare` mode: run the
SAME weights through the original TF/Keras implementation and print both AP
tables side by side (`Sources/maskrcnn/EvaluateCommand.swift:124-127`,
`Sources/maskrcnn/Python/COCOEval/task.py:99-105`). This module is a
from-scratch TensorFlow implementation of the identical inference graph
(Matterport topology, SURVEY.md §7 step 4), consuming the flat
Matterport-named numpy dict (HWIO kernels) that the port's params become
through `io/weights.py::params_to_numpy`. It is the JAX package's module
line for line; only the two backbone tables come from the port's models.

Everything runs in float32 with exact top-k, in TF eager on the host CPU:
an oracle, not a path on the card (`cli evaluate --compare-tf` runs it
beside the detector). TensorFlow is imported inside `tf_forward`, so the
module imports where TF is absent (the card's machine).

Deliberate parity choices (mirroring the JAX path, documented there):
  * proposal ranking by RPN logit margin (monotonic in softmax fg prob);
  * detection NMS iterates in descending score order per class
    (tf.image.non_max_suppression semantics — the documented divergence
    from the Swift Set-order, PARITY.md);
  * ROIAlign is tf.image.crop_and_resize on the assigned pyramid level
    (`PyramidROIAlignLayer.swift:373-377` level formula, round half away
    from zero, clamp [2,5]).
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _tf():
    import tensorflow as tf

    return tf


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _conv(tf, x, p, stride=1, padding="SAME"):
    y = tf.nn.conv2d(x, p["kernel"].astype(np.float32),
                     strides=[1, stride, stride, 1], padding=padding)
    return y + p["bias"].astype(np.float32)


def _bn(tf, x, p, eps=1e-3):
    scale = p["gamma"] / np.sqrt(p["moving_variance"] + eps)
    return x * scale.astype(np.float32) + (
        p["beta"] - p["moving_mean"] * scale).astype(np.float32)


def _bottleneck(tf, x, params, stage, block, is_conv, stride):
    base = f"res{stage}{block}_branch"
    bnb = f"bn{stage}{block}_branch"
    y = _conv(tf, x, params[base + "2a"], stride=stride, padding="VALID")
    y = tf.nn.relu(_bn(tf, y, params[bnb + "2a"]))
    y = _conv(tf, y, params[base + "2b"], padding="SAME")
    y = tf.nn.relu(_bn(tf, y, params[bnb + "2b"]))
    y = _conv(tf, y, params[base + "2c"], padding="VALID")
    y = _bn(tf, y, params[bnb + "2c"])
    if is_conv:
        sc = _conv(tf, x, params[base + "1"], stride=stride, padding="VALID")
        sc = _bn(tf, sc, params[bnb + "1"])
    else:
        sc = x
    return tf.nn.relu(y + sc)


def _resnet_taps(tf, params, x, architecture):
    from maskrcnn_tpu_torch.models.resnet import _stage_blocks

    x = tf.pad(x, [[0, 0], [3, 3], [3, 3], [0, 0]])
    x = _conv(tf, x, params["conv1"], stride=2, padding="VALID")
    x = tf.nn.relu(_bn(tf, x, params["bn_conv1"]))
    x = tf.nn.max_pool2d(x, 3, 2, padding="SAME")

    feats = {}
    for stage, block, is_conv, _, stride in _stage_blocks(architecture):
        x = _bottleneck(tf, x, params, stage, block, is_conv, stride)
        feats[stage] = x
    return feats[2], feats[3], feats[4], feats[5]


def _mbv2_taps(tf, params, x):
    """MobileNetV2 C2..C5, mirroring models/mobilenet.py (the backbone
    the repo ships beyond the reference)."""
    from maskrcnn_tpu_torch.models.mobilenet import _GROUPS, _TAPS

    def relu6(t):
        return tf.clip_by_value(t, 0.0, 6.0)

    def dwconv(t, p, stride):
        # stored (k, k, 1, C) for lax feature_group_count; depthwise_conv2d
        # wants (k, k, C, channel_multiplier=1)
        k = np.transpose(p["kernel"], (0, 1, 3, 2)).astype(np.float32)
        y = tf.nn.depthwise_conv2d(t, k, strides=[1, stride, stride, 1],
                                   padding="SAME")
        return y + p["bias"].astype(np.float32)

    x = _conv(tf, x, params["mbv2_stem"], stride=2, padding="SAME")
    x = relu6(_bn(tf, x, params["mbv2_stem_bn"]))

    taps = {}
    for gi, (t, c, n, s) in enumerate(_GROUPS):
        for bi in range(n):
            stride = s if bi == 0 else 1
            base = f"mbv2_g{gi}b{bi}"
            cin = int(x.shape[-1])
            y = x
            if t != 1:
                y = _conv(tf, y, params[base + "_expand"], padding="VALID")
                y = relu6(_bn(tf, y, params[base + "_expand_bn"]))
            y = dwconv(y, params[base + "_dw"], stride)
            y = relu6(_bn(tf, y, params[base + "_dw_bn"]))
            y = _conv(tf, y, params[base + "_project"], padding="VALID")
            y = _bn(tf, y, params[base + "_project_bn"])
            x = y + x if (stride == 1 and cin == c) else y
        if gi in _TAPS:
            taps[_TAPS[gi]] = x
    return taps["c2"], taps["c3"], taps["c4"], taps["c5"]


def _backbone_fpn(tf, params, x, architecture):
    if architecture == "mobilenetv2":
        c2, c3, c4, c5 = _mbv2_taps(tf, params, x)
    else:
        c2, c3, c4, c5 = _resnet_taps(tf, params, x, architecture)

    def up2(t):
        h, w = t.shape[1], t.shape[2]
        return tf.repeat(tf.repeat(t, 2, axis=1), 2, axis=2) \
            if h is not None else t

    p5 = _conv(tf, c5, params["fpn_c5p5"], padding="VALID")
    p4 = up2(p5) + _conv(tf, c4, params["fpn_c4p4"], padding="VALID")
    p3 = up2(p4) + _conv(tf, c3, params["fpn_c3p3"], padding="VALID")
    p2 = up2(p3) + _conv(tf, c2, params["fpn_c2p2"], padding="VALID")
    p2 = _conv(tf, p2, params["fpn_p2"], padding="SAME")
    p3 = _conv(tf, p3, params["fpn_p3"], padding="SAME")
    p4 = _conv(tf, p4, params["fpn_p4"], padding="SAME")
    p5 = _conv(tf, p5, params["fpn_p5"], padding="SAME")
    p6 = p5[:, ::2, ::2, :]
    return [p2, p3, p4, p5, p6]


def _rpn(tf, params, pyramid):
    logits, deltas = [], []
    for f in pyramid:
        shared = tf.nn.relu(_conv(tf, f, params["rpn_conv_shared"],
                                  padding="SAME"))
        lg = _conv(tf, shared, params["rpn_class_raw"], padding="VALID")
        dl = _conv(tf, shared, params["rpn_bbox_pred"], padding="VALID")
        b = tf.shape(lg)[0]
        logits.append(tf.reshape(lg, (b, -1, 2)))
        deltas.append(tf.reshape(dl, (b, -1, 4)))
    return (tf.concat(logits, axis=1), tf.concat(deltas, axis=1))


def _apply_deltas(tf, boxes, deltas):
    y1, x1, y2, x2 = tf.unstack(boxes, axis=-1)
    dy, dx, dh, dw = tf.unstack(deltas, axis=-1)
    h = y2 - y1
    w = x2 - x1
    cy = y1 + 0.5 * h + dy * h
    cx = x1 + 0.5 * w + dx * w
    h = h * tf.exp(dh)
    w = w * tf.exp(dw)
    ny1 = cy - 0.5 * h
    nx1 = cx - 0.5 * w
    return tf.stack([ny1, nx1, ny1 + h, nx1 + w], axis=-1)


def _roi_levels(boxes, image_shape, canonical_scale=224.0):
    """Numpy level assignment, reference formula incl. round-half-away."""
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    area = np.maximum(h * w, 1e-30)
    ratio = canonical_scale / np.sqrt(float(image_shape[0] * image_shape[1]))
    lvl = 0.5 * np.log2(area) - np.log2(ratio) + 4.0
    lvl = np.clip(np.floor(lvl + 0.5), 2, 5).astype(np.int32)
    return lvl, (h * w) > 0


def _pyramid_roi_align(tf, pyramid, boxes, crop, image_shape,
                       canonical_scale):
    """(N, 4) normalized boxes -> (N, crop, crop, C) via crop_and_resize on
    each box's assigned level (the reference's TF-comparison semantics)."""
    levels, valid = _roi_levels(np.asarray(boxes), image_shape,
                                canonical_scale)
    n = boxes.shape[0]
    c = pyramid[0].shape[-1]
    out = np.zeros((n, crop, crop, c), np.float32)
    for lvl in (2, 3, 4, 5):
        sel = np.flatnonzero((levels == lvl) & valid)
        if sel.size == 0:
            continue
        crops = tf.image.crop_and_resize(
            pyramid[lvl - 2],
            tf.gather(boxes, sel),
            tf.zeros((sel.size,), tf.int32),
            (crop, crop))
        out[sel] = crops.numpy()
    return out


def _classifier_head(tf, params, pooled, num_classes):
    n = pooled.shape[0]
    k1 = params["mrcnn_class_conv1"]
    flat_k = k1["kernel"].reshape(-1, k1["kernel"].shape[-1])
    x = tf.matmul(tf.reshape(pooled, (n, -1)),
                  flat_k.astype(np.float32)) + k1["bias"].astype(np.float32)
    x = tf.nn.relu(_bn(tf, x, params["mrcnn_class_bn1"]))
    k2 = params["mrcnn_class_conv2"]
    x = tf.matmul(x, k2["kernel"].reshape(
        k2["kernel"].shape[-2], -1).astype(np.float32)) \
        + k2["bias"].astype(np.float32)
    x = tf.nn.relu(_bn(tf, x, params["mrcnn_class_bn2"]))
    logits = tf.matmul(x, params["mrcnn_class_logits"]["kernel"].astype(
        np.float32)) + params["mrcnn_class_logits"]["bias"].astype(np.float32)
    probs = tf.nn.softmax(logits, axis=-1)
    deltas = tf.matmul(x, params["mrcnn_bbox_fc"]["kernel"].astype(
        np.float32)) + params["mrcnn_bbox_fc"]["bias"].astype(np.float32)
    return probs, tf.reshape(deltas, (n, num_classes, 4))


def _mask_head(tf, params, pooled, class_ids):
    x = tf.constant(pooled, tf.float32)
    for i in range(1, 5):
        x = _conv(tf, x, params[f"mrcnn_mask_conv{i}"], padding="SAME")
        x = tf.nn.relu(_bn(tf, x, params[f"mrcnn_mask_bn{i}"]))
    k = params["mrcnn_mask_deconv"]
    n, ph = x.shape[0], x.shape[1]
    # Keras Conv2DTranspose stores kernels HWIO (h, w, in, OUT) in h5; our
    # loader keeps that layout. tf.nn.conv2d_transpose expects (h, w, OUT, in).
    kt = np.transpose(k["kernel"], (0, 1, 3, 2)).astype(np.float32)
    x = tf.nn.conv2d_transpose(
        x, kt, output_shape=(n, 2 * ph, 2 * ph, kt.shape[2]),
        strides=[1, 2, 2, 1], padding="VALID") \
        + k["bias"].astype(np.float32)
    x = tf.nn.relu(x)
    x = _conv(tf, x, params["mrcnn_mask"], padding="VALID")
    probs = tf.sigmoid(x).numpy()  # (N, 2p, 2p, num_classes)
    return probs[np.arange(len(class_ids)), :, :, class_ids]


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def tf_forward(params: dict[str, Any], images: np.ndarray, anchors: np.ndarray,
               config) -> list[dict[str, np.ndarray]]:
    """Run the oracle on a (B, S, S, 3) letterboxed RGB [0,255] batch.

    Returns one dict per image: boxes (D, 4) normalized y1x1y2x2, class_ids
    (D,), scores (D,), masks (D, mask, mask) — D is the true (unpadded)
    detection count.
    """
    tf = _tf()
    if config.architecture not in ("resnet50", "resnet101", "mobilenetv2"):
        raise NotImplementedError(
            f"TF oracle supports resnet50/resnet101/mobilenetv2 backbones, "
            f"not {config.architecture}")
    params = {k: {kk: np.asarray(vv, np.float32) for kk, vv in v.items()}
              for k, v in params.items()}
    images = np.asarray(images, np.float32)
    mean = np.asarray(config.mean_pixel, np.float32)
    image_hw = (config.image_height, config.image_width)

    x = tf.constant(images - mean)
    pyramid = _backbone_fpn(tf, params, x, config.architecture)
    rpn_logits, rpn_deltas = _rpn(tf, params, pyramid)

    results = []
    anchors_tf = tf.constant(np.asarray(anchors, np.float32))
    std = np.asarray(config.bbox_std_dev, np.float32)
    for i in range(images.shape[0]):
        margin = rpn_logits[i, :, 1] - rpn_logits[i, :, 0]
        k = min(int(margin.shape[0]), config.pre_nms_max_proposals)
        _, top_idx = tf.math.top_k(margin, k=k, sorted=True)
        sel_deltas = tf.gather(rpn_deltas[i], top_idx) * std
        sel_anchors = tf.gather(anchors_tf, top_idx)
        boxes = tf.clip_by_value(
            _apply_deltas(tf, sel_anchors, sel_deltas), 0.0, 1.0)
        keep = tf.image.non_max_suppression(
            boxes, tf.gather(margin, top_idx), config.max_proposals,
            iou_threshold=config.proposal_nms_threshold)
        rois = tf.gather(boxes, keep)  # (R', 4)

        level_feats = [p[i:i + 1] for p in pyramid[:4]]
        pooled = _pyramid_roi_align(
            tf, level_feats, rois, config.pool_size, image_hw,
            config.roi_canonical_scale)
        probs, deltas = _classifier_head(tf, params, pooled,
                                         config.num_classes)
        probs = probs.numpy()
        deltas = deltas.numpy()

        class_id = probs.argmax(-1)
        score = probs.max(-1)
        delta = deltas[np.arange(len(class_id)), class_id] * std
        refined = np.clip(
            _apply_deltas(tf, rois, tf.constant(delta)).numpy(), 0.0, 1.0)
        rois_np = rois.numpy()
        roi_area = ((rois_np[:, 2] - rois_np[:, 0])
                    * (rois_np[:, 3] - rois_np[:, 1]))
        cand = ((score >= config.detection_score_threshold)
                & (class_id > 0) & (roi_area > 0))

        # per-class NMS via class-offset boxes (score-order greedy)
        idx = np.flatnonzero(cand)
        if idx.size:
            offset = class_id[idx].astype(np.float32)[:, None] * 4.0
            keep2 = tf.image.non_max_suppression(
                refined[idx] + offset, score[idx], config.max_detections,
                iou_threshold=config.detection_nms_threshold).numpy()
            det = idx[keep2]
        else:
            det = np.zeros((0,), np.int64)

        det_boxes = refined[det]
        det_classes = class_id[det].astype(np.int32)
        det_scores = score[det]
        if det.size:
            mask_pooled = _pyramid_roi_align(
                tf, level_feats, tf.constant(det_boxes),
                config.mask_pool_size, image_hw, config.roi_canonical_scale)
            masks = _mask_head(tf, params, mask_pooled, det_classes)
        else:
            masks = np.zeros((0, config.mask_size, config.mask_size),
                             np.float32)
        results.append({"boxes": det_boxes, "class_ids": det_classes,
                        "scores": det_scores, "masks": masks})
    return results
