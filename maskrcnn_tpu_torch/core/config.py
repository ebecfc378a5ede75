"""Model/runtime configuration (the PyTorch port's own copy).

Field for field the same dataclass as `maskrcnn_tpu/core/config.py`, so a
config dict or JSON file means the same model in both packages. The port
reads the same fields; `proposal_topk_recall` names a TPU-only mechanism
and is kept for schema compatibility (the port's top-k is always exact).
The `fuse_*` flags are read: in the port they select the fused ROIAlign
heads wherever they are set, the CUDA kernels K5 (`fuse_classifier_head`)
and K6 (`fuse_mask_head`, pool 14) on the card, bfloat16 only, and their
plain versions on the CPU (`models/mask_rcnn.py::forward`). The `train_*` fields drive the port's
training (`train/step.py`) and are documented for what the port does.

One frozen dataclass replaces the reference's three config tiers (SURVEY.md §5):
the JSON model config (reference `README.md:85-92`, loaded at
`Sources/maskrcnn/Python/Conversion/task.py:166-169`), the custom-layer
parameters baked into .mlmodel protobufs (`Conversion/task.py:25-67`), and the
process-global `MaskRCNNConfig.defaultConfig` singleton
(`Sources/Mask-RCNN-CoreML/MaskRCNNConfig.swift:10-19`). Under XLA there is no
"bake into model" step — the same object feeds graph construction and the
jitted pipeline.

Defaults reproduce the reference's hyperparameters verbatim (SURVEY.md §2
"Model hyperparameters" table): bbox std-dev [0.1,0.1,0.2,0.2]
(`ProposalLayer.swift:57`, `DetectionLayer.swift:55`), pre-NMS 6000 / post-NMS
1000 proposals (`ProposalLayer.swift:59-61`), proposal NMS IoU 0.7
(`ProposalLayer.swift:63`), detection score threshold 0.7 / NMS IoU 0.3 /
max 100 detections (`DetectionLayer.swift:57-61`), pool 7 / mask pool 14
(`PyramidROIAlignLayer.swift:45`), 1024x1024x3 input, 81 COCO classes, RGB
mean (123.7, 116.8, 103.9) (`Conversion/task.py:73-75`).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Mapping, Sequence


_VALID_ARCHITECTURES = ("resnet50", "resnet101", "mobilenetv2")


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    # --- graph topology ---------------------------------------------------
    architecture: str = "resnet101"
    input_image_shape: tuple[int, int, int] = (1024, 1024, 3)
    num_classes: int = 81  # includes background class 0

    # --- anchors (Matterport convention; replaces anchors.bin) ------------
    anchor_scales: tuple[float, ...] = (32.0, 64.0, 128.0, 256.0, 512.0)
    anchor_ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    backbone_strides: tuple[int, ...] = (4, 8, 16, 32, 64)  # P2..P6
    anchor_stride: int = 1

    # --- proposal stage (reference ProposalLayer.swift:57-63) -------------
    pre_nms_max_proposals: int = 6000
    max_proposals: int = 1000
    proposal_nms_threshold: float = 0.7
    bbox_std_dev: tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    # Pre-NMS top-k selection in the JAX package: a recall target for
    # `lax.approx_max_k` on a TPU, or None for exact `lax.top_k`. Off a TPU
    # both are exact. The port's top-k is always the exact, stable one
    # (ops/proposals.py::top_k_indices), whatever this field holds.
    proposal_topk_recall: float | None = 0.95
    # Decode selected anchors analytically from the top-k indices inside the
    # proposal stage (core/anchors.anchors_at) instead of gathering from the
    # (A, 8) delta+anchor table — kills the table build and halves gathered
    # bytes; values match the table to float32 rounding (<=2 ulp).
    analytic_anchors: bool = True

    # --- detection stage (reference DetectionLayer.swift:55-61) -----------
    max_detections: int = 100
    detection_score_threshold: float = 0.7
    detection_nms_threshold: float = 0.3

    # --- ROI heads (reference PyramidROIAlignLayer.swift:45-46) -----------
    pool_size: int = 7
    mask_pool_size: int = 14
    mask_size: int = 28  # mask head output resolution (2 * mask_pool_size)
    fpn_channels: int = 256
    head_fc_dim: int = 1024
    # FPN level-selection constant k0 offset: level = 4 + log2(sqrt(wh)/(224/sqrt(HW)))
    # (reference PyramidROIAlignLayer.swift:373-377, constant at :98)
    roi_canonical_scale: float = 224.0

    # --- preprocessing (reference Conversion/task.py:73-75) ----------------
    mean_pixel: tuple[float, float, float] = (123.7, 116.8, 103.9)

    # --- numerics ----------------------------------------------------------
    compute_dtype: str = "bfloat16"  # convs/matmuls; box math stays float32
    # reference quantizes weights to fp16 (Conversion/task.py:90,102,114).

    # Run the classifier head fused behind the pool-7 ROIAlign (K5 on the
    # card; BN folded into the dense weights, inference BN being affine).
    fuse_classifier_head: bool = False

    # Run the whole mask head (4x conv3x3+BN+relu, 2x2/2 deconv, per-class
    # select, sigmoid) fused behind the pool-14 ROIAlign (K6 on the card).
    fuse_mask_head: bool = False

    # --- training (capability the reference stubs out: TrainCommand.swift) -
    # BN statistics during training: "batch" (live batch statistics, the
    # from-scratch recipe; the moving statistics are re-estimated afterwards
    # by train.calibrate.calibrate_bn_stats) or "frozen" (stored moving
    # statistics, the Matterport fine-tuning recipe for pretrained weights;
    # make_optimizer then freezes every BN layer whole).
    train_bn: str = "batch"
    train_rois_per_image: int = 200
    roi_positive_ratio: float = 0.33
    rpn_train_anchors_per_image: int = 256
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    # Balanced-subsample selection in target assignment. The JAX package
    # uses `lax.approx_max_k` for "approx" (exact off a TPU) and
    # `lax.top_k` for "exact"; the port takes the exact, stable top k
    # (ties to the lower index, ops/proposals.py::top_k_indices) for both
    # values, so its sampling equals the JAX package's off a TPU. Kept and
    # validated for schema compatibility ("exact" is what --exact sets).
    train_sampling_topk: str = "approx"
    # Run the stem (K3) and the res2 a-c / res3 b-d chains (K4) as the CUDA
    # kernels in the training forward too: frozen BN and bf16 on the card
    # only, through autograd Functions whose backward recomputes the layer
    # graph's gradient (ops/stem_cuda.StemFusedDiff,
    # ops/bottleneck_cuda.ChainFusedDiff; there is no backward kernel).
    # Off by default, as in the JAX package; its step time against the
    # layer path is in PERF.md.
    train_fused_kernels: bool = False
    # Recompute the backbone + FPN in the backward
    # (torch.utils.checkpoint): one more backbone forward per step for not
    # keeping its activations, so larger batches fit. With
    # train_fused_kernels the kernels then run twice per step.
    train_remat_backbone: bool = False
    # SGD momentum trace dtype. "bfloat16" stores the trace in half the
    # bytes; the params and the update stay float32 (the trace is rounded
    # once it is used, as optax.trace does).
    train_momentum_dtype: str = "float32"

    def __post_init__(self):
        if self.architecture not in _VALID_ARCHITECTURES:
            raise ValueError(
                f"architecture must be one of {_VALID_ARCHITECTURES}, "
                f"got {self.architecture!r}")
        h, w, c = self.input_image_shape
        for s in self.backbone_strides:
            if h % s or w % s:
                raise ValueError(
                    f"input_image_shape {self.input_image_shape} must be "
                    f"divisible by backbone stride {s}")
        if c != 3:
            raise ValueError("input images must be RGB (C=3)")
        if self.mask_size != 2 * self.mask_pool_size:
            raise ValueError(
                f"mask_size ({self.mask_size}) must be 2 * mask_pool_size "
                f"({self.mask_pool_size}) — the mask head upsamples exactly "
                "2x (TimeDistributedMaskLayer.swift:26-37 contract)")
        if self.train_sampling_topk not in ("approx", "exact"):
            raise ValueError(
                "train_sampling_topk must be 'approx' or 'exact', got "
                f"{self.train_sampling_topk!r}")
        # Two consumers string-compare this (compute_losses -> batch stats,
        # make_optimizer -> whole-BN-layer freeze); a typo would silently
        # produce a half-frozen regime rather than an error.
        if self.train_bn not in ("batch", "frozen"):
            raise ValueError(
                f"train_bn must be 'batch' or 'frozen', got "
                f"{self.train_bn!r}")
        if self.train_momentum_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "train_momentum_dtype must be 'float32' or 'bfloat16', "
                f"got {self.train_momentum_dtype!r}")

    # --- derived ----------------------------------------------------------
    @property
    def image_height(self) -> int:
        return self.input_image_shape[0]

    @property
    def image_width(self) -> int:
        return self.input_image_shape[1]

    @property
    def feature_shapes(self) -> tuple[tuple[int, int], ...]:
        """Spatial shape of each pyramid level P2..P6."""
        h, w, _ = self.input_image_shape
        return tuple(
            (int(math.ceil(h / s)), int(math.ceil(w / s)))
            for s in self.backbone_strides)

    @property
    def anchors_per_location(self) -> int:
        return len(self.anchor_ratios)

    @property
    def num_anchors(self) -> int:
        """Total anchor count over all pyramid levels (261,888 at 1024²)."""
        return sum(
            fh * fw * self.anchors_per_location
            for fh, fw in self.feature_shapes)

    # --- (de)serialization -------------------------------------------------
    # Accepts the reference's config.json schema: {"architecture",
    # "input_image_shape", "num_classes", "pre_nms_max_proposals",
    # "max_proposals"} (reference README.md:85-92) plus any field above; also
    # tolerates the COCOEval-side "input_width"/"input_height" pair
    # (reference Python/COCOEval/task.py usage of config.input_width).
    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MaskRCNNConfig":
        d = dict(d)
        if "input_width" in d or "input_height" in d:
            w = int(d.pop("input_width", 1024))
            h = int(d.pop("input_height", 1024))
            d.setdefault("input_image_shape", (h, w, 3))
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        for k, v in d.items():
            if k not in fields:
                continue  # ignore unknown keys, like the reference's json.update
            if isinstance(v, list):
                v = tuple(v)
            ftype = fields[k].type
            if ftype == "int":
                v = int(v)
            elif ftype == "float":
                v = float(v)
            elif ftype == "str":
                v = str(v)
            kwargs[k] = v
        if "input_image_shape" in kwargs:
            kwargs["input_image_shape"] = tuple(
                int(x) for x in kwargs["input_image_shape"])
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str) -> "MaskRCNNConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def replace(self, **kwargs) -> "MaskRCNNConfig":
        return dataclasses.replace(self, **kwargs)

    def exact_numerics(self) -> "MaskRCNNConfig":
        """The production-vs-exact switch as ONE knob (CLI `--exact`):
        float32 compute, exact proposal top-k, table anchors, no fused
        heads, exact target sampling: the escape hatch for users who want
        reference-exact numerics without config surgery."""
        return self.replace(
            compute_dtype="float32",
            proposal_topk_recall=None,
            analytic_anchors=False,
            fuse_classifier_head=False,
            fuse_mask_head=False,
            train_sampling_topk="exact")


def tiny_test_config() -> MaskRCNNConfig:
    """A miniature config for fast CPU tests (same topology, 128² input)."""
    return MaskRCNNConfig(
        architecture="resnet50",
        input_image_shape=(128, 128, 3),
        num_classes=5,
        anchor_scales=(8.0, 16.0, 32.0, 64.0, 128.0),
        pre_nms_max_proposals=256,
        max_proposals=64,
        max_detections=16,
        train_rois_per_image=32,
        rpn_train_anchors_per_image=64,
    )
