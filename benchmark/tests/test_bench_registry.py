"""The per-architecture registry (`reference/backbones/`): what the two
cells read is pinned to the values it had before the registry, and a new
backbone joins by a file alone.

The pinned values were computed on the CPU, one torch thread, from the
tree before the backbones moved into the registry: the weights at full
published shapes, the model's multiply-adds by part, the roofline's work
on fixed ROIs, and the reference's outputs at the tiny configuration."""

from __future__ import annotations

import hashlib
import json
import os
import re

import numpy as np
import pytest
import torch

from benchmark import harness, roofline
from benchmark.reference import backbones, check
from benchmark.reference import model as R
from benchmark.weights import make_params

PARAMS_SHA256 = {
    "r101_fpn_coco":
        "5df2f57b2370b7cf763cd39346e5d4a3d8311c84a633080c910d1cf304364cc3",
    "mnv2_fpn_coco":
        "73ee1164aea14b548f0a8a563601fd4d942ca3f71bff770881c360118adcfb79",
}
MACS = {
    "r101_fpn_coco": {"backbone": 158158815232.0, "fpn": 59391344640.0,
                      "rpn": 103783071744.0,
                      "classifier_head": 14308352000.0,
                      "mask_head": 51400294400.0},
    "mnv2_fpn_coco": {"backbone": 5839388672.0, "fpn": 52059701248.0,
                      "rpn": 103783071744.0,
                      "classifier_head": 14308352000.0,
                      "mask_head": 51400294400.0},
}
BF16, F32 = 989e12, 67e12
WORK = {
    "r101_fpn_coco": {
        "stem": [(41962112.0, 9865003008.0, BF16),
                 (20990592.0, 4932501504.0, BF16)],
        "bottleneck": [(84317696.0, 55834574848.0, BF16),
                       (68789248.0, 54760833024.0, BF16),
                       (42374656.0, 27917287424.0, BF16),
                       (35234816.0, 27380416512.0, BF16)],
        "roi_align": [(72180368.0, 250880000.0, F32),
                      (28665192.0, 100352000.0, F32),
                      (36275784.0, 125440000.0, F32),
                      (13529012.0, 50176000.0, F32)]},
    "mnv2_fpn_coco": {
        "roi_classifier_head": [(53870884.0, 57233408000.0, BF16),
                                (41434300.0, 28616704000.0, BF16)],
        "roi_mask_head": [(14557132.0, 205601177600.0, BF16),
                          (9142152.0, 102800588800.0, BF16)]},
}
DETECT_SHA256 = {
    ("resnet50", "float32"):
        "addd8842b8e9b4f4b1019b1f2afba96c0f10366777779587b017005690a72498",
    ("resnet50", "fp8"):
        "559d98f222770d2b72ad5d0007abd7bb9faa7038070978ef3510a95411fb9a41",
    ("resnet101", "float32"):
        "b0656c0fa07618c2bba4f3c6c0c82f0f0cb3f0e9490a521cf3e9605d31f7b073",
    ("resnet101", "fp8"):
        "dad51b0ad1ec44500337a7806c3d5befb2d7c53e0295df15859cb27f81c385c2",
    ("mobilenetv2", "float32"):
        "633da2eef17f2cd86a3657ceecc2545250f1f06056f27fe7d8e5558c7981f3c3",
    ("mobilenetv2", "fp8"):
        "38ebc81a04c4e23de7cbd450f06a5b17a6d0a11f8eebf31f7f943756c92f11b8",
}
FUSED = {"resnet50": False, "resnet101": False, "mobilenetv2": True}


def config(name):
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return MaskRCNNConfig.from_dict(json.load(f)["config"])


def tiny(arch):
    from maskrcnn_tpu_torch.core.config import tiny_test_config
    return tiny_test_config().replace(
        architecture=arch, compute_dtype="float32",
        detection_score_threshold=0.0, fuse_classifier_head=FUSED[arch],
        fuse_mask_head=FUSED[arch])


def tiny_images():
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 128, 128, 3), dtype=np.uint8))


def params_digest(params) -> str:
    """Every tensor's name, shape and bytes, in layer order."""
    h = hashlib.sha256()
    for layer, weights in params.items():
        for name, t in weights.items():
            h.update(f"{layer}/{name}{tuple(t.shape)}".encode())
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def outputs_digest(out) -> str:
    h = hashlib.sha256()
    for k in sorted(out):
        t = out[k]
        h.update(f"{k}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def fixed_rois(rng, b, n):
    """(b, n, 4) normalized boxes, the last three of each image empty."""
    y = np.sort(rng.uniform(0, 1, (b, n, 2)), -1)
    x = np.sort(rng.uniform(0, 1, (b, n, 2)), -1)
    r = np.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], -1)
    r[:, -3:] = 0.0
    return torch.from_numpy(r.astype(np.float32))


def fixed_forwards():
    rng = np.random.default_rng(7)
    return [(fixed_rois(rng, 2, 1000), fixed_rois(rng, 2, 100)),
            (fixed_rois(rng, 1, 1000), fixed_rois(rng, 1, 100))]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# What the cells read, pinned
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PARAMS_SHA256))
def test_weights_at_full_shapes_are_pinned(name):
    """The layout's order is the order of the draws: bit-identical
    weights at one seed mean the same layers, shapes, order and scales."""
    params = make_params(config(name), 2 ** 31 + 11, "cpu")
    assert params_digest(params) == PARAMS_SHA256[name]


@pytest.mark.parametrize("name", sorted(MACS))
def test_model_macs_by_part_are_pinned(name):
    macs = roofline.model_macs(config(name))
    assert macs == MACS[name]
    assert list(macs) == list(MACS[name])


@pytest.mark.parametrize("name", sorted(WORK))
def test_forward_work_is_pinned(name):
    work = roofline.forward_work(config(name), fixed_forwards())
    assert {k: [tuple(map(float, c)) for c in v]
            for k, v in work.items()} == WORK[name]


@pytest.mark.parametrize("arch,numerics", sorted(DETECT_SHA256))
def test_reference_outputs_are_pinned(arch, numerics, one_thread):
    """The reference's outputs at the tiny configuration, bit for bit; in
    float8 too, the control's numerics."""
    cfg = tiny(arch)
    params = make_params(cfg, 2 ** 31 + 3, "cpu")
    out = R.detect(params, tiny_images(), cfg, R.Numerics(numerics),
                   paste_size=128 if numerics == "float32" else None)
    assert outputs_digest(out) == DETECT_SHA256[(arch, numerics)]


def test_no_file_outside_the_registry_names_an_architecture():
    """The backbone is chosen by the registry alone: no other benchmark
    code compares the configuration's architecture with a name."""
    pattern = re.compile(r"architecture\s*[!=]=|FIRST_CONV")
    registry = os.path.join(harness.HERE, "reference", "backbones")
    tests = os.path.join(harness.HERE, "tests")
    seen = 0
    for dirpath, _, files in os.walk(harness.HERE):
        if dirpath.startswith((registry, tests)):
            continue
        for name in files:
            if name.endswith(".py"):
                seen += 1
                with open(os.path.join(dirpath, name)) as f:
                    assert not pattern.search(f.read()), name
    assert seen > 10


# --------------------------------------------------------------------------
# A backbone added by a file alone
# --------------------------------------------------------------------------

TOY = '''"""A toy backbone: a 4x4/4 convolution with a learned offset, a 3x3
convolution to P2, and P3..P6 by 2x2 max-pooling."""

import torch.nn.functional as F

from benchmark.reference import model as R


def param_shapes(cfg):
    return {"toy_stem": dict(R.conv_shape(4, 4, 3, 16), offset=(16,)),
            "toy_p2": R.conv_shape(3, 3, 16, cfg.fpn_channels)}


def pyramid(params, x, cfg, nx):
    p = params["toy_stem"]
    x = R.conv(x, p, nx, stride=4) + p["offset"][None, :, None, None]
    out = [R.conv(x.relu(), params["toy_p2"], nx)]
    for _ in range(4):
        out.append(F.max_pool2d(out[-1], 2))
    return out


def macs(cfg):
    h, w = cfg.feature_shapes[0]
    return {"backbone": float(h * w * 4 * 4 * 3 * 16),
            "fpn": float(h * w * 9 * 16 * cfg.fpn_channels)}


def init_std(layer, shape):
    return 1e-3 if layer == "toy_stem" else None


def init_range(layer, weight, shape):
    return (1.0, 1.5) if weight == "offset" else None
'''


@pytest.fixture
def toy_registry(tmp_path, monkeypatch):
    (tmp_path / "toy.two_conv.py").write_text(TOY)
    monkeypatch.setattr(backbones, "DIR", str(tmp_path))
    return tmp_path


def toy_config():
    cfg = tiny("resnet50")
    object.__setattr__(cfg, "architecture", "toy.two_conv")
    return cfg


def test_a_backbone_is_added_by_a_file_alone(toy_registry, one_thread):
    from torch.utils.flop_counter import FlopCounterMode
    assert backbones.names() == ["toy.two_conv"]
    cfg = toy_config()
    params = make_params(cfg, 2 ** 31 + 21, "cpu")
    assert list(params)[:3] == ["toy_stem", "toy_p2", "rpn_conv_shared"]
    stem = params["toy_stem"]
    assert stem["kernel"].abs().max() < 0.01          # its init_std
    assert params["toy_p2"]["kernel"].std() > 0.05    # the default
    assert ((stem["offset"] >= 1.0) & (stem["offset"] < 1.5)).all()
    assert stem["bias"].abs().max() <= 0.05           # the default range
    images = tiny_images()
    nx = R.Numerics("float32")
    with FlopCounterMode(display=False) as counter:
        out = R.detect(params, images, cfg, nx)
    assert counter.get_total_flops() == 2 * roofline.model_flops_per_image(
        cfg)
    assert out["valid"].any()
    numbers = check.judge(params, cfg, images, out, class_band=1e-3)
    assert numbers["det_box"] == 0 and numbers["left_out"] == 0, numbers
    work = roofline.forward_work(cfg, fixed_forwards())
    assert set(work) == {"roi_align"}


def test_an_unknown_architecture_names_the_path(toy_registry):
    with pytest.raises(ValueError, match=re.escape(
            str(toy_registry / "resnet101.py"))):
        backbones.load("resnet101")
