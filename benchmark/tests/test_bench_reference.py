"""The plain reference against the port's CPU path at tiny sizes, and its
independence from the program."""

from __future__ import annotations

import ast
import glob
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import HERE
from benchmark.reference import backbones, check
from benchmark.reference import model as R
from benchmark.weights import make_params

ARCHS = backbones.names()


def tiny(arch, **kw):
    from maskrcnn_tpu_torch.core.config import tiny_test_config
    return tiny_test_config().replace(architecture=arch,
                                      compute_dtype="float32",
                                      detection_score_threshold=0.0, **kw)


def test_every_architecture_has_a_backbone_file():
    """Each architecture the port accepts, and each one a configuration
    of the benchmark names, has its file in the registry."""
    from maskrcnn_tpu_torch.core.config import _VALID_ARCHITECTURES
    configured = set()
    for path in glob.glob(os.path.join(HERE, "configs", "*.json")):
        with open(path) as f:
            configured.add(json.load(f)["config"]["architecture"])
    assert configured
    assert set(_VALID_ARCHITECTURES) | configured <= set(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_layout_is_the_ports(arch):
    from maskrcnn_tpu_torch.models.mask_rcnn import init_mask_rcnn
    cfg = tiny(arch)
    init = init_mask_rcnn(torch.Generator().manual_seed(0), cfg)
    shapes = R.param_shapes(cfg)
    assert list(init) == list(shapes)
    for layer, weights in init.items():
        assert {k: tuple(v.shape) for k, v in weights.items()} == \
            shapes[layer], layer


def test_weights_come_from_the_seed_alone():
    cfg = tiny("resnet50")
    a, b = make_params(cfg, 2 ** 33 + 1, "cpu"), make_params(cfg, 2 ** 33 + 1,
                                                             "cpu")
    c = make_params(cfg, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[k][w], b[k][w]) for k in a for w in a[k])
    assert not torch.equal(a["conv1"]["kernel"], c["conv1"]["kernel"])


@pytest.mark.parametrize("arch,fused", [("resnet50", False),
                                        ("resnet101", False),
                                        ("mobilenetv2", True)])
def test_reference_agrees_with_the_ports_cpu_path(arch, fused):
    """float32 on both sides: the judge reads rounding only, and the
    reference's own pipeline gives the port's outputs."""
    from maskrcnn_tpu_torch.models.mask_rcnn import forward
    cfg = tiny(arch, fuse_classifier_head=fused, fuse_mask_head=fused)
    params = make_params(cfg, 2 ** 31 + 3, "cpu")
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 128, 128, 3), dtype=np.uint8))
    got = forward(params, images, cfg, device="cpu", paste_size=128)
    numbers = check.judge(params, cfg, images, got, class_band=1e-3)
    bound = {"proposal_iou": cfg.proposal_nms_threshold,
             "det_iou": cfg.detection_nms_threshold}
    assert all(v <= bound.get(k, 1e-4) for k, v in numbers.items()), numbers
    ref = R.detect(params, images, cfg, R.Numerics("float32"),
                   paste_size=128)
    assert torch.equal(ref["valid"], got["valid"])
    assert torch.equal(ref["roi_valid"], got["roi_valid"])
    torch.testing.assert_close(ref["rois"], got["rois"], atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(ref["detections"], got["detections"],
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ref["masks"], got["masks"], atol=1e-4,
                               rtol=0)
    assert (ref["pasted"] != got["pasted"]).float().mean() < 1e-4


def test_float8_operands_round_to_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.3])
    q = R.Numerics("fp8").q(x)
    assert q[0] == 1.0 and q[3] == 448.0
    assert (q - x).abs().max() <= 2 ** -4 * x.abs().max()
    assert torch.equal(R.Numerics("float32").q(x), x)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    """The reference and every backbone file of its registry."""
    here = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "reference")
    seen = 0
    for dirpath, _, files in os.walk(here):
        for name in files:
            if name.endswith(".py"):
                seen += 1
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(dirpath, name))}
                assert not tops & {"maskrcnn_tpu_torch", "maskrcnn_tpu",
                                   "jax", "jaxlib", "flax"}, (name, tops)
    assert seen >= 7


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: `maskrcnn_tpu_torch` begins with
    `maskrcnn_tpu` and is allowed."""
    root = os.path.dirname(os.path.dirname(__file__))
    seen = 0
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                seen += 1
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(dirpath, name))}
                assert not tops & {"jax", "jaxlib", "flax", "maskrcnn_tpu"}, \
                    (name, tops)
    assert seen > 10
