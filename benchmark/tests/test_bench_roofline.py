"""`roofline.py` against `torch.utils.flop_counter` over the port's CPU
path, and its kernel counts against `chip_smoke.py`'s at the main path's
shapes; the trace reduction on a made-up event list."""

from __future__ import annotations

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import roofline, trace
from benchmark.harness import ROOT
from benchmark.reference import backbones
from benchmark.reference.backbones import _resnet
from benchmark.weights import make_params


def config(name):
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return MaskRCNNConfig.from_dict(json.load(f)["config"])


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", backbones.names())
def test_model_flops_are_the_flop_counters(arch):
    from torch.utils.flop_counter import FlopCounterMode

    from maskrcnn_tpu_torch.core.config import tiny_test_config
    from maskrcnn_tpu_torch.models.mask_rcnn import forward
    cfg = tiny_test_config().replace(architecture=arch,
                                     compute_dtype="float32",
                                     detection_score_threshold=0.0)
    params = make_params(cfg, 5, "cpu")
    images = torch.zeros((2, 128, 128, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter:
        forward(params, images, cfg, device="cpu")
    assert counter.get_total_flops() == 2 * roofline.model_flops_per_image(
        cfg)


def test_model_flops_at_1024():
    assert roofline.model_flops_per_image(config("r101_fpn_coco")) == \
        774083756032.0
    assert roofline.model_flops_per_image(config("mnv2_fpn_coco")) == \
        454781616128.0


def meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_stem_and_chains_count_as_chip_smoke_does():
    cs = chip_smoke()
    cfg = config("r101_fpn_coco")
    b, bf, f32 = 8, torch.bfloat16, torch.float32
    images = meta((b, 1024, 1024, 3), f32)
    w, bias = meta((7, 7, 3, 64), bf), meta((64,), f32)
    got_numel = b * 256 * 256 * 64
    nbytes, flops, _ = roofline.stem_call(b, cfg)
    assert nbytes == cs.nbytes(images, w, bias) + got_numel * 2
    assert flops == 2.0 * b * 512 * 512 * 64 * 147
    for chain, (hw, cin, m, cout) in zip(_resnet.CHAINS,
                                         ((256, 64, 64, 256),
                                          (128, 512, 128, 512))):
        blocks = []
        for i in range(3):
            c = cin if i == 0 else cout
            blk = {"w1": meta((c, m), bf), "b1": meta((m,), f32),
                   "w2": meta((9, m, m), bf), "b2": meta((m,), f32),
                   "w3": meta((m, cout), bf), "b3": meta((cout,), f32)}
            if i == 0 and chain[4]:
                blk.update(ws=meta((c, cout), bf), bs=meta((cout,), f32))
            blocks.append(blk)
        x = meta((b, hw, hw, cin), bf)
        wbytes = sum(cs.nbytes(*blk.values()) for blk in blocks)
        nbytes, flops, _ = roofline.chain_call(b, cfg, chain)
        assert flops == cs.chain_flops(x.shape, blocks)
        assert nbytes == cs.nbytes(x) + b * hw * hw * cout * 2 + wbytes


def test_nms_and_roi_align_count_as_chip_smoke_does():
    cs = chip_smoke()
    from maskrcnn_tpu_torch.ops import nms_cuda
    from maskrcnn_tpu_torch.ops import roi_align as ra
    cfg = config("r101_fpn_coco")
    rng = np.random.default_rng(3)
    boxes = cs.clustered_boxes(rng, 2, 600)
    cand = torch.ones((2, 600), dtype=torch.bool)
    keep = nms_cuda.nms_keep_plain(boxes, cand, 0.7, 100)
    assert roofline.nms_tests(boxes, keep, cand, 0.7, 100) == \
        cs.nms_work(boxes, keep, cand, 0.7, 100)
    nbytes, _, _ = roofline.nms_call(boxes, cand, keep, 0.7, 100)
    assert nbytes == cs.nbytes(boxes, cand) + cand.numel()
    hw = [(256, 256), (128, 128), (64, 64), (32, 32)]
    for crop, n in ((7, 300), (14, 50)):
        rois = cs.spread_rois(rng, 2, n)
        ys, xs, level, valid = ra.prepare(rois.reshape(-1, 4), hw,
                                          (1024, 1024), 224.0, crop)
        cells = cs.distinct_cells(ys, xs, level, valid, n, hw)
        assert roofline.distinct_cells(rois, crop, cfg) == cells
        nbytes, flops, _ = roofline.roi_align_call(rois, crop, cfg)
        out = 2 * n * crop * crop * 256
        assert flops == 10.0 * out
        assert nbytes == (cells * 256 * 2 + out * 2
                          + cs.nbytes(ys, xs, level, valid))


def test_fused_heads_count_the_algorithms_work():
    """K5: chip_smoke's three matmuls with the algorithm's 5 x classes
    outputs (not the kernel's padded lanes); K6: chip_smoke's convs and
    deconv plus the class's 1x1."""
    cfg = config("mnv2_fpn_coco")
    rois = torch.zeros((2, 1000, 4))
    _, flops, peak = roofline.classifier_head_call(rois, cfg)
    assert flops == 2.0 * 2000 * (12544 * 1024 + 1024 * 1024 + 1024 * 405)
    assert peak == roofline.BF16_FLOPS
    boxes = torch.zeros((2, 100, 4))
    _, flops, _ = roofline.mask_head_call(boxes, cfg)
    c = 256
    assert flops == 2.0 * 200 * (196 * (4 * 9 * c * c + c * 4 * c)
                                 + 784 * c)


def _ev(name, start, end, device=False):
    return SimpleNamespace(name=name, device_type="DeviceType.CUDA"
                           if device else "DeviceType.CPU",
                           time_range=SimpleNamespace(start=start, end=end))


def test_trace_reduction():
    events = [
        _ev(trace.WINDOW, 0, 100), _ev(trace.WINDOW, 0, 100, True),
        _ev("aten::conv", 1, 9), _ev("cudaLaunchKernel", 2, 3),
        _ev("cudaLaunchKernel", 5, 6), _ev("cudaGraphLaunch", 40, 41),
        _ev("aten::nonzero", 60, 90),
        _ev("void roi_align_kernel<7>(...)", 10, 20, True),
        _ev("head_gemm_kernel(...)", 20, 30, True),
        _ev("void roi_align_kernel<14>(...)", 50, 55, True),
        _ev("sm90_xmma_gemm", 56, 60, True)]
    prof = SimpleNamespace(events=lambda: events)
    view = trace.TraceView(prof, images=4)
    assert view.window_s == 100e-6
    assert view.busy_s == pytest.approx(29e-6)
    assert view.launches == 3
    assert view.family_s["roi_classifier_head"] == pytest.approx(20e-6)
    assert view.family_s["roi_align"] == pytest.approx(5e-6)
    idle = dict(view.idle)
    assert idle["aten::nonzero"] == pytest.approx(40e-6)
    assert sum(idle.values()) == pytest.approx(71e-6)
    assert view.breakdown()["device_ops"][0][0].startswith("void roi_align")
