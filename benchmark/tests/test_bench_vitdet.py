"""ViTDet-B's backbone file (`reference/backbones/vitdet_b.py`) and its
configuration: the model's FLOPs are the flop counter's over the port's
CPU path, the weights at the published shapes and the FLOPs at 1024^2
are pinned, and the reference's attention is the equations'. The cells
`vitdet_b.batch8` and `mnv2.stream1` join the parametrised harness
tests (`test_bench_harness.py`) by their files alone."""

from __future__ import annotations

import json

import torch

from benchmark import harness, roofline
from benchmark.reference import backbones
from benchmark.reference import model as R
from benchmark.tests.test_bench_registry import config, params_digest
from benchmark.tests.test_bench_harness import CELLS
from benchmark.weights import make_params

PARAMS_SHA256 = \
    "1aea24094ebbfb1ce3620e856ae5dcf99b4b2a1f1b7da701f5bb5420ecc720bf"
MACS = {"backbone": 482817441792.0, "fpn": 71672266752.0,
        "rpn": 103783071744.0, "classifier_head": 14308352000.0,
        "mask_head": 51400294400.0}


def test_model_flops_are_the_flop_counters_at_256():
    """The configuration's whole model (1000 proposals, 100 detections, 81
    classes) at 256^2: a 16x16 grid, its windowed blocks padded to four
    14x14 windows."""
    from torch.utils.flop_counter import FlopCounterMode

    from maskrcnn_tpu_torch.models.mask_rcnn import forward
    cfg = config("vitdet_b_coco").replace(input_image_shape=(256, 256, 3),
                                          compute_dtype="float32")
    params = make_params(cfg, 2 ** 31 + 13, "cpu")
    images = torch.zeros((1, 256, 256, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter:
        forward(params, images, cfg, device="cpu")
    assert counter.get_total_flops() == roofline.model_flops_per_image(cfg)


def test_model_flops_at_1024_are_pinned():
    cfg = config("vitdet_b_coco")
    assert roofline.model_macs(cfg) == MACS
    assert roofline.model_flops_per_image(cfg) == 1447962853376.0


def test_weights_at_full_shapes_are_pinned():
    params = make_params(config("vitdet_b_coco"), 2 ** 31 + 11, "cpu")
    assert params_digest(params) == PARAMS_SHA256
    assert params["vit_b2_attn_rel_pos"]["rel_pos_h"].shape == (127, 64)
    assert params["vit_b3_attn_rel_pos"]["rel_pos_w"].shape == (27, 64)


def naive_attention(q, k, v, th, tw, grid, scale):
    """Per head and query: scale q.k + q.table_h[i - kh + h - 1] +
    q.table_w[j - kw + w - 1] over each key (kh, kw), softmax, times v."""
    h, w = grid
    q, k, v, th, tw = (t.double() for t in (q, k, v, th, tw))
    out = torch.zeros_like(v)
    for t in range(h * w):
        i, j = divmod(t, w)
        logits = torch.stack([
            scale * (q[..., t, :] * k[..., s, :]).sum(-1)
            + (q[..., t, :] * th[i - s // w + h - 1]).sum(-1)
            + (q[..., t, :] * tw[j - s % w + w - 1]).sum(-1)
            for s in range(h * w)], -1)
        out[..., t, :] = torch.einsum("nas,nasd->nad",
                                      torch.softmax(logits, -1), v)
    return out


def test_reference_attention_is_the_equations():
    vb = backbones.load("vitdet_b")
    g = torch.Generator().manual_seed(5)
    for grid in ((3, 3), (2, 5)):
        h, w = grid
        q, k, v = (torch.randn((2, 3, h * w, 8), generator=g)
                   for _ in range(3))
        rel = {"rel_pos_h": torch.randn((2 * h - 1, 8), generator=g) * 0.5,
               "rel_pos_w": torch.randn((2 * w - 1, 8), generator=g) * 0.5}
        got = vb.attend(q, k, v, rel, grid, R.Numerics("float32"))
        want = naive_attention(q, k, v, rel["rel_pos_h"], rel["rel_pos_w"],
                               grid, 8 ** -0.5)
        assert float((got.double() - want).abs().max()) <= 1e-5


def test_the_new_cells_are_in_the_harness_tests():
    assert {"vitdet_b.batch8", "mnv2.stream1"} <= set(CELLS)
    cell = harness.load_cell("vitdet_b.batch8")
    assert cell.model_config().architecture == "vitdet_b"
    assert cell.mix == json.load(open(f"{harness.HERE}/traffic/batch8.json"))
    assert {m["name"] for m in cell.per_layer()} == {
        "mfu.infer", "device_idle.infer", "forward.host_launches_per_image"}
