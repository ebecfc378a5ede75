"""Swin-S's backbone file (`reference/backbones/swin_s.py`) and its
configuration: the model's FLOPs are the flop counter's over the port's
CPU path, the FLOPs at 1024^2 and the weights at the published shapes are
pinned, and the reference's attention and shifted windows are the
equations'. The cell `swin_s.batch8` joins the parametrised harness tests
(`test_bench_harness.py`) by its files alone."""

from __future__ import annotations

import json

import torch

from benchmark import harness, roofline
from benchmark.reference import backbones
from benchmark.reference import model as R
from benchmark.tests.test_bench_harness import CELLS
from benchmark.tests.test_bench_registry import config, params_digest
from benchmark.weights import make_params

PARAMS_SHA256 = \
    "b08f0563bc5792b1e4de82732ffaabff010d7dce671a42a7d3411a06dc69a230"
MACS = {"backbone": 193286591616.0, "fpn": 54358179840.0,
        "rpn": 103783071744.0, "classifier_head": 14308352000.0,
        "mask_head": 51400294400.0}


def test_model_flops_are_the_flop_counters_at_256():
    """The configuration's whole model (1000 proposals, 100 detections, 81
    classes) at 256^2: grids 64, 32, 16, 8, padded to 70, 35, 21, 14."""
    from torch.utils.flop_counter import FlopCounterMode

    from maskrcnn_tpu_torch.models.mask_rcnn import forward
    cfg = config("swin_s_fpn_coco").replace(input_image_shape=(256, 256, 3),
                                            compute_dtype="float32")
    params = make_params(cfg, 2 ** 31 + 13, "cpu")
    images = torch.zeros((1, 256, 256, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter:
        forward(params, images, cfg, device="cpu")
    assert counter.get_total_flops() == roofline.model_flops_per_image(cfg)


def test_model_flops_at_1024_are_pinned():
    cfg = config("swin_s_fpn_coco")
    assert roofline.model_macs(cfg) == MACS
    assert roofline.model_flops_per_image(cfg) == 834272979200.0


def test_weights_at_full_shapes_are_pinned():
    params = make_params(config("swin_s_fpn_coco"), 2 ** 31 + 11, "cpu")
    assert params_digest(params) == PARAMS_SHA256
    assert params["swin_s2_b17_attn_rel_pos"]["table"].shape == (169, 12)
    assert params["swin_merge2_reduction"]["kernel"].shape == (1536, 768)
    assert params["fpn_c2p2"]["kernel"].shape == (1, 1, 96, 256)
    table = params["swin_s0_b1_attn_rel_pos"]["table"]
    assert 1.3 < float(table.abs().max()) <= 1.5


def naive_window_attention(q, k, v, table, scale, labels):
    """(b, nW, heads, 49, d): per window, head, query (i, j) and key
    (k, l): scale q.k + table[(i - k + 6) 13 + (j - l + 6), head], -100
    where `labels` (nW, 49) differ (None: nothing masked), softmax, v."""
    b, nw, heads, t, _ = q.shape
    q, k, v, table = (x.double() for x in (q, k, v, table))
    out = torch.zeros_like(v)
    for a in range(t):
        i, j = divmod(a, 7)
        logits = torch.stack([
            scale * (q[..., a, :] * k[..., s, :]).sum(-1)
            + table[(i - s // 7 + 6) * 13 + (j - s % 7 + 6)]
            for s in range(t)], -1)                       # (b, nW, heads, t)
        if labels is not None:
            logits = logits - 100.0 * (labels[:, a, None] != labels)[
                None, :, None, :].double()
        out[..., a, :] = torch.einsum("bwhs,bwhsd->bwhd",
                                      torch.softmax(logits, -1), v)
    return out


def test_reference_attention_is_the_equations():
    sb = backbones.load("swin_s")
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, 4, 3, 49, 8), generator=g) for _ in range(3))
    table = torch.rand((169, 3), generator=g) * 3 - 1.5
    # a 14x14 map, 4 windows: rows and columns cut at 7 and 11
    band = torch.tensor([0] * 7 + [1] * 4 + [2] * 3)
    label_map = band[:, None] * 3 + band[None, :]
    labels = label_map.view(2, 7, 2, 7).permute(0, 2, 1, 3).reshape(4, 49)
    mask = sb.shift_mask(14, 14, "cpu")
    assert torch.equal(mask, torch.where(labels[:, :, None]
                                         == labels[:, None, :], 0.0, -100.0))
    nx = R.Numerics("float32")
    for m, lab in ((None, None), (mask, labels)):
        got = sb.attend(q, k, v, table, m, nx)
        want = naive_window_attention(q, k, v, table, 8 ** -0.5, lab)
        assert float((got.double() - want).abs().max()) <= 1e-5


def test_reference_shifted_block_rolls_and_crops():
    """A shifted block of the reference on a 10x12 grid (padded to 14x14)
    whose attention is each token's own value: q = k = 0, v = LN1(x), a
    table that puts +50 on the zero offset, proj the identity. The output
    is x + LN1(x) at every token, so the roll back and the crop put every
    token home."""
    sb = backbones.load("swin_s")
    g = torch.Generator().manual_seed(6)
    c = 96
    x = torch.randn((1, 10, 12, c), generator=g)
    b = "blk_"
    qkv = torch.zeros((c, 3 * c))
    qkv[:, 2 * c:] = torch.eye(c)
    table = torch.zeros((169, 3))
    table[6 * 13 + 6] = 50.0
    norm = {"scale": torch.ones(c), "bias": torch.zeros(c)}
    params = {b + "norm1": norm,
              b + "attn_qkv": {"kernel": qkv, "bias": torch.zeros(3 * c)},
              b + "attn_rel_pos": {"table": table},
              b + "attn_proj": {"kernel": torch.eye(c),
                                "bias": torch.zeros(c)}}
    out = sb.attention_block(x, params, b, 3, True, R.Numerics("float32"))
    assert torch.allclose(out, x + sb.ln(x, norm), atol=1e-5)


def test_the_new_cell_is_in_the_harness_tests():
    assert "swin_s.batch8" in set(CELLS)
    cell = harness.load_cell("swin_s.batch8")
    assert cell.model_config().architecture == "swin_s"
    assert cell.mix == json.load(open(f"{harness.HERE}/traffic/batch8.json"))
    assert {m["name"] for m in cell.per_layer()} == {
        "mfu.infer", "device_idle.infer", "forward.host_launches_per_image"}
    assert {m["name"] for m in cell.end_to_end()} == {"images_per_s",
                                                      "setup_s"}
