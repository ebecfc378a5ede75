"""The ViT epilogue (`ops/vit_epilogue_cuda.py`) on the CPU: its plain
version against `models/vit.py`'s layer sequence bit for bit in each form
and both index maps (the grid, and a windowed block's padded windows), its
constant cache, its op registration, and the CPU forward of `apply_vit`,
which keeps the layers. The kernel itself is held to the layers on the card
(`tests/test_torch_gpu.py`, marked `gpu`)."""

import gc
import types
import weakref

import pytest
import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.models import nn
from maskrcnn_tpu_torch.models import vit
from maskrcnn_tpu_torch.ops import cuda_lib
from maskrcnn_tpu_torch.ops import vit_epilogue_cuda as ve
from tests.torch_support import one_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
# a 20x20 grid in windows of 7, padded to 21x21 (9 windows an image), as
# ViTDet-B's 64x64 grid is padded to 70x70 in windows of 14
B, GRID, WINDOW, C = 2, 20, 7, 32
NWIN = 9


def _dense(g, cin, cout):
    return {"kernel": torch.randn((cin, cout), generator=g) * cin ** -0.5,
            "bias": torch.randn(cout, generator=g) * 0.5}


def _norm(g, c):
    return {"scale": torch.rand(c, generator=g) + 0.5,
            "bias": torch.randn(c, generator=g) * 0.2}


def _raw(a, p):
    """The matmul before the bias, as the fused route runs it."""
    return a.to(BF16) @ ve.prepare(p).kernel


# case -> (form run, where y lies, where the LayerNorm output goes, or None
# without one)
CASES = {"qkv_windowed": ("bias", "windows", None),
         "qkv_global": ("bias", "grid", None),
         "fc1": ("bias_gelu", "grid", None),
         "proj_windowed": ("residual", "windows", "grid"),
         "proj_global": ("residual", "grid", "grid"),
         "fc2_to_windowed": ("residual", "grid", "windows"),
         "fc2_to_global": ("residual", "grid", "grid"),
         "fc2_last": ("residual", "grid", None)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_epilogue_equals_layer_sequence(case):
    """Each form through the op (the plain version on the CPU) equals
    `nn.dense` + `F.gelu` or + `window_unpartition`, the float32 residual
    add, `layer_norm`, `window_partition` and the cast that `nn.dense`
    gives the next linear, bit for bit."""
    form, y_at, norm_at = CASES[case]
    g = torch.Generator().manual_seed(sorted(CASES).index(case))
    x = torch.randn((B, GRID, GRID, C), generator=g) * 2
    if y_at == "windows":
        a = torch.randn((B * NWIN, WINDOW, WINDOW, C), generator=g)
    else:
        a = torch.randn((B, GRID, GRID, C), generator=g)
    cout = {"bias": 3 * C, "bias_gelu": 2 * C}.get(form, C)
    p = _dense(g, C, cout)
    want = nn.dense(a, p, dtype=BF16)
    y = _raw(a, p)
    cuda_lib.reset_launches()
    if form == "bias":
        got = ve.bias(y, ve.prepare(p))
        assert got.dtype == BF16 and torch.equal(got, want)
        return
    if form == "bias_gelu":
        got = ve.bias_gelu(y, ve.prepare(p))
        assert got.dtype == BF16 and torch.equal(got, F.gelu(want))
        return
    if y_at == "windows":
        want = vit.window_unpartition(want, WINDOW, (21, 21), (GRID, GRID))
    want_x = x + want.float()
    norm = None if norm_at is None else _norm(g, C)
    windowed = "windows" in (y_at, norm_at)
    got_x, got_n = ve.bias_residual_norm(
        y, ve.prepare(p), x, norm, vit.LN_EPS,
        window=WINDOW if windowed else 0, norm_windowed=norm_at == "windows")
    assert got_x.dtype == torch.float32 and torch.equal(got_x, want_x)
    if norm is None:
        assert got_n is None
    else:
        want_n = vit.layer_norm(want_x, norm)
        if norm_at == "windows":
            want_n, _ = vit.window_partition(want_n, WINDOW)
            assert want_n.shape == (B * NWIN, WINDOW, WINDOW, C)
            # the pad rows are zero (rows 20 of each image's last windows)
            assert float(got_n[NWIN - 1, :, -1].abs().max()) == 0.0
        assert got_n.dtype == BF16 and torch.equal(got_n, want_n.to(BF16))
    assert not any(cuda_lib.launches.values())


def test_prepared_constants_are_cached_and_follow_the_weights(monkeypatch):
    """A second call returns the same tensors, equal to `nn.dense`'s casts;
    an in-place change (`copy_`) to the kernel or the bias, or a replaced
    tensor, prepares anew; while torch traces nothing is cached; the cache
    keeps no parameter set alive."""
    g = torch.Generator().manual_seed(3)
    p = _dense(g, 16, 48)
    first = ve.prepare(p)
    assert ve.prepare(p) is first
    assert first.kernel.dtype == BF16 and first.bias.dtype == BF16
    assert torch.equal(first.kernel, p["kernel"].to(BF16))
    assert torch.equal(first.bias, p["bias"].to(BF16))
    assert first.kernel.is_contiguous()

    p["kernel"].copy_(p["kernel"] * 2)
    second = ve.prepare(p)
    assert second is not first
    assert torch.equal(second.kernel, (first.kernel.float() * 2).to(BF16))
    p["bias"].copy_(p["bias"] + 1)
    third = ve.prepare(p)
    assert third is not second and not torch.equal(third.bias, second.bias)
    p["bias"] = p["bias"] + 1
    fourth = ve.prepare(p)
    assert fourth is not third and not torch.equal(fourth.bias, third.bias)
    assert ve.prepare(p) is fourth

    monkeypatch.setattr(ve, "tracing", lambda: True)
    traced = ve.prepare(p)
    assert traced is not fourth and ve.prepare(p) is not traced
    monkeypatch.undo()
    assert ve.prepare(p) is fourth

    kernel = weakref.ref(p["kernel"])
    del p, first, second, third, fourth, traced
    gc.collect()
    assert kernel() is None


# the op's arguments after (y, bias): form, x, scale, shift, window,
# norm_windowed, eps
def _op_args(case):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((B, GRID, GRID, C), generator=g)
    norm = _norm(g, C)
    if case == "bias":
        return (torch.randn((B, 12, 3 * C), generator=g).to(BF16),
                torch.randn(3 * C, generator=g).to(BF16), ve.BIAS, None,
                None, None, 0, False, 0.0)
    if case == "bias_gelu":
        return (torch.randn((B, GRID, GRID, 2 * C), generator=g).to(BF16),
                torch.randn(2 * C, generator=g).to(BF16), ve.BIAS_GELU,
                None, None, None, 0, False, 0.0)
    y = torch.randn((B * NWIN, WINDOW, WINDOW, C), generator=g).to(BF16)
    bias = torch.randn(C, generator=g).to(BF16)
    if case == "residual_windowed":
        return (y, bias, ve.BIAS_RESIDUAL_NORM, x, norm["scale"],
                norm["bias"], WINDOW, False, 1e-6)
    y = torch.randn((B, GRID, GRID, C), generator=g).to(BF16)
    if case == "residual_to_windows":
        return (y, bias, ve.BIAS_RESIDUAL_NORM, x, norm["scale"],
                norm["bias"], WINDOW, True, 1e-6)
    return (y, bias, ve.BIAS_RESIDUAL_NORM, x, None, None, 0, False, 1e-6)


OP_CASES = ("bias", "bias_gelu", "residual_windowed", "residual_to_windows",
            "residual_only")


@pytest.mark.parametrize("case", OP_CASES)
def test_custom_op_passes_opcheck(case):
    """`torch.ops.maskrcnn_tpu_torch.vit_epilogue` in each form and layout:
    schema, fake implementation (the output shapes of each index map),
    autograd registration and dispatch as `torch.library.opcheck` checks
    them, the fake's shapes and dtypes equal to the plain version's."""
    args = _op_args(case)
    op = torch.ops.maskrcnn_tpu_torch.vit_epilogue.default
    torch.library.opcheck(op, args)
    got = op(*args)
    want = ve.epilogue_plain(*args)
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


SPEC = vit.ViTSpec(width=C, depth=5, heads=2, mlp=2 * C, patch=16,
                   window=WINDOW, global_blocks=(2, 4), pretrain_grid=14,
                   pyramid=(8, 16, 32, 32))


def test_cpu_vit_keeps_the_layers(monkeypatch):
    """On the CPU `apply_vit` runs the layers and never the fused route
    (the parity tests against the reference stand on it), the counter at
    0. With the gate opened, the fused route (the plain version, the
    prepared weights, every form and layout: blocks windowed, windowed,
    global, windowed, global, so fc2 hands LN1 to a windowed and to a
    global block and the last block's fc2 hands on none) gives the same
    pyramid bit for bit, in bf16 on a 20x20 grid in windows of 7."""
    monkeypatch.setitem(vit.VIT, "vit_epilogue_test", SPEC)
    g = torch.Generator().manual_seed(7)
    params = vit.init_vit(g, "vit_epilogue_test", (320, 320), channels=16)
    for name, p in params.items():   # LayerNorms off the identity
        if "norm" in name:
            p.update(_norm(g, p["scale"].shape[0]))
        if name.endswith("rel_pos"):
            for k in p:
                p[k] = torch.randn(p[k].shape, generator=g) * 0.1
    images = torch.randn((B, 320, 320, 3), generator=g) * 50
    fused = (vit._attention_fused, vit._mlp_fused)

    def refuse(*a, **k):
        raise AssertionError("fused route taken on the CPU")

    monkeypatch.setattr(vit, "_attention_fused", refuse)
    monkeypatch.setattr(vit, "_mlp_fused", refuse)
    cuda_lib.reset_launches()
    want = vit.apply_vit(params, images, "vit_epilogue_test", BF16)
    assert not any(cuda_lib.launches.values())
    monkeypatch.setattr(vit, "_attention_fused", fused[0])
    monkeypatch.setattr(vit, "_mlp_fused", fused[1])
    monkeypatch.setattr(ve, "epilogue_supported",
                        lambda x, dtype, width: True)
    calls = []
    op = ve._epilogue_op

    def counted(*a):
        calls.append(a[2])
        return op(*a)

    monkeypatch.setattr(ve, "_epilogue_op", counted)
    got = vit.apply_vit(params, images, "vit_epilogue_test", BF16)
    assert not any(cuda_lib.launches.values())
    # four passes a block, block 0's LN1 the layers'
    assert calls == [ve.BIAS, ve.BIAS_RESIDUAL_NORM, ve.BIAS_GELU,
                     ve.BIAS_RESIDUAL_NORM] * SPEC.depth
    for gt, w in zip(got, want):
        assert gt.dtype == BF16 and torch.equal(gt, w)


def test_gate_opens_for_bf16_on_the_card_at_widths_the_pass_takes():
    """The gate opens only for bf16 on the card at the width the
    LayerNorm form is built for (ViT-B's 768); a CPU tensor never opens
    it."""
    assert ve.WIDTH == 768
    assert not ve.epilogue_supported(torch.zeros((1, 4, 4, 768)), BF16, 768)
    card = types.SimpleNamespace(is_cuda=True)
    assert ve.epilogue_supported(card, BF16, 768)
    assert not ve.epilogue_supported(card, torch.float32, 768)
    for width in (256, 512, 640, 1024, 1280, 128):
        assert not ve.epilogue_supported(card, BF16, width)
