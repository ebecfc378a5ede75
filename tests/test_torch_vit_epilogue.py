"""The ViT epilogue (`ops/vit_epilogue_cuda.py`) on the CPU: its plain
version against `models/vit.py`'s layer sequence bit for bit in each form
and both index maps (the grid, and a windowed block's padded windows), and
at Swin-S's widths against `models/swin.py`'s, shifted windows included;
its constant caches, its op registration, and the CPU forward of
`apply_vit`, which keeps the layers. The kernel itself is held to the
layers on the card (`tests/test_torch_gpu.py`, marked `gpu`)."""

import gc
import types
import weakref

import pytest
import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.models import nn
from maskrcnn_tpu_torch.models import swin
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
# Swin-S's residual widths on a 9x11 grid in windows of 7 (padded to 14x14,
# 4 windows an image), at the shifted blocks' shift 3, so the roll carries
# pad rows into the first windows: case -> (form, where y lies, where the
# LayerNorm output goes, width, shift)
SWIN_GRID, SWIN_SHIFT = (9, 11), 3
SWIN_CASES = {f"swin{c}_{name}": (*CASES[name][:3], c, shift)
              for c in ve.WIDTHS
              for name, shift in (("proj_windowed", SWIN_SHIFT),
                                  ("fc2_to_windowed", SWIN_SHIFT),
                                  ("fc2_to_global", 0))}


def _swin_pad_tokens(shift):
    """True at the pad tokens of the 9x11 grid's rolled, padded windows."""
    ones = torch.ones((B, *SWIN_GRID, 1))
    return swin.window_partition(ones, WINDOW, shift)[0][..., 0] == 0


@pytest.mark.parametrize("case", list(CASES) + list(SWIN_CASES))
def test_plain_epilogue_equals_layer_sequence(case):
    """Each form through the op (the plain version on the CPU) equals
    `nn.dense` + `F.gelu` or + `window_unpartition`, the float32 residual
    add, `layer_norm`, `window_partition` and the cast that `nn.dense`
    gives the next linear, bit for bit; at Swin-S's widths with the
    shifted blocks' roll (`models/swin.py`'s eps), the pad rows of a
    windowed LayerNorm output zero."""
    if case in CASES:
        form, y_at, norm_at = CASES[case]
        c, shift, grid, eps = C, 0, (GRID, GRID), vit.LN_EPS
        seed = sorted(CASES).index(case)
    else:
        form, y_at, norm_at, c, shift = SWIN_CASES[case]
        grid, eps = SWIN_GRID, swin.LN_EPS
        seed = 100 + sorted(SWIN_CASES).index(case)
    padded = tuple(-(-n // WINDOW) * WINDOW for n in grid)
    nwin = padded[0] * padded[1] // WINDOW ** 2
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, *grid, c), generator=g) * 2
    if y_at == "windows":
        a = torch.randn((B * nwin, WINDOW, WINDOW, c), generator=g)
    else:
        a = torch.randn((B, *grid, c), generator=g)
    cout = {"bias": 3 * c, "bias_gelu": 2 * c}.get(form, c)
    p = _dense(g, c, cout)
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
        want = swin.window_unpartition(want, WINDOW, padded, grid, shift)
    want_x = x + want.float()
    norm = None if norm_at is None else _norm(g, c)
    windowed = "windows" in (y_at, norm_at)
    got_x, got_n = ve.bias_residual_norm(
        y, ve.prepare(p), x, norm, eps, window=WINDOW if windowed else 0,
        norm_windowed=norm_at == "windows", shift=shift)
    assert got_x.dtype == torch.float32 and torch.equal(got_x, want_x)
    if norm is None:
        assert got_n is None
    else:
        want_n = F.layer_norm(want_x, (c,), norm["scale"], norm["bias"],
                              eps)
        if norm_at == "windows":
            want_n, _ = swin.window_partition(want_n, WINDOW, shift)
            assert want_n.shape == (B * nwin, WINDOW, WINDOW, c)
            if case in CASES:
                # rows 20 of each image's last windows
                assert float(got_n[nwin - 1, :, -1].abs().max()) == 0.0
            else:
                pads = _swin_pad_tokens(shift)
                assert pads[:, 0].any() and pads[:, :, 0].any()
                assert float(got_n[pads].abs().max()) == 0.0
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


def test_prepared_norms_are_aligned_copies_and_follow_the_weights():
    """`prepare_norm` of a LayerNorm whose scale and shift are views at an
    odd float offset of one buffer (the benchmark's weights): float32
    copies with storage of their own, equal to the views, on a 16-byte
    boundary, built once; an in-place change prepares anew; and
    `bias_residual_norm` through it equals the views' LayerNorm."""
    flat = torch.randn(1 + 2 * 96, generator=torch.Generator().manual_seed(4))
    norm = {"scale": flat[1:97], "bias": flat[97:]}
    assert norm["scale"].data_ptr() % 16
    first = ve.prepare_norm(norm)
    assert ve.prepare_norm(norm) is first
    for got, want in zip(first, (norm["scale"], norm["bias"])):
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert got.untyped_storage().data_ptr() != flat.data_ptr()
    norm["scale"].mul_(2)
    second = ve.prepare_norm(norm)
    assert second is not first and torch.equal(second.scale, norm["scale"])
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 3, 5, 96), generator=g)
    p = _dense(g, 96, 96)
    y = _raw(torch.randn((1, 3, 5, 96), generator=g), p)
    _, got = ve.bias_residual_norm(y, ve.prepare(p), x, norm, swin.LN_EPS)
    want = F.layer_norm(x + (y + ve.prepare(p).bias).float(), (96,),
                        norm["scale"], norm["bias"], swin.LN_EPS)
    assert torch.equal(got, want.to(BF16))


# Swin's windowed cases: the 9x11 grid at shift 3 -> (case, width)
SWIN_OP_CASES = {f"swin{c}_{case}_shifted": (case, c) for c in (96, 384)
                 for case in ("residual_windowed", "residual_to_windows")}


# the op's arguments after (y, bias): form, x, scale, shift, window,
# norm_windowed, eps, window_shift
def _op_args(case):
    g = torch.Generator().manual_seed(5)
    c, grid, nwin, shift = C, (GRID, GRID), NWIN, 0
    if case in SWIN_OP_CASES:
        case, c = SWIN_OP_CASES[case]
        grid, nwin, shift = SWIN_GRID, 4, SWIN_SHIFT
    x = torch.randn((B, *grid, c), generator=g)
    norm = _norm(g, c)
    if case == "bias":
        return (torch.randn((B, 12, 3 * c), generator=g).to(BF16),
                torch.randn(3 * c, generator=g).to(BF16), ve.BIAS, None,
                None, None, 0, False, 0.0, 0)
    if case == "bias_gelu":
        return (torch.randn((B, *grid, 2 * c), generator=g).to(BF16),
                torch.randn(2 * c, generator=g).to(BF16), ve.BIAS_GELU,
                None, None, None, 0, False, 0.0, 0)
    y = torch.randn((B * nwin, WINDOW, WINDOW, c), generator=g).to(BF16)
    bias = torch.randn(c, generator=g).to(BF16)
    if case == "residual_windowed":
        return (y, bias, ve.BIAS_RESIDUAL_NORM, x, norm["scale"],
                norm["bias"], WINDOW, False, 1e-6, shift)
    y = torch.randn((B, *grid, c), generator=g).to(BF16)
    if case == "residual_to_windows":
        return (y, bias, ve.BIAS_RESIDUAL_NORM, x, norm["scale"],
                norm["bias"], WINDOW, True, 1e-6, shift)
    return (y, bias, ve.BIAS_RESIDUAL_NORM, x, None, None, 0, False, 1e-6, 0)


OP_CASES = ("bias", "bias_gelu", "residual_windowed", "residual_to_windows",
            "residual_only", *SWIN_OP_CASES)


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
    """The gate opens only for bf16 on the card at the widths the
    LayerNorm form is built for (Swin-S's 96, 192, 384 and 768, ViT-B's
    768); a CPU tensor never opens it."""
    assert ve.WIDTHS == (96, 192, 384, 768)
    assert not ve.epilogue_supported(torch.zeros((1, 4, 4, 768)), BF16, 768)
    card = types.SimpleNamespace(is_cuda=True)
    for width in ve.WIDTHS:
        assert ve.epilogue_supported(card, BF16, width)
        assert not ve.epilogue_supported(card, torch.float32, width)
    for width in (256, 512, 640, 1024, 1280, 128, 48, 1536):
        assert not ve.epilogue_supported(card, BF16, width)
