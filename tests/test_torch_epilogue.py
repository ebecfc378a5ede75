"""The conv epilogue of ResNet's layer path (`ops/conv_epilogue_cuda.py`)
on the CPU: its plain version against the layers' op sequence bit for bit,
its constant cache, and the CPU forward of `apply_resnet`, which keeps the
layers. The kernel itself is held to the layers on the card
(`tests/test_torch_gpu.py`, marked `gpu`)."""

import gc
import weakref

import numpy as np
import pytest
import torch

from maskrcnn_tpu_torch.models import nn
from maskrcnn_tpu_torch.models import resnet
from maskrcnn_tpu_torch.ops import conv_epilogue_cuda as ep
from maskrcnn_tpu_torch.ops import cuda_lib
from tests.torch_support import rand_bn, rand_conv, resnet_case
from tests.torch_support import one_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _layer(rng, kh, cin, cout):
    return (_torch(rand_conv(rng, kh, kh, cin, cout)),
            _torch(rand_bn(rng, cout)))


@pytest.mark.parametrize("form", ["bn_relu", "identity", "projection"])
def test_plain_epilogue_equals_layer_sequence(form):
    """`epilogue_plain` on the raw conv output (`nn.conv2d_nobias` with the
    prepared channels-last weight) equals `nn.conv2d` + `nn.batch_norm` +
    `nn.relu` (+ the residual add) bit for bit, in each form."""
    rng = np.random.default_rng(1)
    cin, c = 16, 32
    x = torch.from_numpy(rng.standard_normal((2, 9, 7, cin))
                         .astype(np.float32)).to(BF16)
    conv, bn = _layer(rng, 3 if form == "bn_relu" else 1, cin, c)
    layer = ep.prepare(conv, bn)
    pad = "SAME" if form == "bn_relu" else "VALID"
    want = nn.batch_norm(nn.conv2d(x, conv, padding=pad), bn)
    y = nn.conv2d_nobias(x, layer.weight, padding=pad)
    if form == "bn_relu":
        got = ep.conv_epilogue(y, layer)
    elif form == "identity":
        res = torch.from_numpy(rng.standard_normal((2, 9, 7, c))
                               .astype(np.float32)).to(BF16)
        want = want + res
        got = ep.conv_epilogue(y, layer, residual=res)
    else:
        sconv, sbn = _layer(rng, 1, cin, c)
        short = ep.prepare(sconv, sbn)
        want = want + nn.batch_norm(nn.conv2d(x, sconv, padding="VALID"),
                                    sbn)
        got = ep.conv_epilogue(
            y, layer, residual=nn.conv2d_nobias(x, short.weight,
                                                padding="VALID"),
            shortcut=short)
    want = nn.relu(want)
    assert got.dtype == BF16 and got.shape == want.shape
    assert torch.equal(got, want)


def test_prepared_constants_are_cached_and_follow_the_weights(monkeypatch):
    """A second call returns the same tensors; an in-place change (`copy_`)
    to the kernel or a BN statistic, or a replaced tensor, prepares anew;
    while torch traces nothing is cached; the cache keeps no parameter set
    alive."""
    rng = np.random.default_rng(2)
    conv, bn = _layer(rng, 1, 8, 16)
    first = ep.prepare(conv, bn)
    assert ep.prepare(conv, bn) is first
    assert first.weight.dtype == BF16 and first.bias.dtype == BF16
    assert first.weight.shape == (16, 8, 1, 1)
    assert first.weight.is_contiguous(memory_format=torch.channels_last)
    scale = bn["gamma"] * torch.rsqrt(bn["moving_variance"] + 1e-3)
    assert torch.equal(first.scale, scale)
    assert torch.equal(first.shift, bn["beta"] - bn["moving_mean"] * scale)

    conv["kernel"].copy_(conv["kernel"] * 2)
    second = ep.prepare(conv, bn)
    assert second is not first
    assert torch.equal(second.weight.float(),
                       (first.weight.float() * 2))
    bn["moving_variance"].copy_(bn["moving_variance"] + 1)
    third = ep.prepare(conv, bn)
    assert third is not second and not torch.equal(third.scale, second.scale)
    bn["beta"] = bn["beta"] + 1
    fourth = ep.prepare(conv, bn)
    assert fourth is not third and not torch.equal(fourth.shift, third.shift)
    assert ep.prepare(conv, bn) is fourth

    monkeypatch.setattr(ep, "tracing", lambda: True)
    traced = ep.prepare(conv, bn)
    assert traced is not fourth and ep.prepare(conv, bn) is not traced
    monkeypatch.undo()
    assert ep.prepare(conv, bn) is fourth

    kernel = weakref.ref(conv["kernel"])
    del conv, bn, first, second, third, fourth, traced
    gc.collect()
    assert kernel() is None


def test_cpu_resnet_keeps_the_layers(monkeypatch):
    """On the CPU `apply_resnet` runs the layers and never the epilogue path
    (the parity tests against the JAX package stand on it), and the
    epilogue path, with its gate opened, gives the same C2-C5 bit for bit
    (the plain version, the prepared weights, the three forms)."""
    params, images = resnet_case()
    fused = resnet._bottleneck_epilogue

    def refuse(*a, **k):
        raise AssertionError("epilogue path taken on the CPU")

    monkeypatch.setattr(resnet, "_bottleneck_epilogue", refuse)
    cuda_lib.reset_launches()
    want = resnet.apply_resnet(params, images, "resnet50")
    assert not any(cuda_lib.launches.values())
    monkeypatch.setattr(resnet, "_bottleneck_epilogue", fused)
    monkeypatch.setattr(ep, "epilogue_supported", lambda x, dtype: True)
    got = resnet.apply_resnet(params, images, "resnet50")
    for g, w in zip(got, want):
        assert g.dtype == BF16 and torch.equal(g, w)
    # training and batch BN keep the layers with the gate open
    monkeypatch.setattr(resnet, "_bottleneck_epilogue", refuse)
    resnet.apply_resnet(params, images, "resnet50", inference=False)
    resnet.apply_resnet(params, images, "resnet50",
                        bn_ctx={"use_batch_stats": True})
