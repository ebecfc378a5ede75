"""The epilogue of a ResNet layer-path convolution in one pass: the conv's
bias, inference BatchNorm, the block's shortcut and ReLU over cuDNN's raw
bf16 NHWC output. The CUDA kernel `csrc/conv_epilogue.cu` and its plain
PyTorch version, which is the op sequence of the layers it finishes
(`nn.conv2d`'s bias add, `nn.batch_norm` with the stored statistics,
`nn.relu`, `models/resnet.py::_bottleneck`'s residual add), so the two are
equal bit for bit.

Replaces no TPU kernel: the JAX package leaves these layers to XLA, which
fuses them into the convolution. In the port they were some nine PyTorch
passes a conv, each reading and writing the whole activation. The work is
bound by bytes: the pass reads the conv's output (and the block input or
the shortcut conv's output) once and writes the result once, with each
thread's per-channel constants in registers (the source's note).

Three forms, from the block's structure:
  after 2a and 2b                 relu(bn(y + b))
  after 2c of an identity block   relu(bn(y + b) + x)
  after 2c of a projection block  relu(bn(y + b) + bn_s(s + b_s)), s the
                                  shortcut conv's raw output (the shortcut
                                  gets no pass of its own)
with `bn(t) = bf16(f32(t) * scale + shift)`, every sum rounded to bf16.

`prepare` builds a conv's constants (its bf16 weight in the layout cuDNN
takes for a channels-last input, the bf16 bias, BN's float32 scale and
shift) once per parameter set, on the parameters' device, with the
helpers `nn.conv2d` and `nn.batch_norm` run on every forward
(`nn.conv_weight`, `nn.bn_scale_shift`), so the bits are theirs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maskrcnn_tpu_torch.models import nn
from maskrcnn_tpu_torch.ops import cuda_lib
from maskrcnn_tpu_torch.ops.common import ParamCache, tracing


class LayerConstants(NamedTuple):
    """What one conv + BN layer of the path reads on every forward."""
    weight: torch.Tensor  # (O, I, kh, kw) bf16, channels_last
    bias: torch.Tensor    # (O,) bf16
    scale: torch.Tensor   # (O,) float32
    shift: torch.Tensor   # (O,) float32


def _build(conv: dict, bn: dict) -> LayerConstants:
    # detached rather than under no_grad: `torch.export` would wrap a
    # grad-mode region of the trace in a node its verifier refuses
    scale, shift = nn.bn_scale_shift({k: t.detach() for k, t in bn.items()})
    weight = nn.conv_weight(conv["kernel"].detach()).contiguous(
        memory_format=torch.channels_last)
    return LayerConstants(weight, conv["bias"].detach().to(torch.bfloat16),
                          scale, shift)


_prepared = ParamCache()


def prepare(conv: dict, bn: dict) -> LayerConstants:
    """The constants of `conv` (kernel HWIO, bias) and its BN layer, built
    once and kept while the kernel tensor lives. Built anew where one of
    the six tensors was replaced or changed in place (`Tensor._version`),
    and without the cache while torch traces (`ops/common.py::tracing`),
    so a trace's placeholders never reach an eager call."""
    if tracing():
        return _build(conv, bn)
    return _prepared.get((conv["kernel"], conv["bias"], bn["gamma"],
                          bn["beta"], bn["moving_mean"],
                          bn["moving_variance"]), lambda: _build(conv, bn))


def epilogue_plain(y: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, residual: torch.Tensor | None = None,
                   res_bias: torch.Tensor | None = None,
                   res_scale: torch.Tensor | None = None,
                   res_shift: torch.Tensor | None = None) -> torch.Tensor:
    """The layers' op sequence on a raw bf16 conv output `y` (NHWC).
    `residual` alone: the block input, added after BN; with `res_bias`,
    `res_scale`, `res_shift`: the shortcut conv's raw output, finished by
    its own bias and BN first."""

    def bias_bn(t, b, s, h):
        t = (t + b).to(torch.bfloat16)
        return (t.float() * s + h).to(torch.bfloat16)

    out = bias_bn(y, bias, scale, shift)
    if residual is not None:
        if res_bias is not None:
            residual = bias_bn(residual, res_bias, res_scale, res_shift)
        out = out + residual
    return torch.relu(out)


def epilogue_cuda(y, bias, scale, shift, residual=None, res_bias=None,
                  res_scale=None, res_shift=None) -> torch.Tensor:
    if y.dim() == 0 or y.shape[-1] % 8:
        raise ValueError(f"conv epilogue kernel needs channels % 8 == 0, "
                         f"got shape {tuple(y.shape)}")
    c = y.shape[-1]
    form = 0 if residual is None else 1 if res_bias is None else 2
    cuda_lib.require(y, "y", torch.bfloat16)
    if form:
        cuda_lib.require(residual, "residual", torch.bfloat16, y.shape)
    named = [("bias", bias, torch.bfloat16), ("scale", scale, torch.float32),
             ("shift", shift, torch.float32)]
    if form == 2:
        named += [("res_bias", res_bias, torch.bfloat16),
                  ("res_scale", res_scale, torch.float32),
                  ("res_shift", res_shift, torch.float32)]
    for name, t, dtype in named:
        cuda_lib.require(t, name, dtype, (c,))
    lib = cuda_lib.load()
    out = torch.empty_like(y)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(y.device):
        rc = lib.mrt_conv_epilogue(
            y.data_ptr(), ptr(residual), bias.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), ptr(res_bias), ptr(res_scale), ptr(res_shift),
            out.data_ptr(), y.numel() // c, c, form, cuda_lib.stream_ptr(y))
    cuda_lib.check(rc, "conv_epilogue")
    cuda_lib.launches["conv_epilogue"] += 1
    return out


@torch.library.custom_op("maskrcnn_tpu_torch::conv_epilogue",
                         mutates_args=(), device_types="cpu")
def _epilogue_op(y: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, residual: torch.Tensor | None,
                 res_bias: torch.Tensor | None,
                 res_scale: torch.Tensor | None,
                 res_shift: torch.Tensor | None) -> torch.Tensor:
    return epilogue_plain(y, bias, scale, shift, residual, res_bias,
                          res_scale, res_shift)


_epilogue_op.register_kernel("cuda")(epilogue_cuda)


@_epilogue_op.register_fake
def _(y, bias, scale, shift, residual, res_bias, res_scale, res_shift):
    return torch.empty_like(y)


def conv_epilogue(y: torch.Tensor, layer: LayerConstants,
                  residual: torch.Tensor | None = None,
                  shortcut: LayerConstants | None = None) -> torch.Tensor:
    """The op `maskrcnn_tpu_torch::conv_epilogue` on the raw conv output
    `y` of `layer`: the kernel on a CUDA tensor, the plain version on a
    CPU tensor. `residual` is the block input, or with `shortcut` (that
    conv's constants) the shortcut conv's raw output."""
    s = (None, None, None) if shortcut is None else shortcut[1:]
    return _epilogue_op(y, layer.bias, layer.scale, layer.shift, residual,
                        *s)


def epilogue_supported(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """The pass's gate: bf16 compute on the card (the caller adds the
    stored-BN inference condition, `models/resnet.py::apply_resnet`)."""
    return dtype == torch.bfloat16 and x.is_cuda
