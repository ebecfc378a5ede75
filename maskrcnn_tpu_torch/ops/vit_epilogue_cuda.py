"""The epilogue of a ViT block's linear in one pass: the dense layer's bias,
then GELU (after fc1), or the float32 residual add and the LayerNorm that
follows it (after proj and fc2), over the GEMM's raw bf16 output. The CUDA
kernel `csrc/vit_epilogue.cu` and its plain PyTorch version, which is the
op sequence of the layers it finishes (`nn.dense`'s bias add, `F.gelu`,
`models/vit.py`'s residual add and `layer_norm`, `window_partition` and
`window_unpartition`).

Replaces no TPU kernel: the JAX package leaves these layers to XLA, which
fuses them into the matmuls. In the port they were some fourteen PyTorch
passes a block, each reading and writing a whole activation. The work is
bound by bytes: the pass reads the GEMM's output (and the residual stream)
once and writes what the next GEMM or the stream needs once (the source's
note).

Three forms, `y` the matmul's bf16 output and `b` the bias in bf16:
  BIAS                after qkv     bf16(y + b)
  BIAS_GELU           after fc1     gelu(bf16(y + b)), rounded to bf16
  BIAS_RESIDUAL_NORM  after proj    x' = x + f32(bf16(y + b)), float32;
                      and fc2       and, with a LayerNorm's scale and
                                    shift, LN(x') rounded to bf16
The last form takes ViT-B's residual width, WIDTH = 768, on the card, and
maps layouts as it goes: with `window` > 0 one side lies in padded windows
of that side (`window_partition`'s layout), y (read in a windowed block's
windows, x' written in the grid, the padding dropped) or, with
`norm_windowed`, LN(x') (written into the next block's padded windows,
the pad rows zero). On the card the bias, GELU and x' equal the layers bit
for bit, LN(x') within one bf16 ulp (its statistics summed in another
order than PyTorch's kernel).

`prepare` builds a dense layer's bf16 kernel and bias once per parameter
set, with the casts `nn.dense` runs on every forward, so the bits are
theirs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.ops import cuda_lib
from maskrcnn_tpu_torch.ops.common import (ParamCache, tracing,
                                           window_partition,
                                           window_unpartition)

BIAS, BIAS_GELU, BIAS_RESIDUAL_NORM = 0, 1, 2
# the residual stream's width the kernel's LayerNorm form is built for
WIDTH = 768


class DenseConstants(NamedTuple):
    """What one dense layer of a block reads on every forward."""
    kernel: torch.Tensor  # (in, out) bf16
    bias: torch.Tensor    # (out,) bf16


def _build(dense: dict) -> DenseConstants:
    # detached rather than under no_grad, as `conv_epilogue_cuda._build`
    return DenseConstants(dense["kernel"].detach().to(torch.bfloat16),
                          dense["bias"].detach().to(torch.bfloat16))


_prepared = ParamCache()


def prepare(dense: dict) -> DenseConstants:
    """The constants of a dense layer (kernel (in, out), bias), built once
    and kept while the kernel tensor lives. Built anew where either tensor
    was replaced or changed in place (`Tensor._version`), and without the
    cache while torch traces (`ops/common.py::tracing`)."""
    if tracing():
        return _build(dense)
    return _prepared.get((dense["kernel"], dense["bias"]),
                         lambda: _build(dense))


def _windows(grid: tuple, window: int) -> tuple[int, int]:
    """Windows down and across a (h, w) grid padded to the window."""
    return -(-grid[0] // window), -(-grid[1] // window)


def _out_shapes(y, x, form, with_norm, window, norm_windowed):
    """The shapes of the op's outputs."""
    if form != BIAS_RESIDUAL_NORM:
        return [y.shape]
    shapes = [x.shape]
    if with_norm:
        b, h, w, c = x.shape
        if window and norm_windowed:
            nh, nw = _windows((h, w), window)
            shapes.append((b * nh * nw, window, window, c))
        else:
            shapes.append(x.shape)
    return shapes


def epilogue_plain(y: torch.Tensor, bias: torch.Tensor, form: int,
                   x: torch.Tensor | None = None,
                   scale: torch.Tensor | None = None,
                   shift: torch.Tensor | None = None, window: int = 0,
                   norm_windowed: bool = False, eps: float = 1e-6) -> list:
    """The layers' op sequence on a raw bf16 matmul output `y`: [out] for
    BIAS and BIAS_GELU; [x'] or, with `scale` and `shift`, [x', LN(x')]
    for BIAS_RESIDUAL_NORM (`x` the float32 stream (B, H, W, C))."""
    t = y + bias
    if form == BIAS:
        return [t]
    if form == BIAS_GELU:
        return [F.gelu(t)]
    if window and not norm_windowed:
        hw = x.shape[1:3]
        nh, nw = _windows(hw, window)
        t = window_unpartition(t, window, (nh * window, nw * window), hw)
    x = x + t.float()
    if scale is None:
        return [x]
    n = F.layer_norm(x, (x.shape[-1],), scale, shift, eps)
    if window and norm_windowed:
        n, _ = window_partition(n, window)
    return [x, n.to(torch.bfloat16)]


def epilogue_cuda(y, bias, form, x=None, scale=None, shift=None, window=0,
                  norm_windowed=False, eps=1e-6) -> list:
    c = y.shape[-1] if y.dim() else 0
    cuda_lib.require(y, "y", torch.bfloat16)
    cuda_lib.require(bias, "bias", torch.bfloat16, (c,))
    lib = cuda_lib.load()
    stream = cuda_lib.stream_ptr(y)
    if form in (BIAS, BIAS_GELU):
        if c % 8:
            raise ValueError(f"vit epilogue kernel needs channels % 8 == 0, "
                             f"got shape {tuple(y.shape)}")
        out = torch.empty_like(y)
        with torch.cuda.device(y.device):
            rc = lib.mrt_vit_epilogue(y.data_ptr(), bias.data_ptr(),
                                      out.data_ptr(), y.numel() // c, c,
                                      int(form == BIAS_GELU), stream)
        cuda_lib.check(rc, "vit_epilogue")
        cuda_lib.launches["vit_epilogue"] += 1
        return [out]
    if form != BIAS_RESIDUAL_NORM:
        raise ValueError(f"vit epilogue: unknown form {form}")
    if c != WIDTH:
        raise ValueError(f"vit epilogue kernel takes a residual width of "
                         f"{WIDTH}, got {c}")
    if x is None or x.dim() != 4:
        raise ValueError("vit epilogue: the residual form needs the "
                         "float32 stream x (B, H, W, C)")
    cuda_lib.require(x, "x", torch.float32, (*x.shape[:3], c))
    with_norm = scale is not None
    if with_norm:
        cuda_lib.require(scale, "scale", torch.float32, (c,))
        cuda_lib.require(shift, "shift", torch.float32, (c,))
    norm_windowed = bool(window and norm_windowed)
    if norm_windowed and not with_norm:
        raise ValueError("vit epilogue: a windowed LayerNorm output needs "
                         "the LayerNorm")
    b, h, w, _ = x.shape
    if window and not norm_windowed:
        nh, nw = _windows((h, w), window)
        cuda_lib.require(y, "y", torch.bfloat16,
                         (b * nh * nw, window, window, c))
    else:
        cuda_lib.require(y, "y", torch.bfloat16, x.shape)
    shapes = _out_shapes(y, x, form, with_norm, window, norm_windowed)
    x_out = torch.empty(shapes[0], dtype=torch.float32, device=y.device)
    outs = [x_out]
    if with_norm:
        outs.append(torch.empty(shapes[1], dtype=torch.bfloat16,
                                device=y.device))
    with torch.cuda.device(y.device):
        rc = lib.mrt_vit_epilogue_norm(
            y.data_ptr(), bias.data_ptr(), x.data_ptr(),
            scale.data_ptr() if with_norm else None,
            shift.data_ptr() if with_norm else None, x_out.data_ptr(),
            outs[1].data_ptr() if with_norm else None, b, h, w, c,
            window, int(norm_windowed), eps, stream)
    cuda_lib.check(rc, "vit_epilogue")
    cuda_lib.launches["vit_epilogue"] += 1
    return outs


@torch.library.custom_op("maskrcnn_tpu_torch::vit_epilogue",
                         mutates_args=(), device_types="cpu")
def _epilogue_op(y: torch.Tensor, bias: torch.Tensor, form: int,
                 x: Optional[torch.Tensor], scale: Optional[torch.Tensor],
                 shift: Optional[torch.Tensor], window: int,
                 norm_windowed: bool, eps: float) -> list[torch.Tensor]:
    return epilogue_plain(y, bias, form, x, scale, shift, window,
                          norm_windowed, eps)


_epilogue_op.register_kernel("cuda")(epilogue_cuda)


@_epilogue_op.register_fake
def _(y, bias, form, x, scale, shift, window, norm_windowed, eps):
    shapes = _out_shapes(y, x, form, scale is not None, window,
                         norm_windowed)
    if form != BIAS_RESIDUAL_NORM:
        return [torch.empty_like(y)]
    return [y.new_empty(s, dtype=d)
            for s, d in zip(shapes, (torch.float32, torch.bfloat16))]


def bias(y: torch.Tensor, dense: DenseConstants) -> torch.Tensor:
    """After qkv: bf16(y + b)."""
    return _epilogue_op(y, dense.bias, BIAS, None, None, None, 0, False,
                        0.0)[0]


def bias_gelu(y: torch.Tensor, dense: DenseConstants) -> torch.Tensor:
    """After fc1: gelu(bf16(y + b)) in bf16."""
    return _epilogue_op(y, dense.bias, BIAS_GELU, None, None, None, 0, False,
                        0.0)[0]


def bias_residual_norm(y: torch.Tensor, dense: DenseConstants,
                       x: torch.Tensor, norm: dict | None = None,
                       eps: float = 1e-6, window: int = 0,
                       norm_windowed: bool = False):
    """After proj or fc2: (x', LN(x') in bf16), or (x', None) without a
    LayerNorm (`norm`: its {"scale", "bias"}). `window`: the side of the
    padded windows y is read from, or with `norm_windowed` LN(x') is
    written to; 0: both lie in the grid, whatever `norm_windowed`."""
    scale = shift = None
    if norm is not None:
        scale = norm["scale"].detach().float()
        shift = norm["bias"].detach().float()
    outs = _epilogue_op(y, dense.bias, BIAS_RESIDUAL_NORM, x, scale, shift,
                        window, norm_windowed, eps)
    return outs[0], (outs[1] if norm is not None else None)


def epilogue_supported(x: torch.Tensor, dtype: torch.dtype,
                       width: int) -> bool:
    """The pass's gate: bf16 compute on the card, and a residual stream of
    the width the LayerNorm form is built for (WIDTH, ViT-B's). The ViT
    runs at inference only."""
    return dtype == torch.bfloat16 and x.is_cuda and width == WIDTH
