"""The epilogue of a ViT or Swin block's linear in one pass: the dense
layer's bias, then GELU (after fc1), or the float32 residual add and the
LayerNorm that follows it (after proj and fc2), over the GEMM's raw bf16
output. The CUDA kernel `csrc/vit_epilogue.cu` and its plain PyTorch
version, which is the op sequence of the layers it finishes (`nn.dense`'s
bias add, `F.gelu`, `models/vit.py`'s and `models/swin.py`'s residual add
and `layer_norm`, `window_partition` and `window_unpartition`).

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
The last form takes the residual widths in WIDTHS on the card (Swin-S's
four stages; ViT-B's 768), and maps layouts as it goes: with `window` > 0
one side lies in padded windows of that side (`window_partition`'s layout,
rolled by Swin's `window_shift`), y (read in a windowed block's windows,
x' written in the grid, the padding dropped) or, with `norm_windowed`,
LN(x') (written into the next block's padded windows, the pad rows zero).
On the card the bias, GELU and x' equal the layers bit for bit, LN(x')
within one bf16 ulp (its statistics summed in another order than
PyTorch's kernel).

`prepare` builds a dense layer's bf16 kernel and bias once per parameter
set, with the casts `nn.dense` runs on every forward, so the bits are
theirs; `prepare_norm` a LayerNorm's scale and shift as float32 tensors of
their own, which the kernel's 16-byte loads may read whatever the offset
of the parameters' storage.
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
# the residual stream's widths the kernel's LayerNorm form is built for:
# 24 channels a lane, 4, 8, 16 or 32 lanes a row
WIDTHS = (96, 192, 384, 768)


class DenseConstants(NamedTuple):
    """What one dense layer of a block reads on every forward."""
    kernel: torch.Tensor  # (in, out) bf16
    bias: torch.Tensor    # (out,) bf16


class NormConstants(NamedTuple):
    """A LayerNorm's scale and shift as the pass reads them."""
    scale: torch.Tensor   # (C,) float32, contiguous, storage of its own
    shift: torch.Tensor   # (C,) float32


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


def _build_norm(norm: dict) -> NormConstants:
    return NormConstants(
        norm["scale"].detach().to(torch.float32, copy=True).contiguous(),
        norm["bias"].detach().to(torch.float32, copy=True).contiguous())


def prepare_norm(norm: dict) -> NormConstants:
    """A LayerNorm's {"scale", "bias"} as float32 copies, built once per
    parameter set as `prepare` builds a dense layer's: a fresh tensor
    starts on a 16-byte boundary, where a view into a larger buffer (the
    benchmark's weights) may not."""
    if tracing():
        return _build_norm(norm)
    return _prepared.get((norm["scale"], norm["bias"]),
                         lambda: _build_norm(norm))


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
                   norm_windowed: bool = False, eps: float = 1e-6,
                   window_shift: int = 0) -> list:
    """The layers' op sequence on a raw bf16 matmul output `y`: [out] for
    BIAS and BIAS_GELU; [x'] or, with `scale` and `shift`, [x', LN(x')]
    for BIAS_RESIDUAL_NORM (`x` the float32 stream (B, H, W, C)); the
    windowed side at `window_shift` (`window_partition`'s `shift`)."""
    t = y + bias
    if form == BIAS:
        return [t]
    if form == BIAS_GELU:
        return [F.gelu(t)]
    if window and not norm_windowed:
        hw = x.shape[1:3]
        nh, nw = _windows(hw, window)
        t = window_unpartition(t, window, (nh * window, nw * window), hw,
                               window_shift)
    x = x + t.float()
    if scale is None:
        return [x]
    n = F.layer_norm(x, (x.shape[-1],), scale, shift, eps)
    if window and norm_windowed:
        n, _ = window_partition(n, window, window_shift)
    return [x, n.to(torch.bfloat16)]


def epilogue_cuda(y, bias, form, x=None, scale=None, shift=None, window=0,
                  norm_windowed=False, eps=1e-6, window_shift=0) -> list:
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
    if c not in WIDTHS:
        raise ValueError(f"vit epilogue kernel takes a residual width of "
                         f"{', '.join(map(str, WIDTHS[:-1]))} or "
                         f"{WIDTHS[-1]}, got {c}")
    if window and not 0 <= window_shift < window:
        raise ValueError(f"vit epilogue: a window shift in [0, {window}), "
                         f"got {window_shift}")
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
            window, window_shift, int(norm_windowed), eps, stream)
    cuda_lib.check(rc, "vit_epilogue")
    cuda_lib.launches["vit_epilogue"] += 1
    return outs


@torch.library.custom_op("maskrcnn_tpu_torch::vit_epilogue",
                         mutates_args=(), device_types="cpu")
def _epilogue_op(y: torch.Tensor, bias: torch.Tensor, form: int,
                 x: Optional[torch.Tensor], scale: Optional[torch.Tensor],
                 shift: Optional[torch.Tensor], window: int,
                 norm_windowed: bool, eps: float,
                 window_shift: int) -> list[torch.Tensor]:
    return epilogue_plain(y, bias, form, x, scale, shift, window,
                          norm_windowed, eps, window_shift)


_epilogue_op.register_kernel("cuda")(epilogue_cuda)


@_epilogue_op.register_fake
def _(y, bias, form, x, scale, shift, window, norm_windowed, eps,
      window_shift):
    shapes = _out_shapes(y, x, form, scale is not None, window,
                         norm_windowed)
    if form != BIAS_RESIDUAL_NORM:
        return [torch.empty_like(y)]
    return [y.new_empty(s, dtype=d)
            for s, d in zip(shapes, (torch.float32, torch.bfloat16))]


def bias(y: torch.Tensor, dense: DenseConstants) -> torch.Tensor:
    """After qkv: bf16(y + b)."""
    return _epilogue_op(y, dense.bias, BIAS, None, None, None, 0, False,
                        0.0, 0)[0]


def bias_gelu(y: torch.Tensor, dense: DenseConstants) -> torch.Tensor:
    """After fc1: gelu(bf16(y + b)) in bf16."""
    return _epilogue_op(y, dense.bias, BIAS_GELU, None, None, None, 0, False,
                        0.0, 0)[0]


def bias_residual_norm(y: torch.Tensor, dense: DenseConstants,
                       x: torch.Tensor, norm: dict | None = None,
                       eps: float = 1e-6, window: int = 0,
                       norm_windowed: bool = False, shift: int = 0):
    """After proj or fc2: (x', LN(x') in bf16), or (x', None) without a
    LayerNorm (`norm`: its {"scale", "bias"}, `prepare_norm`'s copies
    passed). `window`: the side of the padded windows y is read from, or
    with `norm_windowed` LN(x') is written to, those windows rolled by
    (-shift, -shift) (Swin's shifted windows); 0: both lie in the grid,
    whatever `norm_windowed` and `shift`."""
    scale = beta = None
    if norm is not None:
        scale, beta = prepare_norm(norm)
    outs = _epilogue_op(y, dense.bias, BIAS_RESIDUAL_NORM, x, scale, beta,
                        window, norm_windowed, eps, shift if window else 0)
    return outs[0], (outs[1] if norm is not None else None)


def epilogue_supported(x: torch.Tensor, dtype: torch.dtype,
                       width: int) -> bool:
    """The pass's gate: bf16 compute on the card, and a residual stream of
    a width the LayerNorm form is built for (WIDTHS). The ViT and Swin
    backbones run at inference only."""
    return dtype == torch.bfloat16 and x.is_cuda and width in WIDTHS
