"""Fused chains of stride-1 ResNet bottleneck blocks (1x1 -> 3x3 SAME -> 1x1,
BN folded, identity or projection residual, ReLU). The CUDA kernel K4
(`csrc/bottleneck.cu`) and its plain PyTorch version. Replaces
`maskrcnn_tpu/ops/bottleneck_pallas.py::fused_bottleneck_chain`.

Contract (both versions, the TPU kernel's): (B, H, W, Cin) input and the
folded chain from `fold_bottleneck_chain` in, the chain's (B, H, W, Cout)
bf16 output out. Per block: t1 = relu(x @ w1 + b1) rounded to bf16 and
zero outside the image (the 3x3's SAME padding), t2 = relu(conv3x3(t1) +
b2) rounded to bf16, out = relu((t2 @ w3 + b3) + shortcut) rounded to
bf16, shortcut = x @ ws + bs for a projection block, else x; products of
bf16 values, float32 sums.

The kernel is launched once per block, so between two blocks of a chain
the block output makes one round trip through device memory (the TPU
kernel kept the whole chain on chip).

`ChainFusedDiff` runs the kernel under autograd (frozen-BN training with
`train_fused_kernels`, the JAX package's `_chain_fused_diff`): the kernel
forward, and for the backward the gradient of the blocks' layer graph
(`models/resnet.py::_bottleneck` in bf16 with the stored BN statistics),
recomputed: there is no backward kernel, on the TPU either.
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.ops import cuda_lib
from maskrcnn_tpu_torch.ops.common import graph_vjp

_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "ws", "bs")


def fold_bottleneck_chain(params: dict, stage: int, letters: str,
                          eps: float = 1e-3) -> list[dict]:
    """Fold conv+BN of blocks `letters` of `stage` into matmul weights:
    per block w1 (Cin, M) / b1 (M,) / w2 (9, M, M) [tap dy*3+dx] / b2 /
    w3 (M, Cout) / b3, plus ws (Cin, Cout) / bs for a projection block.
    Weights bf16, biases float32."""

    def fold(conv, bn):
        k = conv["kernel"].to(torch.float32)
        scale = bn["gamma"].float() * torch.rsqrt(
            bn["moving_variance"].float() + eps)
        shift = bn["beta"].float() - bn["moving_mean"].float() * scale
        w = (k * scale).to(torch.bfloat16)
        return w, conv["bias"].float() * scale + shift

    blocks = []
    for letter in letters:
        base = f"res{stage}{letter}_branch"
        bnb = f"bn{stage}{letter}_branch"
        w1, b1 = fold(params[base + "2a"], params[bnb + "2a"])
        w2, b2 = fold(params[base + "2b"], params[bnb + "2b"])
        w3, b3 = fold(params[base + "2c"], params[bnb + "2c"])
        blk = {"w1": w1.reshape(w1.shape[2], w1.shape[3]), "b1": b1,
               "w2": w2.reshape(9, w2.shape[2], w2.shape[3]), "b2": b2,
               "w3": w3.reshape(w3.shape[2], w3.shape[3]), "b3": b3}
        if base + "1" in params:
            ws, bs = fold(params[base + "1"], params[bnb + "1"])
            blk["ws"] = ws.reshape(ws.shape[2], ws.shape[3])
            blk["bs"] = bs
        blocks.append({k: v.contiguous() for k, v in blk.items()})
    return blocks


def _block_plain(x: torch.Tensor, blk: dict) -> torch.Tensor:
    b, h, w, _ = x.shape
    f = torch.float32
    xf = x.to(torch.bfloat16).to(f)
    t1 = torch.relu(xf @ blk["w1"].to(f) + blk["b1"]).to(torch.bfloat16)
    m = t1.shape[-1]
    # SAME 3x3 as one im2col matmul: zero padding = t1 zero outside image.
    tp = torch.nn.functional.pad(t1.to(f), (0, 0, 1, 1, 1, 1))
    patches = torch.cat([tp[:, dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)], dim=-1)
    t2 = torch.relu(patches @ blk["w2"].to(f).reshape(9 * m, m)
                    + blk["b2"]).to(torch.bfloat16)
    t3 = t2.to(f) @ blk["w3"].to(f) + blk["b3"]
    short = xf @ blk["ws"].to(f) + blk["bs"] if "ws" in blk else xf
    return torch.relu(t3 + short).to(torch.bfloat16)


def chain_plain(x: torch.Tensor, blocks: list[dict]) -> torch.Tensor:
    for blk in blocks:
        x = _block_plain(x, blk)
    return x


def block_supported(x_shape, blk: dict) -> bool:
    """Shapes the kernel takes: any H and W (it masks the edge tiles),
    Cin and Cout % 64, mid width 64 or 128."""
    _, h, w, cin = x_shape
    m = blk["w1"].shape[1]
    cout = blk["w3"].shape[1]
    return (h > 0 and w > 0 and cin % 64 == 0 and cout % 64 == 0
            and m in (64, 128) and ("ws" in blk or cin == cout))


def _block_cuda(x: torch.Tensor, blk: dict) -> torch.Tensor:
    b, h, w, cin = x.shape
    m, cout = blk["w1"].shape[1], blk["w3"].shape[1]
    if not block_supported(x.shape, blk):
        raise ValueError(f"bottleneck kernel does not take input "
                         f"{tuple(x.shape)} with mid {m}, out {cout}")
    proj = "ws" in blk
    cuda_lib.require(x, "x", torch.bfloat16, (b, h, w, cin))
    shapes = {"w1": (cin, m), "b1": (m,), "w2": (9, m, m), "b2": (m,),
              "w3": (m, cout), "b3": (cout,), "ws": (cin, cout),
              "bs": (cout,)}
    for k in _KEYS[:6] + (_KEYS[6:] if proj else ()):
        cuda_lib.require(blk[k], k, torch.bfloat16 if k[0] == "w"
                         else torch.float32, shapes[k])
    lib = cuda_lib.load()
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=x.device)
    ptrs = [blk[k].data_ptr() if k in blk else None for k in _KEYS]
    with torch.cuda.device(x.device):
        rc = lib.mrt_bottleneck(x.data_ptr(), *ptrs, out.data_ptr(), b, h,
                                w, cin, m, cout, int(proj),
                                cuda_lib.stream_ptr(x))
    cuda_lib.check(rc, "bottleneck")
    cuda_lib.launches["bottleneck"] += 1
    return out


def chain_cuda(x: torch.Tensor, blocks: list[dict]) -> torch.Tensor:
    x = x.to(torch.bfloat16).contiguous()
    for blk in blocks:
        x = _block_cuda(x, blk)
    return x


def fused_bottleneck_chain(x: torch.Tensor,
                           blocks: list[dict]) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if x.is_cuda:
        return chain_cuda(x, blocks)
    return chain_plain(x, blocks)


def chain_supported(x: torch.Tensor, dtype: torch.dtype,
                    blocks: list[dict]) -> bool:
    """The kernel's gate (as `bottleneck_pallas.chain_supported`): bf16 on
    the card, and shapes every block of the chain takes (the caller adds
    the stored-BN condition, `models/resnet.py::apply_resnet`)."""
    if dtype != torch.bfloat16 or not x.is_cuda:
        return False
    shape = tuple(x.shape)
    for blk in blocks:
        if not block_supported(shape, blk):
            return False
        shape = shape[:3] + (blk["w3"].shape[1],)
    return True


def chain_keys(stage: int, letters: str) -> list[str]:
    """The layers of blocks `letters` of `stage`, block by block: each
    branch's conv, then its BN (the JAX package's `_chain_keys`)."""
    keys = []
    for letter in letters:
        for branch in ("2a", "2b", "2c") + (("1",) if letter == "a" else ()):
            keys += [f"res{stage}{letter}_branch{branch}",
                     f"bn{stage}{letter}_branch{branch}"]
    return keys


def _chain_tensors(params: dict, stage: int, letters: str):
    """(layer, weight) names and tensors of `chain_keys`, in that order,
    each layer's weights in the params' own order."""
    names = [(k, w) for k in chain_keys(stage, letters) for w in params[k]]
    return names, [params[k][w] for k, w in names]


class ChainFusedDiff(torch.autograd.Function):
    """K4 under autograd: forward `fused_bottleneck_chain` of the folded
    `blocks` (the kernel on a CUDA tensor, its plain version on a CPU one),
    backward the vjp of the `_bottleneck` layers over `letters`. Takes
    (stage, letters, names, blocks, x, *tensors): `names` the (layer,
    weight) of each tensor, `blocks` the chain folded from them."""

    @staticmethod
    def forward(ctx, stage, letters, names, blocks, x, *flat):
        ctx.stage, ctx.letters, ctx.names = stage, letters, names
        ctx.save_for_backward(x, *flat)
        return fused_bottleneck_chain(x, blocks)

    @staticmethod
    def backward(ctx, grad):
        from maskrcnn_tpu_torch.models.resnet import _bottleneck

        def graph(x, *flat):
            params: dict = {}
            for (layer, w), t in zip(ctx.names, flat):
                params.setdefault(layer, {})[w] = t
            for letter in ctx.letters:
                x = _bottleneck(x, params, ctx.stage, letter, letter == "a",
                                1, torch.bfloat16)
            return x

        grads = graph_vjp(graph, ctx.saved_tensors, ctx.needs_input_grad[4:],
                          grad.to(torch.bfloat16))
        return (None, None, None, None, *grads)


def chain_fused_diff(params: dict, stage: int, letters: str, x: torch.Tensor,
                     blocks: list[dict] | None = None) -> torch.Tensor:
    """Blocks `letters` of `stage` through `ChainFusedDiff`; `blocks` is
    the chain folded from `params` (folded here when not given)."""
    if blocks is None:
        with torch.no_grad():
            blocks = fold_bottleneck_chain(params, stage, letters)
    names, flat = _chain_tensors(params, stage, letters)
    return ChainFusedDiff.apply(stage, letters, names, blocks, x, *flat)
