"""ResNet-50/101 backbone (Matterport topology and layer names), port of
`maskrcnn_tpu/models/resnet.py`.

  conv1 7x7/2 (pad 3) -> bn_conv1 -> relu -> maxpool 3x3/2 SAME      = C1
  stage 2: conv_block [64,64,256]/1   + 2 identity blocks            = C2
  stage 3: conv_block [128,128,512]/2 + 3 identity blocks            = C3
  stage 4: conv_block [256,256,1024]/2 + {5 | 22} identity blocks    = C4
  stage 5: conv_block [512,512,2048]/2 + 2 identity blocks           = C5

On the card with bf16 compute and the stored BN statistics the stem runs
as kernel K3 and the chains res2 a-c and res3 b-d as kernel K4, under the
gates of the JAX package (`stem_supported` / `chain_supported`, device test
`is_cuda`). Everything else runs layer by layer (`models/nn.py`).

Training (`inference=False`) takes the kernels only with frozen BN
(`bn_ctx` None) and `train_fused_kernels`, and then only through their
autograd Functions (`stem_cuda.StemFusedDiff`,
`bottleneck_cuda.ChainFusedDiff`: kernel forward, layer-graph backward);
a raw kernel launch would cut the graph. Batch statistics cannot fold into
conv weights, so batch-BN training runs the layers.
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.models import nn
from maskrcnn_tpu_torch.ops import bottleneck_cuda, stem_cuda

_BLOCK_COUNTS = {"resnet50": 5, "resnet101": 22}

# (stage, first block) -> letters of the fused stride-1 chain
FUSED_CHAINS = {(2, "a"): "abc", (3, "b"): "bcd"}


def _stage_blocks(architecture: str):
    """Yield (stage, block_letter, is_conv_block, filters, stride) specs."""
    n4 = _BLOCK_COUNTS[architecture]
    spec = [(2, [64, 64, 256], 1, 2), (3, [128, 128, 512], 2, 3),
            (4, [256, 256, 1024], 2, n4), (5, [512, 512, 2048], 2, 2)]
    for stage, filters, stride, n_identity in spec:
        yield stage, "a", True, filters, stride
        for i in range(n_identity):
            yield stage, chr(ord("b") + i), False, filters, 1


def init_resnet(gen: torch.Generator,
                architecture: str = "resnet101") -> nn.Params:
    """Random init as in the JAX package: conv1 kernel scaled by 1/128 (the
    inputs are mean-subtracted, not std-normalized) and zero gamma on each
    block's last BN (every block starts as identity)."""
    params: nn.Params = {}
    params["conv1"] = nn.conv_init(gen, 7, 7, 3, 64)
    params["conv1"]["kernel"] = params["conv1"]["kernel"] / 128.0
    params["bn_conv1"] = nn.bn_init(64)
    cin = 64
    for stage, block, is_conv, filters, _ in _stage_blocks(architecture):
        f1, f2, f3 = filters
        base = f"res{stage}{block}_branch"
        bnb = f"bn{stage}{block}_branch"
        params[base + "2a"] = nn.conv_init(gen, 1, 1, cin, f1)
        params[bnb + "2a"] = nn.bn_init(f1)
        params[base + "2b"] = nn.conv_init(gen, 3, 3, f1, f2)
        params[bnb + "2b"] = nn.bn_init(f2)
        params[base + "2c"] = nn.conv_init(gen, 1, 1, f2, f3)
        params[bnb + "2c"] = nn.bn_init(f3)
        params[bnb + "2c"]["gamma"] = torch.zeros(f3)
        if is_conv:
            params[base + "1"] = nn.conv_init(gen, 1, 1, cin, f3)
            params[bnb + "1"] = nn.bn_init(f3)
        cin = f3
    return params


def _bottleneck(x, params, stage, block, is_conv, stride, dtype,
                bn_ctx=None):
    base = f"res{stage}{block}_branch"
    bnb = f"bn{stage}{block}_branch"
    y = nn.conv2d(x, params[base + "2a"], stride=stride, padding="VALID",
                  dtype=dtype)
    y = nn.relu(nn.bn_apply(y, params, bnb + "2a", bn_ctx))
    y = nn.conv2d(y, params[base + "2b"], padding="SAME", dtype=dtype)
    y = nn.relu(nn.bn_apply(y, params, bnb + "2b", bn_ctx))
    y = nn.conv2d(y, params[base + "2c"], padding="VALID", dtype=dtype)
    y = nn.bn_apply(y, params, bnb + "2c", bn_ctx)
    if is_conv:
        sc = nn.conv2d(x, params[base + "1"], stride=stride,
                       padding="VALID", dtype=dtype)
        sc = nn.bn_apply(sc, params, bnb + "1", bn_ctx)
    else:
        sc = x
    return nn.relu(y + sc)


def _stem_layers(params, images, dtype, bn_ctx=None):
    """ZeroPadding2D(3) + 7x7/2 valid conv + BN + ReLU + 3x3/2 SAME maxpool."""
    x = nn.conv2d(images.to(dtype), params["conv1"], stride=2,
                  padding=[(3, 3), (3, 3)], dtype=dtype)
    x = nn.relu(nn.bn_apply(x, params, "bn_conv1", bn_ctx))
    return nn.max_pool(x, 3, 2, padding="SAME")


_chain_keys = bottleneck_cuda.chain_keys


def _kernel_chain(params, stage, letters, x, dtype):
    """The chain folded for K4 where the kernel takes it (bf16 on the
    card, shapes every block takes), else None."""
    if not (x.is_cuda and dtype == torch.bfloat16):
        return None
    with torch.no_grad():
        blocks = bottleneck_cuda.fold_bottleneck_chain(params, stage, letters)
    return (blocks if bottleneck_cuda.chain_supported(x, dtype, blocks)
            else None)


def apply_resnet(params, images: torch.Tensor,
                 architecture: str = "resnet101", dtype=torch.bfloat16,
                 bn_ctx=None, inference: bool = True,
                 train_fused_kernels: bool = False):
    """(B, H, W, 3) preprocessed images -> C2, C3, C4, C5 (NHWC).

    `bn_ctx` (`nn.bn_apply`) None uses the stored BN statistics. The
    kernels engage where their folded-BN math is exact (bf16, `bn_ctx`
    None, on the card) and, with `inference=False`, only when
    `train_fused_kernels` is set, through their autograd Functions."""
    kernels = bn_ctx is None and (inference or train_fused_kernels)
    if kernels and stem_cuda.stem_supported(images, dtype):
        x = (stem_cuda.apply_stem(params, images) if inference
             else stem_cuda.stem_fused_diff(params, images))
    else:
        x = _stem_layers(params, images, dtype, bn_ctx)

    feats = {}
    skip = set()
    for stage, block, is_conv, _, stride in _stage_blocks(architecture):
        if (stage, block) in skip:
            continue
        letters = FUSED_CHAINS.get((stage, block))
        blocks = (_kernel_chain(params, stage, letters, x, dtype)
                  if letters and kernels else None)
        if blocks:
            x = (bottleneck_cuda.fused_bottleneck_chain(x, blocks)
                 if inference else bottleneck_cuda.chain_fused_diff(
                     params, stage, letters, x, blocks))
            skip.update((stage, letter) for letter in letters)
        else:
            x = _bottleneck(x, params, stage, block, is_conv, stride, dtype,
                            bn_ctx)
        feats[stage] = x
    return feats[2], feats[3], feats[4], feats[5]
