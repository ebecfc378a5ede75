"""The plain versions of the port's stem (K3) and bottleneck-chain (K4)
kernels against the JAX package's Pallas kernels run in interpret mode, and
against the nn-layer oracles, on the CPU.

Inputs are numpy arrays from a seed, fed to both; BN statistics are drawn
from the seed too, so every residual branch is live (random init zeroes
each block's last BN gamma, which would hide a wrong branch)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from maskrcnn_tpu.models import nn as jax_nn
from maskrcnn_tpu.models.resnet import _bottleneck as jax_bottleneck
from maskrcnn_tpu.ops import stem_pallas
from maskrcnn_tpu.ops.bottleneck_pallas import (
    fold_bottleneck_chain as jax_fold_chain, fused_bottleneck_chain)
from maskrcnn_tpu_torch.io.weights import params_from_numpy
from maskrcnn_tpu_torch.models import resnet as pt_resnet
from maskrcnn_tpu_torch.ops import bottleneck_cuda, stem_cuda
from tests.test_torch_gpu import stage_params, stem_params


def jax_tree(params):
    return {k: {w: jnp.asarray(v) for w, v in d.items()}
            for k, d in params.items()}


@pytest.mark.parametrize("shape", [(1, 64, 96, 3)])
def test_stem_plain_matches_pallas_and_oracle(shape):
    rng = np.random.default_rng(0)
    params = stem_params(rng)
    images = rng.uniform(-124, 132, shape).astype(np.float32)
    jp = jax_tree(params)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(stem_pallas.apply_stem_pallas(
            jp, jnp.asarray(images)), np.float32)
    # the nn-layer oracle of tests/test_stem_pallas.py
    x = jnp.asarray(images).astype(jnp.bfloat16)
    x = jax_nn.conv2d(x, jp["conv1"], stride=2, padding=[(3, 3), (3, 3)],
                      dtype=jnp.bfloat16)
    x = jax_nn.relu(jax_nn.bn_apply(x, jp, "bn_conv1", None))
    oracle = np.asarray(jax_nn.max_pool(x, 3, 2, padding="SAME"), np.float32)

    got = stem_cuda.apply_stem(params_from_numpy(params),
                               torch.from_numpy(images))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == kernel.shape == (1, 16, 24, 64)
    # bf16 rounding at other points (the oracle rounds the conv output
    # before BN, the kernels fold BN into bf16 weights): the tolerance of
    # tests/test_stem_pallas.py, relative to the activation scale
    for want in (kernel, oracle):
        scale = max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=0.04 * scale)
    # against the TPU kernel itself (same folding, same roundings): tighter
    np.testing.assert_allclose(got, kernel, rtol=0,
                               atol=0.01 * max(1.0, np.abs(kernel).max()))


def test_stem_fold_matches_jax():
    rng = np.random.default_rng(1)
    params = stem_params(rng)
    w, bias = stem_cuda.fold_stem_weights(
        *[params_from_numpy(params)[k] for k in ("conv1", "bn_conv1")])
    kp, bias_t = stem_pallas.fold_stem_weights(
        jax_tree(params)["conv1"], jax_tree(params)["bn_conv1"])
    np.testing.assert_allclose(bias.numpy(), np.asarray(bias_t)[0, :64],
                               rtol=1e-6, atol=1e-6)
    # packed row (u=1, v=1, pi=0..3, pj=0..3, c) at parity (0, 0) holds tap
    # (dy, dx) = (pi + 3, pj + 3) of the folded 7x7 kernel
    packed = np.asarray(kp.astype(jnp.float32)).reshape(9, 4, 4, 3, 4, 64)
    np.testing.assert_array_equal(
        w.float().numpy()[3:7, 3:7], packed[4, :, :, :, 0])


@pytest.mark.parametrize("proj", [True, False], ids=["projected", "identity"])
def test_chain_plain_matches_pallas(proj):
    rng = np.random.default_rng(2 + proj)
    cin, mid, cout = (16, 8, 32) if proj else (32, 8, 32)
    params = stage_params(rng, 2, cin, mid, cout, "abc", proj)
    x = rng.standard_normal((2, 16, 16, cin)).astype(np.float32)

    jp = jax_tree(params)
    kernel = np.asarray(fused_bottleneck_chain(
        jnp.asarray(x), jax_fold_chain(jp, 2, "abc"), tile_rows=8,
        interpret=True).astype(jnp.float32))
    oracle = jnp.asarray(x).astype(jnp.bfloat16)
    for i, letter in enumerate("abc"):
        oracle = jax_bottleneck(oracle, jp, 2, letter, i == 0 and proj, 1,
                                jnp.bfloat16, None)
    oracle = np.asarray(oracle.astype(jnp.float32))

    blocks = bottleneck_cuda.fold_bottleneck_chain(
        params_from_numpy(params), 2, "abc")
    assert ("ws" in blocks[0]) == proj
    got = bottleneck_cuda.fused_bottleneck_chain(torch.from_numpy(x), blocks)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 16, cout)
    got = got.float().numpy()
    # the TPU kernel and the plain version fold and round at the same
    # points; sums run in another order, so bf16 results can differ by an
    # ulp that the next block carries on
    scale = np.abs(kernel).max()
    np.testing.assert_allclose(got, kernel, rtol=0.02, atol=0.01 * scale)
    # the layer-by-layer oracle rounds after every conv and BN
    np.testing.assert_allclose(got, oracle, rtol=0.05,
                               atol=0.03 * np.abs(oracle).max())


def test_resnet_layer_path_matches_jax_f32():
    """The port's layer path (what runs off the card, and beside the
    kernels on it) against the JAX blocks in float32."""
    rng = np.random.default_rng(5)
    params = stage_params(rng, 3, 16, 8, 32, "ab", True)
    x = rng.standard_normal((1, 8, 8, 16)).astype(np.float32)
    jp = jax_tree(params)
    pp = params_from_numpy(params)
    want, got = jnp.asarray(x), torch.from_numpy(x)
    for i, letter in enumerate("ab"):
        stride = 2 if i == 0 else 1
        want = jax_bottleneck(want, jp, 3, letter, i == 0, stride,
                              jnp.float32, None)
        got = pt_resnet._bottleneck(got, pp, 3, letter, i == 0, stride,
                                    torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
