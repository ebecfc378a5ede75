"""The port's streaming path on the CPU: on-device mask paste, the forward
with the fused heads and `paste_size` against the JAX forward, `run_stream`,
`synthetic_frames`, `quantize_canvas_u8` and the uint8 wire, against the
JAX package or against the port's own batch path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskrcnn_tpu.core.anchors import generate_anchors as jax_anchors
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
from maskrcnn_tpu.models import mask_rcnn as jax_model
from maskrcnn_tpu.pipeline import paste as jax_paste
from maskrcnn_tpu.pipeline import preprocess as jax_pre
from maskrcnn_tpu.pipeline import stream as jax_stream
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.io import weights as pt_weights
from maskrcnn_tpu_torch.models import mask_rcnn as pt_model
from maskrcnn_tpu_torch.pipeline import loader as pt_loader
from maskrcnn_tpu_torch.pipeline import paste as pt_paste
from maskrcnn_tpu_torch.pipeline import preprocess as pt_pre
from maskrcnn_tpu_torch.pipeline import stream as pt_stream
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from tests.torch_support import OVERRIDES, live_bn_params
from tests.torch_support import one_thread  # noqa: F401  (autouse)

FUSED = dict(OVERRIDES, fuse_classifier_head=True, fuse_mask_head=True)


def _near_threshold(masks, boxes, valid, size, band):
    """Pixels whose JAX pre-threshold value lies within `band` of 0.5."""
    lo = jax_paste.paste_masks(masks, boxes, valid, size, 0.5 - band)
    hi = jax_paste.paste_masks(masks, boxes, valid, size, 0.5 + band)
    return np.asarray(lo) != np.asarray(hi)


def test_paste_masks_matches_jax(rng):
    d, m, s = 12, 28, 96
    masks = rng.uniform(size=(d, m, m)).astype(np.float32)
    y1x1 = rng.uniform(-0.1, 0.8, (d, 2))
    boxes = np.concatenate([y1x1, y1x1 + rng.uniform(0.0, 0.6, (d, 2))],
                           -1).astype(np.float32)
    boxes[3, 2:] = boxes[3, :2]                       # zero-area box
    valid = rng.uniform(size=d) > 0.2
    want = np.asarray(jax_paste.paste_masks(
        jnp.asarray(masks), jnp.asarray(boxes), jnp.asarray(valid), s))
    got = pt_paste.paste_masks(torch.from_numpy(masks),
                               torch.from_numpy(boxes),
                               torch.from_numpy(valid), s)
    assert got.dtype == torch.uint8 and got.shape == (d, s, s)
    near = _near_threshold(jnp.asarray(masks), jnp.asarray(boxes),
                           jnp.asarray(valid), s, 1e-5)
    assert want.sum() > 0 and near.mean() < 1e-3
    np.testing.assert_array_equal(got.numpy()[~near], want[~near])
    # batched: leading dims carry through
    got2 = pt_paste.paste_masks(torch.from_numpy(masks).reshape(2, 6, m, m),
                                torch.from_numpy(boxes).reshape(2, 6, 4),
                                torch.from_numpy(valid).reshape(2, 6), s)
    assert torch.equal(got2.reshape(d, s, s), got)


def test_fused_forward_with_paste_matches_jax():
    """The port's fused route (K5/K6 plain versions) against the JAX CPU
    forward, which runs the heads unfused off the TPU (and whose fused jit
    asks for a TPU-only compile option, so it gets the unfused config): at
    float32 the two differ only by where the BN folding rounds."""
    flat = live_bn_params(4)
    images = np.random.default_rng(5).uniform(
        0, 255, (2, 128, 128, 3)).astype(np.float32)
    jcfg = jax_tiny().replace(**OVERRIDES)
    jp = {k: {w: jnp.asarray(v) for w, v in d.items()}
          for k, d in flat.items()}
    want = jax.tree_util.tree_map(np.asarray, jax_model.forward(
        jp, jnp.asarray(images), jnp.asarray(jax_anchors(jcfg)), jcfg,
        paste_size=64))
    got = pt_model.to_numpy(pt_model.forward(
        pt_weights.params_from_numpy(flat), torch.from_numpy(images),
        pt_tiny().replace(**FUSED), device="cpu", paste_size=64))
    assert want["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["detections"][..., 4],
                                  want["detections"][..., 4])
    np.testing.assert_allclose(got["detections"], want["detections"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=1e-4,
                               atol=1e-4)
    assert got["pasted"].dtype == np.uint8
    assert got["pasted"].shape == want["pasted"].shape == (2, 16, 64, 64)
    near = np.stack([_near_threshold(
        jnp.asarray(want["masks"][i]),
        jnp.asarray(want["detections"][i, :, :4]),
        jnp.asarray(want["valid"][i]), 64, 1e-4) for i in range(2)])
    assert near.mean() < 1e-3
    np.testing.assert_array_equal(got["pasted"][~near],
                                  want["pasted"][~near])


@pytest.fixture(scope="module")
def fused_detector():
    params = pt_weights.params_from_numpy(live_bn_params(6))
    return MaskRCNNDetector(pt_tiny().replace(**FUSED), params,
                            device="cpu")


def test_run_stream_matches_run_batch(fused_detector):
    det = fused_detector
    frames = list(pt_stream.synthetic_frames(3, 128, seed=1))
    seen = {}
    stats = pt_stream.run_stream(det, frames, micro_batch=2, paste_size=32,
                                 latency_probes=2, sync_every=1,
                                 on_result=lambda i, o: seen.update({i: o}))
    assert stats.frames == 3 and stats.latency_probes == 2
    assert sorted(seen) == [0, 2]
    assert 0 < stats.p50_latency_ms <= stats.p95_latency_ms \
        <= stats.p99_latency_ms and stats.fps > 0
    for start, stop in ((0, 2), (2, 3)):
        want = det.run_batch(np.stack(frames[start:stop]), paste_size=32)
        assert set(seen[start]) == set(want)
        for k, v in want.items():
            assert torch.equal(seen[start][k], v), k
    assert seen[0]["pasted"].shape == (2, 16, 32, 32)
    pre = pt_stream.run_stream(det, [torch.from_numpy(np.stack(frames[:2]))],
                               prebatched=True, latency_probes=0)
    assert pre.frames == 2 and pre.latency_probes == 0


def test_synthetic_frames_and_quantize_match_jax(rng):
    got = list(pt_stream.synthetic_frames(4, 40, seed=3))
    want = list(jax_stream.synthetic_frames(4, 40, seed=3))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    canvas = rng.uniform(-3, 258, (16, 16, 3)).astype(np.float32)
    canvas[0, :4, 0] = [0.5, 1.5, 2.5, 254.5]         # ties round to even
    np.testing.assert_array_equal(pt_pre.quantize_canvas_u8(canvas),
                                  jax_pre.quantize_canvas_u8(canvas))
    u8 = got[0]
    assert pt_pre.quantize_canvas_u8(u8) is u8


def test_uint8_wire_equals_quantized_canvases(fused_detector):
    det = fused_detector
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 256, (90, 140, 3), dtype=np.uint8),
            rng.integers(0, 256, (130, 100, 3), dtype=np.uint8)]
    got = det.detect_images(imgs, uint8_wire=True)
    canvases, windows = zip(*[pt_loader.letterbox_rgb(im, 128)
                              for im in imgs])
    quantized = [pt_pre.quantize_canvas_u8(c).astype(np.float32)
                 for c in canvases]
    want = det.detect_canvases(quantized, windows)
    assert [len(r) for r in got] == [len(r) for r in want]
    assert sum(len(r) for r in want) > 0
    for gr, wr in zip(got, want):
        for g, w in zip(gr, wr):
            assert (g.box, g.class_id, g.score) == (w.box, w.class_id,
                                                     w.score)
            np.testing.assert_array_equal(g.mask, w.mask)
