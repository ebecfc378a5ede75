"""The port's loader on the CPU against the JAX package's PIL path (its
native library switched off): decode and letterbox of grayscale, (H, W, 1),
RGB and RGBA images, JPEG and PNG files and bytes; `PrefetchLoader` order;
`load_batch`; `frames_from_dir`; and `detect_images` on grayscale and RGBA
images against the JAX detector (Queue 3 fault 1)."""

import io
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import maskrcnn_tpu.native
import maskrcnn_tpu.pipeline.loader as jax_loader
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
from maskrcnn_tpu.pipeline import detector as jax_det
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.io import weights as pt_weights
from maskrcnn_tpu_torch.pipeline import loader as pt_loader
from maskrcnn_tpu_torch.pipeline import stream as pt_stream
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from tests.test_torch_model import OVERRIDES, live_bn_params

SHAPES = [(61, 90), (61, 90, 1), (90, 61, 3), (45, 130, 4)]


@pytest.fixture(autouse=True)
def _jax_pil_path(monkeypatch):
    monkeypatch.setattr(jax_loader, "get_imageio_lib", lambda: None)
    monkeypatch.setattr(maskrcnn_tpu.native, "get_imageio_lib", lambda: None)


def _image(shape, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[shape[0] // 3:, : shape[1] // 2] //= 3          # some structure
    return img


def _encode(img, fmt):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img.squeeze(-1) if img.ndim == 3 and img.shape[-1] == 1
                    else img).save(buf, format=fmt)
    return buf.getvalue()


def _window(w):
    return tuple(w.__dict__.values())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_letterbox_rgb_matches_jax(shape):
    img = _image(shape)
    got, gw = pt_loader.letterbox_rgb(img, 128)
    want, ww = jax_loader.letterbox_rgb(img, 128)
    assert got.shape == (128, 128, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert _window(gw) == _window(ww)


def test_ensure_rgb3_rejects_other_shapes():
    with pytest.raises(ValueError, match="channels"):
        pt_loader.letterbox_rgb(np.zeros((8, 8, 2), np.uint8), 32)
    with pytest.raises(ValueError, match="image"):
        pt_loader.letterbox_rgb(np.zeros((2, 8, 8, 3), np.uint8), 32)


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_decode_file_and_bytes_match_jax(tmp_path, fmt, shape):
    if fmt == "JPEG" and len(shape) == 3 and shape[-1] == 4:
        shape = shape[:2] + (3,)          # JPEG has no alpha channel
    img = _image(shape, seed=1)
    data = _encode(img, fmt)
    path = str(tmp_path / f"img.{fmt.lower()}")
    with open(path, "wb") as f:
        f.write(data)
    got = pt_loader.decode_rgb(path)
    assert got.shape == shape[:2] + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_loader.decode_rgb(path))
    np.testing.assert_array_equal(pt_loader.decode_rgb_bytes(data), got)
    np.testing.assert_array_equal(jax_loader.decode_rgb_bytes(data), got)
    for pt_fn, jax_fn, src in (
            (pt_loader.load_letterboxed, jax_loader.load_letterboxed, path),
            (pt_loader.load_letterboxed_bytes,
             jax_loader.load_letterboxed_bytes, data)):
        c, w = pt_fn(src, 96)
        c2, w2 = jax_fn(src, 96)
        np.testing.assert_array_equal(c, c2)
        assert _window(w) == _window(w2)


def test_decode_bytes_rejects_garbage():
    with pytest.raises(Exception):
        pt_loader.decode_rgb_bytes(b"not an image")


def _write_images(tmp_path, n, fmt="PNG"):
    paths = []
    for i in range(n):
        img = _image((40 + 7 * i, 50 + 3 * i, 3), seed=i)
        p = tmp_path / f"f{i:02d}.{fmt.lower()}"
        p.write_bytes(_encode(img, fmt))
        paths.append(str(p))
    return paths


def test_prefetch_loader_keeps_input_order(tmp_path, monkeypatch):
    """Later items finish first (the first decodes sleep longest); the
    loader still yields in submission order, each with its own canvas."""
    paths = _write_images(tmp_path, 9)
    real = pt_loader.load_letterboxed
    finished = []
    lock = threading.Lock()

    def slow(path, size):
        time.sleep(0.02 * (9 - paths.index(path)))
        out = real(path, size)
        with lock:
            finished.append(path)
        return out

    monkeypatch.setattr(pt_loader, "load_letterboxed", slow)
    items = [(f"k{i}", p) for i, p in enumerate(paths)]
    got = list(pt_loader.PrefetchLoader(iter(items), 64, workers=4,
                                        depth=6))
    assert [k for k, _, _ in got] == [k for k, _ in items]
    assert finished != paths          # the pool did finish out of order
    for (_, p), (_, canvas, win) in zip(items, got):
        want, wwin = jax_loader.load_letterboxed(p, 64)
        np.testing.assert_array_equal(canvas, want)
        assert _window(win) == _window(wwin)


def test_load_batch_and_frames_from_dir(tmp_path):
    paths = _write_images(tmp_path, 5, fmt="JPEG")
    batch, wins = pt_loader.load_batch(paths, 64, workers=3)
    assert batch.shape == (5, 64, 64, 3) and batch.dtype == np.float32
    want, wwins = zip(*[jax_loader.load_letterboxed(p, 64) for p in paths])
    np.testing.assert_array_equal(batch, np.stack(want))
    assert [_window(w) for w in wins] == [_window(w) for w in wwins]
    (tmp_path / "notes.txt").write_text("skipped")
    frames = list(pt_stream.frames_from_dir(str(tmp_path), 64))
    assert len(frames) == 5
    np.testing.assert_array_equal(np.stack(frames), batch)


def test_detect_images_gray_and_rgba_match_jax():
    """Queue 3 fault 1: (H, W), (H, W, 1) and (H, W, 4) images go through
    `detect_images` as the JAX package takes them."""
    flat = live_bn_params(4)
    jcfg = jax_tiny().replace(**OVERRIDES)
    pcfg = pt_tiny().replace(**OVERRIDES)
    imgs = [_image((70, 110), 5), _image((100, 64, 1), 6),
            _image((90, 120, 4), 7)]
    jdet = jax_det.MaskRCNNDetector(
        jcfg, {k: {w: jnp.asarray(v) for w, v in d.items()}
               for k, d in flat.items()})
    want = jdet.detect_images(imgs, paste_masks=False, batch_size=3)
    pdet = MaskRCNNDetector(pcfg, pt_weights.params_from_numpy(flat),
                            device="cpu")
    got = pdet.detect_images(imgs, paste_masks=False, batch_size=3)
    assert sum(len(w) for w in want) > 0
    for g_img, w_img in zip(got, want):
        assert [d.class_id for d in g_img] == [d.class_id for d in w_img]
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g.box, w.box, atol=1e-4)
            assert abs(g.score - w.score) < 1e-4
            assert g.mask is None and g.rle is None
    assert jax.devices()[0].platform == "cpu"
    assert pdet.device == torch.device("cpu")
