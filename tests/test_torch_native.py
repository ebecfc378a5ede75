"""The port's native host library (`maskrcnn_tpu_torch/native`) against the
JAX package's (`maskrcnn_tpu/native`), both built here with g++: the same
sources and flags, so every function must give the same bits. Covers the
build (where, concurrently, without libjpeg), JPEG decode, letterbox,
fused decode+letterbox, mask paste, the RLE codec and IoU, the COCO
matcher, and `detect_images(paste_masks="rle")` end to end."""

import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch
from PIL import Image

import maskrcnn_tpu.native as jax_native
import maskrcnn_tpu_torch.native as pt_native
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
from maskrcnn_tpu.evalkit import cocoeval as jax_ce
from maskrcnn_tpu.evalkit import mask_rle as jax_rle
from maskrcnn_tpu.pipeline import detector as jax_det
from maskrcnn_tpu.pipeline import loader as jax_loader
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.evalkit import cocoeval as pt_ce
from maskrcnn_tpu_torch.evalkit import mask_rle as pt_rle
from maskrcnn_tpu_torch.pipeline import detector as pt_det
from maskrcnn_tpu_torch.pipeline import loader as pt_loader
from maskrcnn_tpu_torch.pipeline.preprocess import letterbox_numpy
from tests.torch_support import one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT_SRC = os.path.join(os.path.dirname(pt_native.__file__), "src")
JAX_SRC = os.path.join(os.path.dirname(jax_native.__file__), "src")
PT_BUILD = os.path.join(ROOT, "maskrcnn_tpu_torch", "build")
GUARD = re.compile(r"^#(ifndef|endif) .*MRT_NO_JPEG.*\n", re.M)


def _toolchain_missing() -> str | None:
    if shutil.which("g++") is None:
        return "no g++"
    if not any(os.path.exists(p) for p in (
            "/usr/include/jpeglib.h",
            "/usr/include/x86_64-linux-gnu/jpeglib.h",
            "/usr/include/aarch64-linux-gnu/jpeglib.h")):
        return "no jpeglib.h"
    return None


@pytest.fixture(scope="module")
def native():
    """Both packages' three libraries, built; skips where g++ or libjpeg's
    header is missing.

    The JAX package's loader builds every process into one shared
    temporary file, so test processes that build it together can leave
    some of them with a failed load that it then caches (the port's
    loader builds to a file per process). Such a failure is cleared and
    the load retried here once the build on disk is whole."""
    reason = _toolchain_missing()
    if reason:
        pytest.skip(f"{reason}: the native library cannot build here")
    libs = {}
    for get in ("get_rle_lib", "get_imageio_lib", "get_evalmatch_lib"):
        libs["maskrcnn_tpu_torch.native", get] = getattr(pt_native, get)()
        name = get[len("get_"):-len("_lib")]
        for _ in range(5):
            lib = getattr(jax_native, get)()
            if lib is not None:
                break
            jax_native._errors.pop(name, None)
            time.sleep(2)
        libs["maskrcnn_tpu.native", get] = lib
    assert all(v is not None for v in libs.values()), (
        pt_native.native_errors(), jax_native._errors)
    return libs


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """JPEG files (colour, grayscale, a 1-pixel-high strip) with their
    bytes; the same files feed both packages."""
    td = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.default_rng(21)
    out = {}
    for name, shape in (("rgb", (97, 143, 3)), ("gray", (120, 90)),
                        ("strip", (1, 300, 3))):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(td / f"{name}.jpg")
        Image.fromarray(img).save(path, quality=90)
        with open(path, "rb") as f:
            out[name] = (path, f.read())
    return out


def _masks(seed, n=12, h=41, w=57):
    rng = np.random.default_rng(seed)
    ms = []
    for _ in range(n):
        m = np.zeros((h, w), np.uint8)
        for _ in range(3):
            y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
            m[y:y + rng.integers(2, 20), x:x + rng.integers(2, 30)] = 1
        ms.append(m)
    ms[0][:] = 0
    ms[1][:] = 1
    return ms


def test_libraries_build_into_the_port_tree(native):
    """The port's three libraries are its own `.so` files under
    `maskrcnn_tpu_torch/build/`, from its own sources, and load."""
    for get in ("get_rle_lib", "get_imageio_lib", "get_evalmatch_lib"):
        lib = native["maskrcnn_tpu_torch.native", get]
        assert os.path.dirname(lib._name) == PT_BUILD, lib._name
        assert re.fullmatch(r"lib(rle|imageio|evalmatch)-[0-9a-f]{16}\.so",
                            os.path.basename(lib._name))
    assert native["maskrcnn_tpu_torch.native", "get_imageio_lib"].has_jpeg
    assert pt_native.native_available() and pt_native.native_errors() == {}
    assert pt_native._so_path(os.path.join(PT_SRC, "rle.cpp"), [], "t") \
        != pt_native._so_path(os.path.join(PT_SRC, "rle.cpp"), ["-x"], "t")


@pytest.mark.parametrize("name", ["imageio.cpp", "rle.cpp", "evalmatch.cpp"])
def test_sources_are_the_jax_packages(name):
    """Byte for byte the JAX package's sources, but for imageio's
    `MRT_NO_JPEG` guard lines."""
    with open(os.path.join(PT_SRC, name)) as f:
        port = f.read()
    with open(os.path.join(JAX_SRC, name)) as f:
        ref = f.read()
    if name == "imageio.cpp":
        assert len(GUARD.findall(port)) == 8
        port = GUARD.sub("", port)
    assert port == ref


def test_concurrent_builds_leave_one_library(native, tmp_path):
    """Four processes build librle into one empty directory at once: each
    loads it, one `.so` stays and no temporary file."""
    code = ("import sys\n"
            "import maskrcnn_tpu_torch.native as n\n"
            "n._BUILD_DIR = sys.argv[1]\n"
            "lib = n.get_rle_lib()\n"
            "assert lib is not None, n.native_errors()\n"
            "print(lib._name)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert len({out for out, _ in outs}) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(
        outs[0][0].strip())]


def test_without_libjpeg_decode_takes_pil(native, images, tmp_path,
                                          monkeypatch):
    """Where the `-ljpeg` build fails, libimageio is built with
    `-DMRT_NO_JPEG`: no JPEG entry points, the reason kept, letterbox and
    paste still native, JPEG decode through PIL."""
    real = pt_native._compile

    def no_jpeg(src, so, flags, precise):
        if "-ljpeg" in flags:
            raise RuntimeError("g++ failed (rc 1):\nfatal error: "
                               "jpeglib.h: No such file or directory")
        real(src, so, flags, precise)

    monkeypatch.setattr(pt_native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(pt_native, "_compile", no_jpeg)
    monkeypatch.setattr(pt_native, "_libs", {})
    monkeypatch.setattr(pt_native, "_errors", {})
    lib = pt_native.get_imageio_lib()
    assert lib is not None and not lib.has_jpeg
    assert not hasattr(lib, "img_decode_jpeg")
    assert "jpeglib.h" in pt_native.native_errors()["imageio -ljpeg"]
    monkeypatch.setattr(pt_loader, "get_imageio_lib", lambda: lib)
    path, data = images["rgb"]
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(pt_loader.decode_rgb(path), pil)
    np.testing.assert_array_equal(pt_loader.decode_rgb_bytes(data), pil)
    fused = [pt_loader.load_letterboxed(path, 160),
             pt_loader.load_letterboxed_bytes(data, 160)]
    want = pt_loader.letterbox_rgb(pil, 160)          # native letterbox
    full = native["maskrcnn_tpu_torch.native", "get_imageio_lib"]
    monkeypatch.setattr(pt_loader, "get_imageio_lib", lambda: full)
    np.testing.assert_array_equal(pt_loader.letterbox_rgb(pil, 160)[0],
                                  want[0])
    for canvas, win in fused:
        np.testing.assert_array_equal(canvas, want[0])
        assert win == want[1]


@pytest.mark.parametrize("name", ["rgb", "gray", "strip"])
def test_jpeg_decode_matches_jax(native, images, name):
    path, data = images[name]
    want = jax_loader.decode_rgb(path)
    got = pt_loader.decode_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pt_loader.decode_rgb_bytes(data), want)
    np.testing.assert_array_equal(jax_loader.decode_rgb_bytes(data), want)


@pytest.mark.parametrize("shape", [(61, 90), (61, 90, 1), (90, 61, 3),
                                   (45, 130, 4), (2, 700, 3), (500, 1, 3)])
def test_letterbox_matches_jax(native, shape):
    """(H, W), (H, W, 1), RGB, RGBA and degenerate aspects: the same
    canvas bits and window; within 2 levels of PIL."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    got, gw = pt_loader.letterbox_rgb(img, 128)
    want, ww = jax_loader.letterbox_rgb(img, 128)
    np.testing.assert_array_equal(got, want)
    assert tuple(gw.__dict__.values()) == tuple(ww.__dict__.values())
    pil, _ = letterbox_numpy(pt_loader._ensure_rgb3(img), 128)
    assert np.abs(got - pil).max() <= 2.0


@pytest.mark.parametrize("name", ["rgb", "gray", "strip"])
def test_fused_decode_letterbox_matches_jax(native, images, name):
    path, data = images[name]
    want, ww = jax_loader.load_letterboxed(path, 192)
    for got, gw in (pt_loader.load_letterboxed(path, 192),
                    pt_loader.load_letterboxed_bytes(data, 192)):
        np.testing.assert_array_equal(got, want)
        assert tuple(gw.__dict__.values()) == tuple(ww.__dict__.values())
    got, _ = jax_loader.load_letterboxed_bytes(data, 192)
    np.testing.assert_array_equal(got, want)


# clipped on every side, sub-pixel, inside, touching the edge, and wholly
# out of frame (below-right and above-left)
BOXES = [(-15.3, -20.9, 300.2, 401.7), (10.2, 20.7, 11.0, 21.1),
         (100.5, 200.5, 150.5, 260.5), (0.0, 0.0, 239.0, 319.0),
         (230.0, 300.0, 260.0, 350.0), (250.0, 330.0, 270.0, 360.0),
         (-40.0, -30.0, -5.0, -2.0)]


@pytest.mark.parametrize("box", BOXES)
def test_paste_matches_jax(native, box):
    shape = (240, 320)
    mask = np.random.default_rng(11).random((28, 28)).astype(np.float32)
    got = pt_det.paste_mask(mask, box, shape)
    want = jax_det.paste_mask(mask, box, shape)
    assert got.dtype == np.dtype(bool) and got.shape == shape
    np.testing.assert_array_equal(got, want)
    region, ry, rx = pt_det.paste_mask_region(mask, box, shape)
    wregion, wy, wx = jax_det.paste_mask_region(mask, box, shape)
    assert (ry, rx) == (wy, wx) and region.dtype == np.dtype(bool)
    np.testing.assert_array_equal(region, wregion)
    np.testing.assert_array_equal(
        region, got[ry:ry + region.shape[0], rx:rx + region.shape[1]])
    assert got.sum() == region.sum()


# BOXES on their 240 x 320 canvas, and the falsifying example of the JAX
# package's `tests/test_properties.py::test_paste_mask_bounds` (y1 0, x1
# -2, 1 x 1: wholly left of the image) on that test's 480 x 640 canvas
PASTE_CASES = ([(box, (240, 320)) for box in BOXES]
               + [((0.0, -2.0, 1.0, -1.0), (480, 640))])


@pytest.mark.parametrize("box,shape", PASTE_CASES)
def test_paste_fallback_matches_native(native, monkeypatch, box, shape):
    """The port's PIL fallback paste (the path a process takes where its
    native library did not load) against its native paste: the same
    window and region place, equal up to the threshold-boundary flip
    budget of `tests/test_imageio.py` (PIL resizes in fixed point), and
    empty outside the clipped window. The JAX fallback raises on a box
    wholly outside the image (a negative slice stop,
    `maskrcnn_tpu/pipeline/detector.py:315`); the port's guards the empty
    window, and both of its paths return nothing there."""
    mask = np.random.default_rng(11).random((28, 28)).astype(np.float32)
    native_full = pt_det.paste_mask(mask, box, shape)
    native_region, ny, nx = pt_det.paste_mask_region(mask, box, shape)
    monkeypatch.setattr(pt_native, "get_imageio_lib", lambda: None)
    full = pt_det.paste_mask(mask, box, shape)
    region, ry, rx = pt_det.paste_mask_region(mask, box, shape)
    assert full.dtype == np.dtype(bool) and full.shape == shape
    assert (full != native_full).mean() < 2e-3
    assert (ry, rx) == (ny, nx) and region.shape == native_region.shape
    yy1, xx1, yy2, xx2 = pt_det.paste_window(box, shape)
    for canvas, reg in ((full, region), (native_full, native_region)):
        outside = canvas.copy()
        if yy1 < yy2 and xx1 < xx2:
            outside[yy1:yy2, xx1:xx2] = False
            np.testing.assert_array_equal(reg, canvas[yy1:yy2, xx1:xx2])
        else:
            assert reg.size == 0 and not canvas.any()
        assert not outside.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_codec_and_iou_match_jax(native, seed):
    ms = _masks(seed)
    for m in ms:
        for arr in (np.ascontiguousarray(m), np.asfortranarray(m),
                    np.ascontiguousarray(m.astype(bool))):
            got, want = pt_rle.encode(arr), jax_rle.encode(arr)
            np.testing.assert_array_equal(got.counts, want.counts)
            assert pt_rle.to_coco_counts(got) == jax_rle.to_coco_counts(want)
            np.testing.assert_array_equal(pt_rle.decode(got),
                                          jax_rle.decode(want))
            np.testing.assert_array_equal(pt_rle.decode(got), m)
    dt = [pt_rle.encode(m) for m in ms[:7]]
    gt = [pt_rle.encode(m) for m in ms[7:]]
    crowd = [0, 1, 0, 0, 1]
    got = pt_rle.iou_masks(dt, gt, crowd)
    want = jax_rle.iou_masks([jax_rle.encode(m) for m in ms[:7]],
                             [jax_rle.encode(m) for m in ms[7:]], crowd)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (7, 5) and np.isfinite(got).all()
    rng = np.random.default_rng(seed)
    bd = np.concatenate([rng.uniform(0, 50, (9, 2)),
                         rng.uniform(0, 30, (9, 2))], 1)
    bg = np.concatenate([rng.uniform(0, 50, (5, 2)),
                         rng.uniform(0, 30, (5, 2))], 1)
    np.testing.assert_array_equal(pt_rle.iou_boxes(bd, bg, crowd),
                                  jax_rle.iou_boxes(bd, bg, crowd))


def test_polygons_match_jax(native):
    h, w = 53, 71
    polys = [[3.2, 4.1, 40.7, 8.9, 30.3, 45.2, 5.5, 30.0],
             [50.0, 2.0, 69.5, 20.5, 60.0, 50.0],
             [10.0, 10.0, 12.0],                       # too short: skipped
             [-5.0, -5.0, 80.0, 60.0, 20.0, 60.0]]     # clipped
    got = pt_rle.from_polygons(polys, h, w)
    want = jax_rle.from_polygons(polys, h, w)
    assert pt_rle.to_coco_counts(got) == jax_rle.to_coco_counts(want)
    assert pt_rle.area(got) > 0


def _match_case(seed):
    rng = np.random.default_rng(seed)
    d, g = 23, 9
    ious = rng.uniform(0, 1, (d, g))
    ious[rng.random((d, g)) < 0.4] = 0.0
    ious[3, 2] = ious[3, 5] = 0.75                     # an equal-IoU tie
    return (ious, rng.uniform(0, 120 ** 2, g), rng.random(g) < 0.2,
            rng.random(g) < 0.1, rng.uniform(0, 120 ** 2, d),
            np.asarray(list(pt_ce.AREA_RNG.values())))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_all_areas_matches_jax_and_numpy(native, seed):
    args = _match_case(seed)
    got = pt_ce.match_all_areas(*args)
    want = jax_ce.match_all_areas(*args)
    plain = pt_ce.match_all_areas(*args, force_numpy=True)
    for k in ("dtm", "d_ignore", "n_gt"):
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], plain[k])
    assert (got["dtm"] >= 0).any()


def test_detect_images_rle_matches_jax(native):
    """Tiny config on the CPU, both native libraries on: the JAX detector's
    host path (native letterbox, region paste, RLE) fed the port's forward
    on the canvases it letterboxed gives the port's `detect_images` boxes,
    scores and RLE strings exactly. (The two forwards agree within their
    tolerance in test_torch_model.py.)"""
    cfg = pt_tiny().replace(compute_dtype="float32",
                            detection_score_threshold=0.0)
    det = pt_det.MaskRCNNDetector.from_random(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (90, 140, 3), dtype=np.uint8),
            rng.integers(0, 256, (130, 77), dtype=np.uint8)]
    got = det.detect_images(imgs, paste_masks="rle")

    seen = []

    def port_forward(canvases):
        seen.append(np.asarray(canvases))
        out = det.run_batch(torch.from_numpy(np.asarray(canvases)))
        return {k: v.float().numpy() if k != "valid" else v.numpy()
                for k, v in out.items()}

    ref = object.__new__(jax_det.MaskRCNNDetector)
    ref.config = jax_tiny().replace(compute_dtype="float32",
                                    detection_score_threshold=0.0)
    ref.mask_threshold = 0.5
    ref.run_batch = port_forward
    want = ref.detect_images(imgs, paste_masks="rle")
    canvases = np.stack([pt_loader.letterbox_rgb(im, cfg.image_height)[0]
                         for im in imgs])
    np.testing.assert_array_equal(seen[0], canvases)
    assert [len(r) for r in got] == [len(r) for r in want]
    assert min(len(r) for r in got) > 0
    for gr, wr in zip(got, want):
        for g, w in zip(gr, wr):
            assert (g.box, g.class_id, g.score) == (w.box, w.class_id,
                                                     w.score)
            assert g.mask is None and g.rle == w.rle
