"""The port's evalkit on the CPU against the JAX package's, with the JAX
package's native library switched off so both take their numpy paths: COCO
RLE (every `mask_rle` function, string-equal counts), the COCO evaluator
(the pycocotools golden cases and a random dataset, all 12 stats equal),
the results rows and `.pb` bytes, and the detector's `paste_masks="rle"`."""

import json
import os
import types

import numpy as np
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest

import maskrcnn_tpu.evalkit.cocoeval as jax_ce
import maskrcnn_tpu.evalkit.mask_rle as jax_rle
import maskrcnn_tpu.native
import maskrcnn_tpu_torch.native
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
from maskrcnn_tpu.evalkit import results as jax_results
from maskrcnn_tpu.evalkit.coco import COCODataset as JaxDataset
from maskrcnn_tpu.pipeline import detector as jax_det
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.evalkit import cocoeval as pt_ce
from maskrcnn_tpu_torch.evalkit import mask_rle as pt_rle
from maskrcnn_tpu_torch.evalkit import results as pt_results
from maskrcnn_tpu_torch.evalkit.coco import COCODataset as PtDataset
from maskrcnn_tpu_torch.pipeline import detector as pt_det
from maskrcnn_tpu_torch.pipeline.preprocess import compute_window
from tests.torch_support import one_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _jax_numpy_paths(monkeypatch):
    """Both packages' numpy and PIL paths: their C++ libraries off (the
    native paths against each other are in test_torch_native.py)."""
    monkeypatch.setattr(jax_rle, "get_rle_lib", lambda: None)
    monkeypatch.setattr(jax_ce, "get_evalmatch_lib", lambda: None)
    monkeypatch.setattr(maskrcnn_tpu.native, "get_imageio_lib", lambda: None)
    monkeypatch.setattr(pt_rle, "get_rle_lib", lambda: None)
    monkeypatch.setattr(pt_ce, "get_evalmatch_lib", lambda: None)
    monkeypatch.setattr(maskrcnn_tpu_torch.native, "get_imageio_lib",
                        lambda: None)


def _masks(seed, h=37, w=53):
    """Random blobs, an empty mask, a full one, and masks touching every
    edge (runs that start at 0 and end at h*w)."""
    rng = np.random.default_rng(seed)
    out = [rng.uniform(size=(h, w)) > 0.6,
           np.zeros((h, w), bool), np.ones((h, w), bool)]
    m = np.zeros((h, w), bool)
    m[:, 0] = m[-1, :] = m[0, 5:9] = True
    out.append(m)
    m = np.zeros((h, w), bool)
    y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
    m[y0:y0 + h // 3, x0:x0 + w // 4] = True
    out.append(m)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_decode_area_counts_match_jax(seed):
    for m in _masks(seed):
        got, want = pt_rle.encode(m), jax_rle.encode(m)
        np.testing.assert_array_equal(got.counts, want.counts)
        assert (got.h, got.w) == (want.h, want.w)
        s = pt_rle.to_coco_counts(got)
        assert s == jax_rle.to_coco_counts(want)
        back = pt_rle.from_coco_counts(s, got.h, got.w)
        np.testing.assert_array_equal(back.counts, got.counts)
        np.testing.assert_array_equal(pt_rle.decode(got), jax_rle.decode(want))
        np.testing.assert_array_equal(pt_rle.decode(got), m.astype(np.uint8))
        assert pt_rle.area(got) == jax_rle.area(want) == int(m.sum())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_encode_region_matches_jax_and_full_canvas(seed):
    rng = np.random.default_rng(seed)
    h, w = 41, 29
    for _ in range(12):
        bh, bw = rng.integers(0, h + 1), rng.integers(0, w + 1)
        y0, x0 = rng.integers(0, h - bh + 1), rng.integers(0, w - bw + 1)
        region = rng.uniform(size=(bh, bw)) > rng.uniform(0.2, 0.8)
        if bh == h and rng.uniform() < 0.5:
            region[:] = True          # runs that join across columns
        got = pt_rle.encode_region(region, y0, x0, h, w)
        want = jax_rle.encode_region(region, y0, x0, h, w)
        assert pt_rle.to_coco_counts(got) == jax_rle.to_coco_counts(want)
        canvas = np.zeros((h, w), bool)
        canvas[y0:y0 + bh, x0:x0 + bw] = region
        np.testing.assert_array_equal(got.counts,
                                      pt_rle.encode(canvas).counts)


def test_iou_masks_and_boxes_match_jax():
    rng = np.random.default_rng(5)
    ms = _masks(3) + _masks(4)
    dt = [pt_rle.encode(m) for m in ms[:6]]
    gt = [pt_rle.encode(m) for m in ms[6:]]
    crowd = [False, True, False, True]
    jdt = [jax_rle.encode(m) for m in ms[:6]]
    jgt = [jax_rle.encode(m) for m in ms[6:]]
    np.testing.assert_array_equal(pt_rle.iou_masks(dt, gt, crowd),
                                  jax_rle.iou_masks(jdt, jgt, crowd))
    assert pt_rle.iou_masks([], gt).shape == (0, 4)
    boxes_d = rng.uniform(0, 50, (7, 4))
    boxes_g = rng.uniform(0, 50, (5, 4))
    boxes_g[2] = boxes_d[1]
    np.testing.assert_array_equal(
        pt_rle.iou_boxes(boxes_d, boxes_g, [0, 1, 0, 0, 1]),
        jax_rle.iou_boxes(boxes_d, boxes_g, [0, 1, 0, 0, 1]))


def test_polygons_and_segmentation_forms_match_jax():
    rng = np.random.default_rng(6)
    h, w = 60, 80
    polys = [list(rng.uniform(0, 80, 2 * k)) for k in (3, 5, 8)]
    polys.append([10, 10, 50.5, 10, 50.5, 40.5, 10, 40.5])
    polys.append([1.0, 2.0])                       # too short: skipped
    np.testing.assert_array_equal(
        pt_rle._poly_rasterize_np(np.reshape(polys[1], (-1, 2)), h, w),
        jax_rle._poly_rasterize_np(np.reshape(polys[1], (-1, 2)), h, w))
    got = pt_rle.from_polygons(polys, h, w)
    want = jax_rle.from_polygons(polys, h, w)
    assert pt_rle.to_coco_counts(got) == jax_rle.to_coco_counts(want)
    m = _masks(7, h, w)[0]
    r = pt_rle.encode(m)
    for seg in (polys, {"size": [h, w], "counts": pt_rle.to_coco_counts(r)},
                {"size": [h, w], "counts": [int(c) for c in r.counts]}):
        a = pt_rle.from_coco_segmentation(seg, h, w)
        b = jax_rle.from_coco_segmentation(seg, h, w)
        np.testing.assert_array_equal(a.counts, b.counts)
    with pytest.raises(TypeError):
        pt_rle.from_coco_segmentation(3, h, w)


def _golden_cases():
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "cocoeval_golden.json")
    with open(path) as f:
        return json.load(f)["cases"]


@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: c["name"])
def test_pycocotools_golden_matches_jax(case):
    data = {k: case[k] for k in ("images", "annotations", "categories")}
    iou_type = case.get("iou_type", "bbox")
    got = pt_ce.COCOEvaluator(PtDataset(data), case["results"],
                              iou_type).summarize(verbose=False)
    want = jax_ce.COCOEvaluator(JaxDataset(data), case["results"],
                                iou_type).summarize(verbose=False)
    np.testing.assert_allclose(got, case["expected_stats"], atol=1e-9)
    np.testing.assert_array_equal(got, want)


def _random_dataset(seed):
    """Images, annotations with mask segmentations (some crowds), and
    results with noisy boxes and masks near the annotations."""
    rng = np.random.default_rng(seed)
    h, w = 48, 64
    images, anns, results = [], [], []
    for img in range(1, 7):
        images.append({"id": img, "width": w, "height": h,
                       "file_name": f"{img}.jpg"})
        for _ in range(int(rng.integers(0, 5))):
            x, y = rng.uniform(0, w - 8), rng.uniform(0, h - 8)
            bw, bh = rng.uniform(4, w - x), rng.uniform(4, h - y)
            m = np.zeros((h, w), bool)
            m[int(y):int(y + bh), int(x):int(x + bw)] = True
            r = pt_rle.encode(m)
            anns.append({"id": len(anns) + 1, "image_id": img,
                         "category_id": int(rng.choice([3, 7, 9])),
                         "bbox": [x, y, bw, bh], "area": float(m.sum()),
                         "iscrowd": int(rng.uniform() < 0.15),
                         "segmentation": {"size": [h, w],
                                          "counts": pt_rle.to_coco_counts(r)}})
        img_anns = [a for a in anns if a["image_id"] == img]
        for _ in range(int(rng.integers(0, 7))):
            if img_anns and rng.uniform() < 0.7:     # near an annotation
                a = img_anns[int(rng.integers(0, len(img_anns)))]
                cat = a["category_id"]
                x, y, bw, bh = (v + rng.normal(0, 2) for v in a["bbox"])
            else:
                cat = int(rng.choice([3, 7, 9]))
                x, y = rng.uniform(0, w - 6), rng.uniform(0, h - 6)
                bw, bh = rng.uniform(3, w - x), rng.uniform(3, h - y)
            m = np.zeros((h, w), bool)
            m[max(int(y), 0):int(y + bh), max(int(x), 0):int(x + bw)] = True
            m &= rng.uniform(size=(h, w)) > 0.1
            r = pt_rle.encode(m)
            results.append({"image_id": img, "category_id": cat,
                            "bbox": [x, y, bw, bh],
                            "score": float(np.round(rng.uniform(), 2)),
                            "segmentation": {
                                "size": [h, w],
                                "counts": pt_rle.to_coco_counts(r)}})
    cats = [{"id": c, "name": str(c)} for c in (3, 7, 9)]
    return {"images": images, "annotations": anns, "categories": cats}, \
        results


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_evaluator_matches_jax_on_random_dataset(iou_type):
    data, results = _random_dataset(11)
    got = pt_ce.COCOEvaluator(PtDataset(data), results,
                              iou_type).summarize(verbose=False)
    want = jax_ce.COCOEvaluator(JaxDataset(data), results,
                                iou_type).summarize(verbose=False)
    assert got.shape == (12,) and (got > 0).any()
    np.testing.assert_array_equal(got, want)


def test_match_all_areas_matches_jax_numpy_path():
    rng = np.random.default_rng(0)
    area_rngs = np.asarray(list(pt_ce.AREA_RNG.values()))
    for _ in range(30):
        d, g = int(rng.integers(0, 10)), int(rng.integers(0, 8))
        ious = rng.integers(0, 11, size=(d, g)).astype(np.float64) / 10
        g_areas = rng.choice([100.0, 1024.0, 5000.0, 9216.0, 20000.0], g)
        d_areas = rng.choice([100.0, 1024.0, 5000.0, 9216.0, 20000.0], d)
        crowd, ignore = rng.uniform(size=g) < 0.3, rng.uniform(size=g) < 0.2
        got = pt_ce.match_all_areas(ious, g_areas, crowd, ignore, d_areas,
                                    area_rngs)
        want = jax_ce.match_all_areas(ious, g_areas, crowd, ignore, d_areas,
                                      area_rngs, force_numpy=True)
        for k in ("dtm", "d_ignore", "n_gt"):
            np.testing.assert_array_equal(got[k], want[k])


def _detections(cls):
    """The same detections as the port's or the JAX package's `Detection`:
    one with an RLE, one with a full mask, one with neither."""
    mask = np.zeros((100, 120), bool)
    mask[20:60, 10:30] = True
    r = pt_rle.encode(mask[::-1])
    rle = {"size": [100, 120], "counts": pt_rle.to_coco_counts(r)}
    return [cls(box=(20.0, 10.0, 60.5, 30.25), class_id=1, score=0.9,
                rle=rle),
            cls(box=(5.5, 7.0, 40.0, 90.0), class_id=2, score=0.75,
                mask=mask),
            cls(box=(0.0, 0.0, 99.0, 119.0), class_id=1, score=0.125)]


def _results_data():
    return {"images": [{"id": 4, "width": 120, "height": 100,
                        "file_name": "4.jpg"},
                       {"id": 9, "width": 120, "height": 100,
                        "file_name": "9.jpg"}],
            "annotations": [],
            "categories": [{"id": 3, "name": "cat"},
                           {"id": 7, "name": "dog"}]}


def test_results_rows_and_pb_bytes_match_jax(tmp_path):
    pt_ds, jax_ds = PtDataset(_results_data()), JaxDataset(_results_data())
    got = _detections(pt_det.Detection)
    want = _detections(jax_det.Detection)
    rows = pt_results.detections_to_coco_results(4, got, pt_ds)
    assert rows == jax_results.detections_to_coco_results(4, want, jax_ds)
    assert [r["category_id"] for r in rows] == [3, 7, 3]
    assert "segmentation" not in rows[2]
    assert pt_results.detections_to_coco_results(
        4, got, pt_ds, with_masks=False) == \
        jax_results.detections_to_coco_results(4, want, jax_ds,
                                               with_masks=False)
    path = str(tmp_path / "results.json")
    pt_results.save_coco_results(rows, path)
    assert pt_results.load_coco_results(path) == json.loads(
        json.dumps(rows))
    per_image = {4: got, 9: got[1:]}
    msg = pt_results.build_results_proto(per_image, pt_ds)
    want_msg = jax_results.build_results_proto({4: want, 9: want[1:]},
                                               jax_ds)
    assert msg.SerializeToString() == want_msg.SerializeToString()
    pb = str(tmp_path / "results.pb")
    pt_results.save_results_proto(msg, pb)
    with open(pb, "rb") as f:
        assert f.read() == want_msg.SerializeToString()
    back = pt_results.proto_to_coco_results(
        pt_results.load_results_proto(pb), pt_ds)
    assert back == jax_results.proto_to_coco_results(
        jax_results.load_results_proto(pb), jax_ds)
    assert back[0]["category_id"] == 3
    np.testing.assert_allclose(back[0]["bbox"], [10.0, 20.0, 20.25, 40.5])


def test_unmold_rle_matches_jax_and_full_mask():
    """Queue 3 fault 2: `paste_masks="rle"` gives `Detection.rle` with
    `mask=None`, the JAX package's strings; True full masks; False
    neither."""
    rng = np.random.default_rng(8)
    d = 6
    yx = rng.uniform(-0.05, 0.7, (d, 2))
    hw = rng.uniform(0.0, 0.5, (d, 2))
    det = np.concatenate([yx, yx + hw, rng.integers(1, 5, (d, 1)),
                          rng.uniform(0.3, 1, (d, 1))], 1).astype(np.float32)
    det[2, 2:4] = det[2, 0:2]                           # zero-size box
    masks = rng.uniform(size=(d, 28, 28)).astype(np.float32)
    valid = np.array([1, 1, 1, 0, 1, 1], bool)
    win = compute_window(77, 130, 128)
    this = types.SimpleNamespace(config=pt_tiny(), mask_threshold=0.5)
    ref = types.SimpleNamespace(config=jax_tiny(), mask_threshold=0.5)
    got = pt_det.MaskRCNNDetector.unmold(this, det, masks, valid, win,
                                         paste_masks="rle")
    want = jax_det.MaskRCNNDetector.unmold(ref, det, masks, valid, win,
                                           paste_masks="rle")
    full = pt_det.MaskRCNNDetector.unmold(this, det, masks, valid, win,
                                          paste_masks=True)
    none = pt_det.MaskRCNNDetector.unmold(this, det, masks, valid, win,
                                          paste_masks=False)
    assert len(got) == len(want) == len(full) == len(none) == 5
    for g, w, f, n in zip(got, want, full, none):
        assert g.mask is None and g.rle == w.rle and g.box == w.box
        assert g.rle["size"] == [77, 130]
        dec = pt_rle.decode(pt_rle.from_coco_segmentation(g.rle, 77, 130))
        np.testing.assert_array_equal(dec.astype(bool), f.mask)
        assert f.rle is None and n.mask is None and n.rle is None
