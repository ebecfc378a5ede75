"""The port's HTTP server on the CPU (`device="cpu"`, tiny config): the
health endpoint, the JSON contract, concurrent requests sharing a batch,
grayscale and RGBA bodies, a malformed body -> 500, a failing forward
reported to every waiter while the server keeps serving, and
`_detections_to_json` against the JAX package's."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest

import maskrcnn_tpu.evalkit.mask_rle as jax_rle
import maskrcnn_tpu_torch.evalkit.mask_rle as pt_rle
from maskrcnn_tpu.pipeline import detector as jax_det
from maskrcnn_tpu.pipeline import serve as jax_serve
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.evalkit.mask_rle import decode, from_coco_counts
from maskrcnn_tpu_torch.pipeline import detector as pt_det
from maskrcnn_tpu_torch.pipeline.serve import (BatchingWorker,
                                               _detections_to_json,
                                               make_server)
from tests.torch_support import port_params
from tests.torch_support import one_thread  # noqa: F401  (autouse)

# every detection above the score threshold 0 reaches the mask branch
CONFIG = pt_tiny().replace(compute_dtype="float32",
                           detection_score_threshold=0.0)


@pytest.fixture(scope="module")
def server():
    det = pt_det.MaskRCNNDetector(CONFIG, port_params(CONFIG, 5),
                                  device="cpu")
    srv, worker = make_server(det, port=0, max_batch=4, window_ms=50.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    worker.stop()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive() and not worker.thread.is_alive()


def _url(srv, path):
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}{path}"


def _encoded(img, fmt="PNG"):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    return buf.getvalue()


def _post(srv, data):
    req = urllib.request.Request(_url(srv, "/detect"), data=data,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _healthz(srv):
    with urllib.request.urlopen(_url(srv, "/healthz"), timeout=30) as r:
        return json.loads(r.read())


def _check_reply(body, h, w):
    assert body["latency_ms"] > 0
    for d in body["detections"]:
        assert d["class_id"] >= 1 and 0.0 < d["score"] <= 1.0
        assert isinstance(d["class_label"], str)
        y1, x1, y2, x2 = d["box_yxyx"]
        assert 0 <= y1 <= y2 <= h and 0 <= x1 <= x2 <= w
        rle = d["mask_rle"]
        assert rle["size"] == [h, w] and isinstance(rle["counts"], str)
        mask = decode(from_coco_counts(rle["counts"], h, w))
        assert mask.shape == (h, w)


def test_healthz_and_404(server):
    body = _healthz(server)
    assert body["status"] == "ok" and body["max_batch"] == 4
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, "/nope"), timeout=30)
    assert e.value.code == 404


@pytest.mark.parametrize("shape,fmt", [((96, 128, 3), "JPEG"),
                                       ((80, 60), "PNG"),
                                       ((70, 90, 4), "PNG")])
def test_detect_json_contract(server, shape, fmt):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    body = _post(server, _encoded(img, fmt))
    assert len(body["detections"]) > 0
    _check_reply(body, *shape[:2])


def test_concurrent_requests_share_batches(server):
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (64 + 8 * i, 96, 3), dtype=np.uint8)
            for i in range(4)]
    results = [None] * 4
    before = dict(server.worker.batch_size_counts)
    batches, frames = server.worker.batches, server.worker.frames

    def call(i):
        results[i] = _post(server, _encoded(imgs[i]))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for img, body in zip(imgs, results):
        _check_reply(body, *img.shape[:2])
    assert server.worker.batches - batches <= 3
    grew = {n: c - before.get(n, 0)
            for n, c in server.worker.batch_size_counts.items()}
    assert any(n > 1 and c > 0 for n, c in grew.items()), grew
    health = _healthz(server)
    assert health["frames"] == frames + 4


def test_malformed_request_returns_500(server):
    frames = server.worker.frames
    req = urllib.request.Request(_url(server, "/detect"),
                                 data=b"not an image", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 500
    assert "error" in json.loads(e.value.read())
    assert server.worker.frames == frames      # never reached the worker


class _FlakyDetector:
    """Raises on its first batch, then returns one detection per image."""

    def __init__(self):
        self.calls = 0

    def detect_images(self, images, paste_masks, batch_size, uint8_wire):
        self.calls += 1
        assert paste_masks == "rle" and batch_size == 3 and uint8_wire
        if self.calls == 1:
            raise RuntimeError("kernel failed")
        return [[pt_det.Detection(box=(0.0, 0.0, 1.0, 1.0), class_id=1,
                                  score=0.5)] for _ in images]


def test_worker_reports_errors_to_every_waiter_and_keeps_serving():
    worker = BatchingWorker(_FlakyDetector(), max_batch=3, window_ms=200.0,
                            uint8_wire=True)
    try:
        errors, results = [], []
        lock = threading.Lock()

        def call():
            try:
                r = worker.submit(np.zeros((4, 4, 3), np.uint8), 30.0)
                with lock:
                    results.append(r)
            except RuntimeError as e:
                with lock:
                    errors.append(str(e))

        threads = [threading.Thread(target=call) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert errors == ["RuntimeError: kernel failed"] * 3 and not results
        assert worker.submit(np.zeros((4, 4, 3), np.uint8), 30.0)[0].score \
            == 0.5
        assert worker.batches == 2 and worker.frames == 4
    finally:
        worker.stop()
    assert not worker.thread.is_alive()


def test_detections_to_json_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_rle, "get_rle_lib", lambda: None)
    monkeypatch.setattr(pt_rle, "get_rle_lib", lambda: None)
    mask = np.zeros((50, 70), bool)
    mask[10:30, 5:40] = True
    rle = {"size": [50, 70], "counts": "PQ13"}

    def dets(cls):
        return [cls(box=(1.5, 2.0, 30.25, 40.0), class_id=3, score=0.875,
                    rle=rle),
                cls(box=(10.0, 5.0, 30.0, 40.0), class_id=80, score=0.5,
                    mask=mask),
                cls(box=(0.0, 0.0, 5.0, 5.0), class_id=1, score=0.25)]

    for n in (81, 2):
        got = _detections_to_json(dets(pt_det.Detection), n)
        assert got == jax_serve._detections_to_json(
            dets(jax_det.Detection), n)
    assert got["detections"][1]["class_label"] == "80"
    assert _detections_to_json(dets(pt_det.Detection))["detections"][0][
        "class_label"] == "car"
