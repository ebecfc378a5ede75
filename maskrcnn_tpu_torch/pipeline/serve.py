"""HTTP model server with dynamic micro-batching, port of
`maskrcnn_tpu/pipeline/serve.py`. Requests that arrive within a short
window are batched into one forward on the card, so concurrent callers
share its fixed cost; a single configured batch shape, with tail padding
(`MaskRCNNDetector.detect_images` semantics).

Endpoints:
  GET  /healthz           -> {"status": "ok", "batches", "frames", ...}
  POST /detect            -> image bytes (anything PIL opens) in the body;
                             JSON response with boxes in source-image pixel
                             coordinates, class ids and labels, scores, and
                             each mask as COCO compressed RLE (column-major:
                             decode with `evalkit.mask_rle` or pycocotools).

The forward and its readback run on the worker's own thread (the kernels
launch on that thread's current CUDA stream); request threads see only
host arrays. Standard library only (http.server + threading).

    server, worker = make_server(detector, port=8389, max_batch=8)
    server.serve_forever()
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np


@dataclass
class _Pending:
    image: np.ndarray
    done: threading.Event
    result: Any = None
    error: str | None = None


class BatchingWorker:
    """Collects requests for up to `window_ms` (or `max_batch`) and runs
    them through the detector as one padded batch."""

    def __init__(self, detector, max_batch: int = 8, window_ms: float = 5.0,
                 uint8_wire: bool = False):
        self.detector = detector
        self.max_batch = max_batch
        self.window_ms = window_ms
        self.uint8_wire = uint8_wire
        self.q: queue.Queue[_Pending] = queue.Queue()
        self.batches = 0
        self.frames = 0
        # batch_size_counts[n]: batches formed with exactly n requests, the
        # evidence that dynamic batching engages under concurrent load.
        self.batch_size_counts: dict[int, int] = {}
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, image: np.ndarray, timeout_s: float = 60.0):
        p = _Pending(image=image, done=threading.Event())
        self.q.put(p)
        if not p.done.wait(timeout_s):
            raise TimeoutError("inference timed out")
        if p.error:
            raise RuntimeError(p.error)
        return p.result

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=5.0)

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.window_ms / 1000.0
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                # "rle": region paste and encode per detection, O(box area);
                # the response carries RLE, so full canvases would be waste.
                # uint8_wire is opt-in at this layer (the CLI passes True
                # unless --exact): it is a +-0.5 level numerics change.
                results = self.detector.detect_images(
                    [p.image for p in batch], paste_masks="rle",
                    batch_size=self.max_batch, uint8_wire=self.uint8_wire)
                for p, r in zip(batch, results):
                    p.result = r
            except Exception as e:  # report to every waiter, keep serving
                for p in batch:
                    p.error = f"{type(e).__name__}: {e}"
            self.batches += 1
            self.frames += len(batch)
            n = len(batch)
            self.batch_size_counts[n] = self.batch_size_counts.get(n, 0) + 1
            for p in batch:
                p.done.set()


def _detections_to_json(dets, num_classes: int = 81) -> dict:
    from maskrcnn_tpu_torch.core.coco_names import class_name
    from maskrcnn_tpu_torch.evalkit.mask_rle import encode, to_coco_counts

    out = []
    for d in dets:
        row = {
            "class_id": int(d.class_id),
            "class_label": class_name(int(d.class_id), num_classes),
            "score": float(d.score),
            "box_yxyx": [float(v) for v in d.box],
        }
        if d.rle is not None:
            row["mask_rle"] = d.rle
        elif d.mask is not None:
            rle = encode(np.asarray(d.mask, np.uint8))
            row["mask_rle"] = {"size": [rle.h, rle.w],
                               "counts": to_coco_counts(rle)}
        out.append(row)
    return {"detections": out}


def make_server(detector, host: str = "127.0.0.1", port: int = 8389,
                max_batch: int = 8, window_ms: float = 5.0,
                uint8_wire: bool = False):
    """Build (server, worker); call server.serve_forever() to run.

    `uint8_wire` quantizes request canvases before the copy to the card
    (+-0.5 of a level; request pixels are 8-bit anyway). It is off by
    default at this library layer, so direct callers never inherit a
    numerics change; `cli serve` passes True unless --exact."""
    from maskrcnn_tpu_torch.pipeline.loader import decode_rgb_bytes

    worker = BatchingWorker(detector, max_batch=max_batch,
                            window_ms=window_ms, uint8_wire=uint8_wire)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "batches": worker.batches,
                    "frames": worker.frames,
                    "max_batch": worker.max_batch,
                })
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/detect":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                img = decode_rgb_bytes(self.rfile.read(n))
                t0 = time.perf_counter()
                dets = worker.submit(img)
                payload = _detections_to_json(
                    dets, detector.config.num_classes)
                payload["latency_ms"] = round(
                    (time.perf_counter() - t0) * 1000, 2)
                self._send(200, payload)
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    server.worker = worker  # for tests and shutdown
    return server, worker
