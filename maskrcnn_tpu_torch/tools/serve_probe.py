"""Load-probe the HTTP model server: concurrent clients, dynamic batching.
The port's copy of `tools/serve_probe.py`.

It starts `pipeline.serve.make_server` in-process and drives it with K
concurrent clients POSTing JPEGs, sweeping K. It reports request
throughput, latency percentiles (p50/p95/p99: a request's budget is a
bound on its own latency, not a median) and the histogram of batch sizes
the dynamic-batching worker formed (concurrent callers share one forward
on the card). A warm-up round of `--warmup-requests` requests at the
first K runs before the sweep; it is reported under `warmup` and counted
in no sweep point or histogram (the first requests run slower than
later ones).

    python3 -m maskrcnn_tpu_torch.tools.serve_probe \\
        [--weights CKPT.npz] [--config CONFIG.json] [--images DIR] \\
        [--clients 1 4 16] [--requests 64] [--warmup-requests 16] \\
        [--port 0] [--out FILE] [--device cpu]

Without `--weights` the weights are random from `--seed`; without
`--images` the bodies are 4 noise JPEGs of the config's input size. A
config JSON with `"detection_score_threshold": 0.0` makes every request
carry the full count of detections (the host work of a real one) under
random weights. `--device` defaults to the card; `--tiny --device cpu`
is a smoke run on the CPU.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import sys
import threading
import time

import numpy as np


def run_load(server, bodies, clients, requests, worker):
    """Drive `requests` total requests from `clients` threads at the
    server's bound port; return (wall_s, sorted latencies, batch-size
    histogram for this window)."""
    host, port = server.server_address[:2]
    lat: list[float] = []
    lat_lock = threading.Lock()
    remaining = [requests]
    rem_lock = threading.Lock()
    errors: list[str] = []
    hist0 = dict(worker.batch_size_counts)

    def post(body):
        conn = http.client.HTTPConnection(host, port, timeout=300)
        conn.request("POST", "/detect", body=body,
                     headers={"Content-Type": "application/octet-stream"})
        r = conn.getresponse()
        payload = json.loads(r.read())
        conn.close()
        return r.status, payload

    def client(ci):
        i = ci
        while True:
            with rem_lock:
                if remaining[0] <= 0:
                    return
                remaining[0] -= 1
            t0 = time.perf_counter()
            try:
                status, payload = post(bodies[i % len(bodies)])
                if status != 200:
                    errors.append(str(payload))
            except Exception as e:  # noqa: BLE001 — recorded, not raised
                errors.append(repr(e))
            with lat_lock:
                lat.append(time.perf_counter() - t0)
            i += clients

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(clients)]
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t_start
    if errors:
        raise RuntimeError(f"request errors: {errors[:3]}")
    hist = {n: c - hist0.get(n, 0)
            for n, c in worker.batch_size_counts.items()
            if c - hist0.get(n, 0) > 0}
    lat.sort()
    return wall, lat, hist


def pct(lat, q):
    return round(float(np.percentile(np.asarray(lat), q)) * 1000, 1)


def point(k, wall, lat, hist):
    """One sweep point's report."""
    return {
        "clients": k,
        "requests": len(lat),
        "wall_s": round(wall, 2),
        "req_per_s": round(len(lat) / wall, 2),
        "p50_latency_ms": pct(lat, 50),
        "p95_latency_ms": pct(lat, 95),
        "p99_latency_ms": pct(lat, 99),
        "batch_size_hist": {str(n): hist[n] for n in sorted(hist)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config")
    ap.add_argument("--weights")
    ap.add_argument("--images", help="dir of JPEGs to post (else synthetic)")
    ap.add_argument("--clients", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--requests", type=int, default=64,
                    help="requests per sweep point")
    ap.add_argument("--warmup-requests", type=int, default=16,
                    help="requests of the warm-up round at the first K "
                         "(not counted)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=20.0)
    ap.add_argument("--port", type=int, default=0,
                    help="default 0: any free port")
    ap.add_argument("--seed", type=int, default=0,
                    help="random weights and synthetic bodies")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (CPU smoke test)")
    ap.add_argument("--out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    from maskrcnn_tpu_torch.core.config import (MaskRCNNConfig,
                                                tiny_test_config)
    from maskrcnn_tpu_torch.models.mask_rcnn import resolve_device
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    from maskrcnn_tpu_torch.pipeline.serve import make_server
    from maskrcnn_tpu_torch.tools.flagship_proof import device_line

    device = resolve_device(args.device)   # raises without a card
    if args.tiny:
        config = tiny_test_config()
    else:
        config = (MaskRCNNConfig.from_json(args.config) if args.config
                  else MaskRCNNConfig(architecture="resnet101"))
    if args.weights:
        detector = MaskRCNNDetector.from_checkpoint(config, args.weights,
                                                    device=device)
    else:
        detector = MaskRCNNDetector.from_random(config, seed=args.seed,
                                                device=device)

    if args.images:
        paths = sorted(
            os.path.join(args.images, n) for n in os.listdir(args.images)
            if n.lower().endswith((".jpg", ".jpeg", ".png")))
        bodies = []
        for p in paths:
            with open(p, "rb") as f:
                bodies.append(f.read())
    else:
        from io import BytesIO

        from PIL import Image

        rng = np.random.default_rng(args.seed)
        bodies = []
        for _ in range(4):
            arr = rng.integers(0, 255, (config.image_height,
                                        config.image_width, 3), np.uint8)
            buf = BytesIO()
            Image.fromarray(arr).save(buf, "JPEG", quality=90)
            bodies.append(buf.getvalue())

    # one forward of the served batch shape off the serving path, at the
    # wire dtype (the kernels build and cuDNN picks its algorithms here)
    size = config.image_height
    wire_dtype = np.uint8 if not args.tiny else np.float32
    t0 = time.perf_counter()
    detector.run_batch(np.zeros((args.max_batch, size, size, 3), wire_dtype))
    print(f"# detector warmup: {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)

    # uint8 wire: the CLI production default (cli serve without --exact);
    # explicit here because the library layer defaults to the float32 wire
    server, worker = make_server(detector, port=args.port,
                                 max_batch=args.max_batch,
                                 window_ms=args.window_ms,
                                 uint8_wire=not args.tiny)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        warmup = None
        if args.warmup_requests > 0:
            k = args.clients[0]
            warmup = point(k, *run_load(server, bodies, k,
                                        args.warmup_requests, worker))
            print(f"# warmup: {json.dumps(warmup)}", file=sys.stderr)

        sweep = []
        for k in args.clients:
            sweep.append(point(k, *run_load(server, bodies, k,
                                            args.requests, worker)))
            print(json.dumps(sweep[-1]), file=sys.stderr)
    finally:
        server.shutdown()
        worker.stop()
        server.server_close()
        t.join(timeout=30)

    stats = {
        "metric": (f"serve_requests_per_sec_{config.architecture}_"
                   f"{config.image_height}"),
        "max_batch": args.max_batch,
        "window_ms": args.window_ms,
        "uint8_wire": not args.tiny,
        "weights": "trained" if args.weights else "random",
        "images": "real" if args.images else "synthetic",
        "warmup": warmup,
        "sweep": sweep,
        "device": device_line(device),
    }
    print(json.dumps(stats))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(stats, f, indent=1)
        print(f"# wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
