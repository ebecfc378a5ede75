"""Streaming (video) instance segmentation, port of
`maskrcnn_tpu/pipeline/stream.py`: frames go through the detector in
micro-batches, dispatched back to back with a bounded queue, with the
masks optionally pasted on the device inside the forward (`paste_size`);
then a few blocking probes measure the latency one synchronous caller sees.

    stats = run_stream(detector, synthetic_frames(64, 1024), micro_batch=2,
                       paste_size=1024)
    stats = run_stream(detector, frames_from_dir("clip/", 1024))
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from maskrcnn_tpu_torch.pipeline.preprocess import quantize_canvas_u8


@dataclasses.dataclass
class StreamStats:
    frames: int
    wall_s: float
    p50_latency_ms: float
    # Tail percentiles over the same blocking probes (a frame budget is a
    # bound on every frame, not on the median).
    p95_latency_ms: float = 0.0
    p99_latency_ms: float = 0.0
    latency_probes: int = 0

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s else 0.0


def _sync(out: dict) -> None:
    """Read one element back to the host: on the card this waits until the
    batch (and every batch queued before it on the stream) is done."""
    out["detections"][0, 0, 0].item()


def run_stream(
    detector: MaskRCNNDetector,
    frames: Iterable,
    on_result: Callable[[int, dict], None] | None = None,
    micro_batch: int = 1,
    prebatched: bool = False,
    paste_size: int | None = None,
    latency_probes: int = 40,
    sync_every: int = 8,
) -> StreamStats:
    """Drive letterboxed (S, S, 3) frames through the detector.

    `on_result(frame_idx, outputs)` receives the raw padded outputs, still
    on the device; it must not read them back (a read waits for the card
    and serializes the stream): keep the references and decode after the
    stream ends.

    Frames are quantized to uint8 on the host (`quantize_canvas_u8`; the
    forward casts them on the device). With `prebatched=True` each item of
    `frames` is already a (micro_batch, S, S, 3) batch, a host array or a
    tensor; a tensor already on the device skips the host copy.

    Batches are dispatched back to back, with a one-element readback every
    `sync_every` batches: that bounds the outputs in flight (with
    `paste_size` each batch of 2 holds ~200 MB of pasted masks) while the
    host runs ahead of the card. Latency is measured afterwards, with
    `latency_probes` blocking runs of the stream's last full input batch.
    """
    lat: list[float] = []
    n = 0
    last = None
    dispatched = 0
    probe_src = None  # the last full input batch; the probes re-run it

    def run(batch) -> None:
        nonlocal n, last, dispatched, probe_src
        out = detector.run_batch(batch, paste_size=paste_size)
        if on_result is not None:
            on_result(n, out)
        last = out
        dispatched += 1
        n += int(batch.shape[0])
        if probe_src is None or batch.shape[0] >= probe_src.shape[0]:
            probe_src = batch
        if sync_every and dispatched % sync_every == 0:
            _sync(out)

    t_start = time.perf_counter()
    if prebatched:
        for batch in frames:
            run(batch)
    else:
        buf: list[np.ndarray] = []
        for frame in frames:
            buf.append(quantize_canvas_u8(np.asarray(frame)))
            if len(buf) == micro_batch:
                run(np.stack(buf))
                buf = []
        if buf:
            run(np.stack(buf))
    if last is not None:
        _sync(last)
    wall = time.perf_counter() - t_start

    if latency_probes and probe_src is not None:
        probe = torch.as_tensor(probe_src).to(detector.device)
        probe.reshape(-1)[0].item()  # staged on the device off the clock
        for _ in range(latency_probes):
            t0 = time.perf_counter()
            _sync(detector.run_batch(probe, paste_size=paste_size))
            lat.append(time.perf_counter() - t0)
    if lat:
        ms = np.asarray(lat) * 1000.0
        p50, p95, p99 = (float(np.percentile(ms, q)) for q in (50, 95, 99))
    else:
        p50 = p95 = p99 = 0.0
    return StreamStats(frames=n, wall_s=wall, p50_latency_ms=p50,
                       p95_latency_ms=p95, p99_latency_ms=p99,
                       latency_probes=len(lat))


def synthetic_frames(n: int, size: int, seed: int = 0
                     ) -> Iterator[np.ndarray]:
    """n (size, size, 3) uint8 frames from the seed: one random frame
    rolled 7 pixels further along x each step, so content changes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    for i in range(n):
        yield np.roll(base, shift=7 * i, axis=1)


def frames_from_dir(path: str, size: int) -> Iterator[np.ndarray]:
    """Letterboxed (size, size, 3) float32 frames from an image directory,
    sorted by name, decoded off-thread (`pipeline/loader.PrefetchLoader`)
    so frame t+1's decode overlaps frame t's forward."""
    import os

    from maskrcnn_tpu_torch.pipeline.loader import PrefetchLoader

    names = [n for n in sorted(os.listdir(path))
             if n.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))]
    items = ((n, os.path.join(path, n)) for n in names)
    for _, canvas, _ in PrefetchLoader(items, size):
        yield canvas
