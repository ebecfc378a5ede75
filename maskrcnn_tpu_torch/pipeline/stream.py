"""Streaming (video) instance segmentation, port of
`maskrcnn_tpu/pipeline/stream.py`: frames go through the detector in
micro-batches, dispatched back to back with a bounded queue, with the
masks optionally pasted on the device inside the forward (`paste_size`);
then a few blocking probes measure the latency one synchronous caller sees.

On one card, every full micro-batch replays a CUDA graph of the forward
(`ForwardGraph`), captured at the first one and kept on the detector: the
host launches one graph where it dispatched several hundred kernels a
frame. Other batches (the last partial one, CPU tensors, a detector over
several devices) run the forward eagerly through `detector.run_batch`.

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

from maskrcnn_tpu_torch.models.mask_rcnn import forward
from maskrcnn_tpu_torch.ops import cuda_lib
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from maskrcnn_tpu_torch.pipeline.preprocess import quantize_canvas_u8
from maskrcnn_tpu_torch.utils.profiling import stage


@dataclasses.dataclass
class StreamStats:
    """What `run_stream` saw: `frames` in `wall_s` of the stream, and the
    latency of `latency_probes` blocking re-runs of its last full batch,
    made after the stream ends. The `*_latency_ms` fields are those re-runs,
    one caller waiting on each, not the time a frame spent inside the
    stream: that is read from the `stream.dispatch` and `stream.sync` spans
    in a profiler trace (from a batch's dispatch to the end of the first
    sync after it)."""
    frames: int
    wall_s: float
    p50_latency_ms: float
    # Tail percentiles over the same blocking probes (a frame budget is a
    # bound on every frame, not on the median).
    p95_latency_ms: float = 0.0
    p99_latency_ms: float = 0.0
    latency_probes: int = 0
    # Micro-batches of the stream (probes not counted), those of them
    # replayed from a CUDA graph, and the graphs this call captured (0 when
    # an earlier call on the detector captured the one it replays).
    batches: int = 0
    graphed_batches: int = 0
    captures: int = 0

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s else 0.0


def _sync(out: dict) -> None:
    """Read one element back to the host: on the card this waits until the
    batch (and every batch queued before it on the stream) is done."""
    out["detections"][0, 0, 0].item()


class ForwardGraph:
    """The detector's forward (`models/mask_rcnn.py::forward`) captured in
    a CUDA graph at one input shape and dtype and one `paste_size`, with
    its static input and outputs. Made once: the forward runs eagerly on a
    side stream (cuDNN's plans, the kernels' build and the allocator
    warm), then is captured.

    A call copies a batch into the static input (pageable and blocking,
    as `run_batch`'s copy) and replays the graph; it returns clones of the
    outputs, since the next replay overwrites the static ones.

    `ops/cuda_lib.launches` counts the kernels that run: the capture
    records launches without running them, so they are taken off the
    counts and added again at each replay."""

    def __init__(self, detector: MaskRCNNDetector, shape: tuple,
                 dtype: torch.dtype, paste_size: int | None):
        dev = detector.device
        self.input = torch.zeros(shape, dtype=dtype, device=dev)

        def run():
            return forward(detector.params, self.input, detector.config,
                           device=dev, paste_size=paste_size)

        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            before = dict(cuda_lib.launches)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = run()
        self.launches = {k: n - before[k]
                         for k, n in cuda_lib.launches.items()}
        self._count(-1)

    def _count(self, sign: int) -> None:
        for k, n in self.launches.items():
            cuda_lib.launches[k] += sign * n

    def __call__(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        with stage("stream.copy_in"):
            self.input.copy_(images)
        self.graph.replay()
        self._count(1)
        return {k: v.clone() for k, v in self.outputs.items()}


def forward_batch(detector: MaskRCNNDetector, batch, micro_batch: int,
                  paste_size: int | None = None
                  ) -> tuple[dict[str, torch.Tensor], bool, bool]:
    """One batch as `run_stream` dispatches it -> (outputs, graphed,
    captured). A full micro-batch on a detector with one card replays the
    detector's `ForwardGraph` for its shape, dtype and `paste_size`,
    captured here on first use; any other batch runs `run_batch`."""
    images = torch.as_tensor(batch)
    if not (detector.device.type == "cuda" and len(detector.devices) == 1
            and images.shape[0] == micro_batch):
        return detector.run_batch(images, paste_size=paste_size), False, \
            False
    key = (tuple(images.shape), images.dtype, paste_size)
    graph = detector.graphs.get(key)
    captured = graph is None
    if captured:
        with stage("stream.capture"):
            graph = detector.graphs[key] = ForwardGraph(detector, *key)
    return graph(images), True, captured


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
    `latency_probes` blocking runs of the stream's last full input batch:
    the `*_latency_ms` of the stats are those runs, not frames of the
    stream.

    On a detector with one card, each full micro-batch (and each probe of
    one) replays the detector's CUDA graph of the forward for its shape,
    dtype and `paste_size` (`ForwardGraph`, captured at the first such
    batch and kept in `detector.graphs` for later calls); the stats count
    the batches, the graphed ones and the captures. Every other batch runs
    `detector.run_batch`.

    Under a profiler the stream opens spans (`utils/profiling.stage`):
    `stream.quantize` (each frame's quantize and each batch's stack),
    `stream.dispatch` (`detector.run_batch`, or the graph's input copy
    `stream.copy_in` and replay, with the batch's dispatch index as
    `batch`), `stream.capture` (a graph's capture, inside the dispatch of
    its first batch) and `stream.sync` (a readback, with the index of the
    last batch it waits for). A frame's time in the stream runs from its
    batch's dispatch to the end of the first sync after it.
    """
    lat: list[float] = []
    n = 0
    last = None
    dispatched = graphed = captures = 0
    probe_src = None  # the last full input batch; the probes re-run it

    def dispatch(batch) -> dict:
        nonlocal graphed, captures
        out, was_graphed, captured = forward_batch(detector, batch,
                                                   micro_batch, paste_size)
        graphed += was_graphed
        captures += captured
        return out

    def run(batch) -> None:
        nonlocal n, last, dispatched, probe_src
        with stage("stream.dispatch", batch=dispatched):
            out = dispatch(batch)
        if on_result is not None:
            on_result(n, out)
        last = out
        dispatched += 1
        n += int(batch.shape[0])
        if probe_src is None or batch.shape[0] >= probe_src.shape[0]:
            probe_src = batch
        if sync_every and dispatched % sync_every == 0:
            with stage("stream.sync", batch=dispatched - 1):
                _sync(out)

    def stack(buf: list[np.ndarray]) -> np.ndarray:
        with stage("stream.quantize"):
            return np.stack(buf)

    t_start = time.perf_counter()
    if prebatched:
        for batch in frames:
            run(batch)
    else:
        buf: list[np.ndarray] = []
        for frame in frames:
            with stage("stream.quantize"):
                buf.append(quantize_canvas_u8(np.asarray(frame)))
            if len(buf) == micro_batch:
                run(stack(buf))
                buf = []
        if buf:
            run(stack(buf))
    if last is not None:
        with stage("stream.sync", batch=dispatched - 1):
            _sync(last)
    wall = time.perf_counter() - t_start

    batches, graphed_batches = dispatched, graphed
    if latency_probes and probe_src is not None:
        probe = torch.as_tensor(probe_src).to(detector.device)
        probe.reshape(-1)[0].item()  # staged on the device off the clock
        for _ in range(latency_probes):
            t0 = time.perf_counter()
            _sync(dispatch(probe))
            lat.append(time.perf_counter() - t0)
    if lat:
        ms = np.asarray(lat) * 1000.0
        p50, p95, p99 = (float(np.percentile(ms, q)) for q in (50, 95, 99))
    else:
        p50 = p95 = p99 = 0.0
    return StreamStats(frames=n, wall_s=wall, p50_latency_ms=p50,
                       p95_latency_ms=p95, p99_latency_ms=p99,
                       latency_probes=len(lat), batches=batches,
                       graphed_batches=graphed_batches, captures=captures)


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
