"""Video through `pipeline/stream.py::run_stream`, outputs kept on the card.

Mix parameters: `micro_batch`, `paste_size`, `sync_every` (run_stream's
own), `pool` (letterboxed frames of one synthetic clip, made in set-up and
cycled), `frame_hw` (the clip's frame size). `latency_probes` is 0: the
window is the stream itself. Frames complete at run_stream's syncs; the
window ends after its last one.
"""

from __future__ import annotations

import time

import torch

from benchmark import roofline, scenes
from benchmark.harness import Reservoir


class Traffic:
    trace_steps = 3

    def __init__(self, ctx):
        from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
        self.ctx = ctx
        mix = ctx.mix
        self.pool = scenes.video_pool(ctx.rng, int(mix["pool"]),
                                      ctx.cfg.image_height,
                                      tuple(mix["frame_hw"]))
        self.det = MaskRCNNDetector(ctx.cfg, ctx.params, device=ctx.device)
        self.kw = dict(micro_batch=int(mix["micro_batch"]),
                       paste_size=int(mix["paste_size"]),
                       sync_every=int(mix["sync_every"]), latency_probes=0)
        # one block of `sample_images` consecutive frames is judged
        self.kept = Reservoir(1, ctx.sample_rng)
        self.traced: list = []
        self.next = 0

    def _frames(self, count=None, end=None):
        n = 0
        while (count is None or n < count) and (
                end is None or time.perf_counter() < end):
            yield self.pool[self.next % len(self.pool)]
            self.next += 1
            n += 1

    def _run(self, frames, on_result=None):
        from maskrcnn_tpu_torch.pipeline.stream import run_stream
        return run_stream(self.det, frames, on_result=on_result, **self.kw)

    def warm(self) -> None:
        self._run(self._frames(count=2 * self.kw["sync_every"]))

    def window(self, seconds: float) -> dict:
        first, k = self.next, self.ctx.sample_images
        block: list = []

        def keep(n, out):
            nonlocal block
            for j in range(out["detections"].shape[0]):
                block.append(((first + n + j) % len(self.pool),
                              {key: v[j:j + 1] for key, v in out.items()}))
                if len(block) == k:
                    self.kept.offer(block)
                    block = []

        t0 = time.perf_counter()
        stats = self._run(self._frames(end=t0 + seconds), keep)
        wall = time.perf_counter() - t0
        if not self.kept.items:          # fewer frames than a block
            self.kept.offer(block)
        return {"attempted": stats.frames, "failed": 0,
                "images": stats.frames, "seconds": wall,
                "metrics": {"frames_per_s": stats.frames / wall}}

    def trace_step(self) -> int:
        def keep(n, out):
            self.traced.append((out["rois"], out["detections"][..., :4]))
        return self._run(self._frames(count=self.kw["sync_every"]),
                         keep).frames

    def work(self) -> dict:
        return roofline.forward_work(self.ctx.cfg, self.traced)

    def judged(self):
        dev = self.ctx.device
        keys = ("detections", "masks", "valid", "rois", "roi_valid",
                "pasted")
        frames = self.kept.items[0]
        idx = [i for i, _ in frames]
        got = {k: torch.cat([out[k] for _, out in frames]) for k in keys}
        images = torch.from_numpy(self.pool[idx]).to(dev)
        return images, got

    def release(self) -> None:
        self.det = None
        self.traced = []
