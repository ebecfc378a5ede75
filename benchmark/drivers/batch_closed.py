"""Closed loop of letterboxed batches through `MaskRCNNDetector.run_batch`.

Mix parameters: `batch` (images a call), `pool` (letterboxed scene
canvases made in set-up and cycled), `long_side` (the scenes' long side,
COCO val2017's 640). Each batch is copied host to device, run, and its
`detections`, `masks` and `valid` read back to the host, as
`detect_canvases` does before unmolding.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import roofline, scenes
from benchmark.harness import Reservoir


class Traffic:
    trace_steps = 6

    def __init__(self, ctx):
        from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
        self.ctx = ctx
        self.b = int(ctx.mix["batch"])
        self.pool = torch.from_numpy(scenes.photo_pool(
            ctx.rng, int(ctx.mix["pool"]), ctx.cfg.image_height,
            int(ctx.mix["long_side"])))
        self.det = MaskRCNNDetector(ctx.cfg, ctx.params, device=ctx.device)
        self.k = 0
        # whole batches are judged: `sample_images` over the batch of them
        self.kept = Reservoir(max(ctx.sample_images // self.b, 1),
                              ctx.sample_rng)
        self.traced: list = []

    def _step(self):
        s = (self.k * self.b) % self.pool.shape[0]
        self.k += 1
        out = self.det.run_batch(self.pool[s:s + self.b])
        det = out["detections"].float().cpu().numpy()
        masks = out["masks"].float().cpu().numpy()
        valid = out["valid"].cpu().numpy()
        return s, out, det, masks, valid

    def warm(self) -> None:
        for _ in range(2):
            self._step()

    def window(self, seconds: float) -> dict:
        images = failed = 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            s, out, det, masks, valid = self._step()
            images += self.b
            bad = ~(np.isfinite(det).all((1, 2))
                    & np.isfinite(masks).all((1, 2, 3)))
            failed += int(bad.sum())
            self.kept.offer((s, det, masks, valid, out["rois"],
                             out["roi_valid"]))
        wall = time.perf_counter() - t0
        return {"attempted": images, "failed": failed, "images": images,
                "seconds": wall, "metrics": {"images_per_s": images / wall}}

    def trace_step(self) -> int:
        _, out, _, _, _ = self._step()
        self.traced.append((out["rois"], out["detections"][..., :4]))
        return self.b

    def work(self) -> dict:
        return roofline.forward_work(self.ctx.cfg, self.traced)

    def judged(self):
        """The kept batches' images (uint8 canvases on the device) and the
        program's outputs for them, every slot."""
        dev = self.ctx.device
        keys = ("detections", "masks", "valid", "rois", "roi_valid")
        got = {k: torch.cat([torch.as_tensor(item[1 + i]).to(dev)
                             for item in self.kept.items])
               for i, k in enumerate(keys)}
        images = torch.cat([self.pool[s:s + self.b]
                            for s, *_ in self.kept.items]).to(dev)
        return images, got

    def release(self) -> None:
        self.det = None
        self.traced = []
