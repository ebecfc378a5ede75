"""Deployment export: the detector forward as a `torch.export` program,
port of `maskrcnn_tpu/io/export.py` (which stages the JAX forward out as a
TF SavedModel through jax2tf).

The program is the whole single-batch forward (`models/mask_rcnn.py::
forward`) with the weights as buffers and the anchors and preprocess
baked in, traced at a static `[batch, H, W, 3]` float32 input. It writes
`model.pt2` (`torch.export.save`) and the config beside it
(`config.json`). Its outputs are `detections`, `masks`, `valid`, and
`pasted` when `paste_size` is set.

The kernels K1-K6 enter the program as the custom ops they are
(`maskrcnn_tpu_torch::*`, `ops/__init__.py`), so the program runs on the
device it was exported for (default: the card; `device="cpu"` for the
plain versions) and calls the kernels there. To load it:

    import maskrcnn_tpu_torch.ops          # registers the ops first
    program = torch.export.load("out/model.pt2").module()
    out = program(images)                  # {"detections": ..., ...}
"""

from __future__ import annotations

import os

import numpy as np
import torch

import maskrcnn_tpu_torch.ops  # noqa: F401  (registers the kernels' ops)
from maskrcnn_tpu_torch.models.mask_rcnn import forward, resolve_device

PROGRAM = "model.pt2"


def _keys(paste_size) -> tuple[str, ...]:
    return ("detections", "masks", "valid") + (
        ("pasted",) if paste_size else ())


class DetectorProgram(torch.nn.Module):
    """The forward over fixed params (buffers `<layer>__<weight>`)."""

    def __init__(self, params, config, paste_size: int | None = None):
        super().__init__()
        self.config = config
        self.paste_size = paste_size
        self.names = [(layer, w) for layer, ws in params.items()
                      for w in ws]
        for layer, w in self.names:
            self.register_buffer(f"{layer}__{w}", params[layer][w])

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        params: dict = {}
        for layer, w in self.names:
            params.setdefault(layer, {})[w] = getattr(self, f"{layer}__{w}")
        out = forward(params, images, self.config, device=images.device,
                      paste_size=self.paste_size)
        return {k: out[k] for k in _keys(self.paste_size)}


def export_program(params, config, out_dir: str, batch: int = 1,
                   paste_size: int | None = None, device=None) -> str:
    """Trace the forward at a static (batch, H, W, 3) float32 input on
    `device` (default: the card) and write `model.pt2` and `config.json`
    under `out_dir`; returns the program's path."""
    dev = resolve_device(device)
    # each buffer its own storage: the archive stores whole storages
    module = DetectorProgram(
        {k: {w: v.detach().to(dev).clone() for w, v in ws.items()}
         for k, ws in params.items()}, config, paste_size)
    example = torch.zeros((batch, config.image_height, config.image_width,
                           3), dtype=torch.float32, device=dev)
    program = torch.export.export(module, (example,))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, PROGRAM)
    torch.export.save(program, path)
    config.to_json(os.path.join(out_dir, "config.json"))
    return path


def load_program(out_dir: str) -> torch.nn.Module:
    """The saved program as a callable module."""
    return torch.export.load(os.path.join(out_dir, PROGRAM)).module()


def verify_program(out_dir: str, params, config, batch: int = 1,
                   seed: int = 0, paste_size: int | None = None,
                   device=None) -> float:
    """Reload the program and compare it with the eager `forward` on one
    random batch from `seed`, on `device` (the export's); returns the
    largest absolute difference over the outputs (`valid` and `pasted` as
    numbers). `paste_size` must match the export's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(
        0, 255, (batch, config.image_height, config.image_width, 3)
    ).astype(np.float32)).to(dev)
    want = forward(params, images, config, device=dev, paste_size=paste_size)
    with torch.no_grad():
        got = load_program(out_dir)(images)
    worst = 0.0
    for k in _keys(paste_size):
        a, b = want[k].float(), got[k].float()
        if a.numel():
            worst = max(worst, float((a - b).abs().max()))
    return worst
