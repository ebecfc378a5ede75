"""The reference's backbones: one file an architecture, found by name.

`<architecture>.py` in this directory (the configuration's `architecture`
string; names may hold dots) holds everything of one backbone that the
reference, the weights and the roofline read, so that a new backbone is
added by adding its file. Files whose name starts with `_` hold code that
several architectures share and are no architecture. A file gives:

  * `param_shapes(cfg) -> {layer: {weight: shape}}`: the backbone's and
    its neck's layers, up to and including `fpn_p5`, in the order in which
    `weights.make_params` draws them from the seed (the RPN and the heads
    follow, from `model.param_shapes`);
  * `pyramid(params, x, cfg, nx) -> [P2, P3, P4, P5, P6]`: NCHW float32
    from the mean-subtracted NCHW float32 canvas, every convolution and
    matmul operand through `nx.q` (so the float8 control covers it);
  * `macs(cfg) -> {"backbone": ..., "fpn": ...}`: multiply-adds per image,
    which `roofline.model_macs` sums with the RPN's and the heads';
  * `init_std(layer, shape) -> float | None`: the normal scale of a
    kernel the file wants drawn otherwise than He-normal over its fan-in
    (None: that default);

and where it needs them:

  * `init_range(layer, weight, shape) -> (lo, hi) | None`: the uniform
    range of a non-kernel weight (None, or no such function:
    `weights.BN_RANGES`, else the bias range);
  * `kernel_work(cfg, b) -> {family: [(bytes, flops, peak), ...]}`: the
    port kernels the backbone runs in one forward of `b` images, for
    `roofline.forward_work` (no such function: it runs none).
"""

from __future__ import annotations

import importlib.util
import os

DIR = os.path.dirname(os.path.abspath(__file__))
_loaded: dict[str, object] = {}


def load(architecture: str):
    """`<DIR>/<architecture>.py` as a module, imported on first use."""
    path = os.path.join(DIR, architecture + ".py")
    if path not in _loaded:
        if not os.path.isfile(path):
            raise ValueError(f"no reference backbone for architecture "
                             f"{architecture!r}: {path} does not exist")
        spec = importlib.util.spec_from_file_location(
            "benchmark_backbone_" + architecture.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def names() -> list[str]:
    """Every architecture with a file in `DIR`."""
    return sorted(n[:-3] for n in os.listdir(DIR)
                  if n.endswith(".py") and not n.startswith("_"))
