"""One run of one cell: the parts `run.py` and `control.py` share.

Everything is found by name from files: the cell in `BENCHMARK.json`'s
`workloads`, its configuration in `configs/<config>.json`, its traffic mix
in `traffic/<traffic>.json` (which names its driver,
`drivers/<driver>.py`), its comparison limits in `workloads/<cell>.json`,
each per-layer metric's reader in `metrics/<metric>.py`, and the
configuration's backbone (the reference's layers, weight layout,
multiply-adds and kernel work) in `reference/backbones/<architecture>.py`.
A later change adds a configuration, an architecture, a mix, a cell or a
metric by adding files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "maskrcnn_tpu")


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`benchmark/<kind>/<name>.py` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    mix: dict            # traffic/<traffic>.json
    check: dict          # workloads/<cell>.json
    bench: dict          # BENCHMARK.json

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def model_config(self):
        from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
        return MaskRCNNConfig.from_dict(self.config["config"])

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, bench_path: str | None = None) -> Cell:
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    return Cell(name=name, entry=entry,
                config=_json(HERE, "configs", entry["config"] + ".json"),
                mix=_json(HERE, "traffic", entry["traffic"] + ".json"),
                check=_json(HERE, "workloads", name + ".json"), bench=bench)


@dataclasses.dataclass
class Context:
    """What a traffic driver gets: the configuration, the raw weights,
    the device, the mix's parameters and the seed's generators."""
    cfg: Any
    params: dict
    device: torch.device
    mix: dict
    seed: int
    rng: np.random.Generator          # inputs
    sample_rng: np.random.Generator   # which outputs are judged
    sample_images: int


def make_context(cell: Cell, seed: int, device, cfg=None) -> Context:
    from benchmark.weights import make_params
    cfg = cfg or cell.model_config()
    seed = int(seed) % 2 ** 63
    return Context(cfg=cfg, params=make_params(cfg, seed, device),
                   device=torch.device(device), mix=cell.mix, seed=seed,
                   rng=np.random.default_rng([seed, 0]),
                   sample_rng=np.random.default_rng([seed, 1]),
                   sample_images=int(cell.check["sample_images"]))


def make_traffic(ctx: Context):
    return load_module("drivers", ctx.mix["driver"]).Traffic(ctx)


class Reservoir:
    """A uniform sample of k items from a stream of unknown length, drawn
    with the seed's generator (Algorithm R)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`maskrcnn_tpu_torch` is neither)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def judge(ctx: Context, cell: Cell, images, got) -> tuple[dict, bool]:
    """The reference's numbers for the judged outputs, each beside its
    limit from `workloads/<cell>.json`, and whether every one is within."""
    from benchmark.reference.check import judge as ref_judge
    limits = cell.check["limits"]
    numbers = ref_judge(ctx.params, ctx.cfg, images, got,
                        class_band=limits["class_gap"])
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return checks, ok


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}
