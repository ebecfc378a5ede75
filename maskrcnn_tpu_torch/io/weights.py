"""Weight bridge and checkpoint I/O, port of `maskrcnn_tpu/io/weights.py`.

The interchange format is the JAX package's flat dict
{layer: {weight: ndarray}} keyed by Matterport layer names with HWIO
kernels (the mask deconv kernel already in HWIO). `params_from_numpy`
turns it into the port's params, the same dict with float32 torch tensors.
Checkpoints are the `.npz` files of `<layer>/<weight>` keys that the JAX
package's `save_npz_checkpoint` writes.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch


def params_from_numpy(flat: Mapping[str, Mapping[str, Any]],
                      device=None) -> dict[str, dict[str, torch.Tensor]]:
    """{layer: {weight: array}} -> {layer: {weight: float32 tensor}}."""
    return {
        layer: {w: torch.tensor(np.asarray(v, np.float32), device=device)
                for w, v in weights.items()}
        for layer, weights in flat.items()}


def params_to_numpy(params: Mapping[str, Mapping[str, Any]]
                    ) -> dict[str, dict[str, np.ndarray]]:
    return {layer: {w: (v.detach().float().cpu().numpy()
                        if isinstance(v, torch.Tensor)
                        else np.asarray(v, np.float32))
                    for w, v in weights.items()}
            for layer, weights in params.items()}


def merge_pretrained(init_params: Mapping[str, Mapping[str, Any]],
                     loaded: Mapping[str, Mapping[str, np.ndarray]], *,
                     strict: bool = True):
    """Overlay loaded weights onto init params; shape-check everything.

    Returns (params, missing, unused): model layers absent from `loaded`
    (kept at their init value), and loaded layers the model does not use.
    With `strict`, any missing layer raises."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    missing: list[str] = []
    for layer, weights in init_params.items():
        if layer not in loaded:
            missing.append(layer)
            out[layer] = dict(weights)
            continue
        src = loaded[layer]
        new = {}
        for wname, init_val in weights.items():
            if wname not in src:
                raise KeyError(f"layer {layer!r}: weight {wname!r} missing "
                               f"(file has {sorted(src)})")
            arr = np.asarray(src[wname], np.float32)
            if tuple(arr.shape) != tuple(init_val.shape):
                raise ValueError(
                    f"layer {layer!r} weight {wname!r}: file shape "
                    f"{arr.shape} != model shape {tuple(init_val.shape)}")
            new[wname] = torch.tensor(arr, device=init_val.device)
        out[layer] = new
    unused = sorted(set(loaded) - set(init_params))
    if strict and missing:
        raise KeyError(
            f"weights file is missing {len(missing)} model layers, e.g. "
            f"{missing[:8]} — wrong architecture? (pass strict=False to "
            f"keep random init for missing layers)")
    return out, missing, unused


def save_npz_checkpoint(params: Mapping[str, Mapping[str, Any]], path: str,
                        dtype=np.float32) -> None:
    """Write the flat {layer/weight: array} checkpoint (same format as the
    JAX package's)."""
    flat = {f"{layer}/{w}": np.asarray(v, dtype)
            for layer, weights in params_to_numpy(params).items()
            for w, v in weights.items()}
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_npz_checkpoint(path: str) -> dict[str, dict[str, np.ndarray]]:
    out: dict[str, dict[str, np.ndarray]] = {}
    with np.load(path) as data:
        for key in data.files:
            layer, w = key.rsplit("/", 1)
            out.setdefault(layer, {})[w] = data[key].astype(np.float32)
    return out
