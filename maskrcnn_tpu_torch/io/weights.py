"""Weight bridge and checkpoint I/O, port of `maskrcnn_tpu/io/weights.py`.

The interchange format is the JAX package's flat dict
{layer: {weight: ndarray}} keyed by Matterport layer names with HWIO
kernels (the mask deconv kernel already in HWIO). `params_from_numpy`
turns it into the port's params, the same dict with float32 torch tensors.
Checkpoints are the `.npz` files of `<layer>/<weight>` keys that the JAX
package's `save_npz_checkpoint` writes, and Matterport's Keras `.h5`
weights (`load_h5_weights`; `save_h5_weights` writes the same layout).

Keras `save_weights` layout handled:
  * per-layer groups whose datasets are named like ``conv1/kernel:0``;
  * nested models (Matterport wraps the RPN in an inner `rpn_model`) give
    doubly-qualified names ``rpn_model/rpn_conv_shared/kernel:0``: the
    *penultimate* path component is the layer name;
  * `Conv2DTranspose` kernels are stored (kh, kw, out_ch, in_ch) and are
    transposed to HWIO (kh, kw, in, out) on load (`mrcnn_mask_deconv`,
    and ViTDet's simple-feature-pyramid deconvs `sfp_p2_deconv1`,
    `sfp_p2_deconv2`, `sfp_p3_deconv`);
  * names with or without the ``:0`` tensor suffix.

`h5py` is imported only by the `.h5` functions, which raise a clear error
where it is not installed.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

_BN_WEIGHTS = ("gamma", "beta", "moving_mean", "moving_variance")
_TRANSPOSED_KERNELS = {"mrcnn_mask_deconv", "sfp_p2_deconv1",
                       "sfp_p2_deconv2", "sfp_p3_deconv"}
_RPN_LAYERS = ("rpn_conv_shared", "rpn_class_raw", "rpn_bbox_pred")


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


# ---------------------------------------------------------------------------
# Matterport-layout HDF5 (Keras save_weights)
# ---------------------------------------------------------------------------

def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading or writing .h5 weights needs the h5py package, which "
            "is not installed here; convert the file to a .npz checkpoint "
            "where h5py is available (python -m maskrcnn_tpu_torch.cli "
            "convert) and load that") from e
    return h5py


def _normalize_weight_name(name) -> tuple[str, str]:
    """'rpn_model/rpn_conv_shared/kernel:0' -> ('rpn_conv_shared', 'kernel')."""
    name = name.decode() if isinstance(name, bytes) else name
    if name.endswith(":0"):
        name = name[:-2]
    parts = name.split("/")
    if len(parts) == 1:
        return parts[0], parts[0]
    return parts[-2], parts[-1]


def load_h5_weights(path: str) -> dict[str, dict[str, np.ndarray]]:
    """Read a Matterport-layout weights.h5 into {layer: {weight: array}}."""
    h5py = _h5py()
    params: dict[str, dict[str, np.ndarray]] = {}

    def visit(name, obj):
        if not isinstance(obj, h5py.Dataset):
            return
        layer, weight = _normalize_weight_name(name)
        arr = np.asarray(obj, dtype=np.float32)
        if weight == "kernel" and layer in _TRANSPOSED_KERNELS \
                and arr.ndim == 4:
            arr = np.transpose(arr, (0, 1, 3, 2))  # (kh,kw,out,in) -> HWIO
        params.setdefault(layer, {})[weight] = arr

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        root.visititems(visit)
    if not params:
        raise ValueError(f"{path}: no weight datasets found")
    return params


def load_mask_rcnn_weights(init_params, h5_path: str, *, strict: bool = True):
    """HDF5 -> ready-to-run params (`merge_pretrained` onto `init_params`)."""
    params, _, _ = merge_pretrained(init_params, load_h5_weights(h5_path),
                                    strict=strict)
    return params


def save_h5_weights(params: Mapping[str, Mapping[str, Any]], path: str,
                    nest_rpn: bool = True) -> None:
    """Write {layer: {weight: array or tensor}} in Keras save_weights layout.

    With `nest_rpn`, the three RPN layers are written under an inner
    `rpn_model` group with doubly-qualified weight names, as Matterport's
    nested Keras model serializes them."""
    h5py = _h5py()
    tree = params_to_numpy(params)
    with h5py.File(path, "w") as f:
        layer_names = []

        def write_layer(group_name, inner):
            g = f.require_group(group_name)
            weight_names = []
            for layer, weights in inner.items():
                order = [w for w in ("kernel", "bias") if w in weights]
                order += [w for w in _BN_WEIGHTS if w in weights]
                order += [w for w in weights if w not in order]
                for w in order:
                    arr = weights[w]
                    if (w == "kernel" and layer in _TRANSPOSED_KERNELS
                            and arr.ndim == 4):
                        arr = np.transpose(arr, (0, 1, 3, 2))  # HWIO -> keras
                    qual = (f"{group_name}/{layer}/{w}:0"
                            if group_name != layer else f"{layer}/{w}:0")
                    # Keras creates each dataset inside the layer group
                    # under the full variable name (/conv1/conv1/kernel:0).
                    g.create_dataset(qual, data=arr)
                    weight_names.append(qual.encode())
            g.attrs["weight_names"] = weight_names
            layer_names.append(group_name.encode())

        nested = {k: v for k, v in tree.items()
                  if nest_rpn and k in _RPN_LAYERS}
        for layer, weights in tree.items():
            if layer not in nested:
                write_layer(layer, {layer: weights})
        if nested:
            write_layer("rpn_model", nested)
        f.attrs["layer_names"] = layer_names
