"""User-facing detector: params on the card -> forward -> unmold on the host.
Port of `maskrcnn_tpu/pipeline/detector.py` (one device, or every batch
split over several with `data_parallel`; masks pasted on the host by the
native library, PIL's bilinear resample its fallback, as full boolean
canvases or as COCO RLE of the box region only, or on the device by
`run_batch(..., paste_size=S)`).

    det = MaskRCNNDetector.from_checkpoint(MaskRCNNConfig(), "ckpt.npz")
    results = det.detect_images([img1, img2])   # list of list[Detection]
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
from maskrcnn_tpu_torch.evalkit import mask_rle
from maskrcnn_tpu_torch.models.mask_rcnn import (init_mask_rcnn,
                                                 resolve_device)
from maskrcnn_tpu_torch.parallel.mesh import (data_parallel_forward,
                                              make_mesh, replicate)
from maskrcnn_tpu_torch.pipeline.loader import letterbox_rgb
from maskrcnn_tpu_torch.pipeline.preprocess import (LetterboxWindow,
                                                    quantize_canvas_u8)
from maskrcnn_tpu_torch.utils.profiling import stage


@dataclasses.dataclass
class Detection:
    """One decoded instance: pixel box in the ORIGINAL image frame, class
    id, score, and optionally a full-size boolean mask or its COCO RLE."""
    box: tuple[float, float, float, float]  # (y1, x1, y2, x2) pixels
    class_id: int
    score: float
    mask: np.ndarray | None = None  # (orig_h, orig_w) bool, if pasted
    #: COCO RLE dict {"size": [h, w], "counts": str} when unmolded with
    #: paste_masks="rle": O(box area) per detection instead of a canvas.
    rle: dict | None = None


class MaskRCNNDetector:
    """A config plus its params on one device (default: the card).

    `data_parallel`: split each batch over this many devices of
    `device`'s kind (0: `device` alone, -1: all; `parallel/mesh.py`), the
    params replicated on each once. `devices` lists the devices and
    `replicas` the params on each; `params` is the first copy. `graphs`
    holds the CUDA graphs of the forward that `run_stream` captured on
    this detector, by input shape, dtype and `paste_size`
    (`pipeline/stream.py::ForwardGraph`)."""

    def __init__(self, config: MaskRCNNConfig, params: dict[str, Any],
                 mask_threshold: float = 0.5, device=None,
                 data_parallel: int = 0):
        self.config = config
        self.device = resolve_device(device)
        self.mask_threshold = mask_threshold
        self.devices = (make_mesh(data_parallel, self.device.type)
                        if data_parallel else [self.device])
        self.replicas = replicate(self.devices, params)
        self.params = self.replicas[0]
        self.graphs: dict[tuple, Any] = {}

    @classmethod
    def from_random(cls, config: MaskRCNNConfig, seed: int = 0, device=None):
        gen = torch.Generator().manual_seed(seed)
        return cls(config, init_mask_rcnn(gen, config), device=device)

    @classmethod
    def from_checkpoint(cls, config: MaskRCNNConfig, path: str, device=None):
        """A `.npz` checkpoint (`<layer>/<weight>` keys, the JAX package's
        format) or, for any other name, Matterport `.h5` weights (needs
        h5py); every model layer must be present."""
        from maskrcnn_tpu_torch.io.weights import (load_h5_weights,
                                                   load_npz_checkpoint,
                                                   merge_pretrained)
        init = init_mask_rcnn(torch.Generator().manual_seed(0), config)
        loaded = (load_npz_checkpoint(path) if path.endswith(".npz")
                  else load_h5_weights(path))
        params, _, _ = merge_pretrained(init, loaded)
        return cls(config, params, device=device)

    # --- device step -------------------------------------------------------

    def run_batch(self, images, paste_size: int | None = None
                  ) -> dict[str, torch.Tensor]:
        """(B, S, S, 3) RGB [0, 255] letterboxed batch (host array or
        tensor; a tensor already on the device is not copied) -> raw padded
        outputs (normalized coordinates, on the device). `paste_size` also
        pastes full-resolution uint8 masks on the device
        (`out["pasted"]`). Over several devices the batch is padded to a
        multiple of their count and cut into one shard each."""
        with stage("detector.run_batch"):
            images = torch.as_tensor(images)
            b = images.shape[0]
            pad = (-b) % len(self.devices)
            if pad:
                # pad in the batch's own dtype: a uint8 batch stays uint8
                images = torch.cat([images, images.new_zeros(
                    (pad, *images.shape[1:]))])
            out = data_parallel_forward(self.devices, self.config,
                                        self.replicas, images,
                                        paste_size=paste_size)
            return {k: v[:b] for k, v in out.items()} if pad else out

    # --- host decode -------------------------------------------------------

    def detect_images(self, images: Sequence[np.ndarray],
                      paste_masks: bool | str = True,
                      batch_size: int | None = None,
                      uint8_wire: bool = False) -> list[list[Detection]]:
        """Arbitrary-size uint8 images, (H, W), (H, W, 1), RGB or RGBA ->
        per-image decoded detections.

        `paste_masks`: True -> full-canvas boolean masks; "rle" -> COCO RLE
        dicts only, O(box area) per detection (evaluate, serve); False ->
        boxes only. `batch_size` pads the last chunk to a full batch (None
        = one batch of len(images)). `uint8_wire`: see `detect_canvases`."""
        if not images:
            return []
        size = self.config.image_height
        canvases, windows = [], []
        for img in images:
            canvas, win = letterbox_rgb(img, size)
            canvases.append(canvas)
            windows.append(win)
        return self.detect_canvases(canvases, windows,
                                    paste_masks=paste_masks,
                                    batch_size=batch_size,
                                    uint8_wire=uint8_wire)

    def detect_canvases(self, canvases: Sequence[np.ndarray],
                        windows: Sequence[LetterboxWindow],
                        paste_masks: bool | str = True,
                        batch_size: int | None = None,
                        uint8_wire: bool = False) -> list[list[Detection]]:
        """Letterboxed (S, S, 3) float32 canvases and their windows ->
        per-image decoded detections.

        `uint8_wire`: quantize the canvases to uint8 before the host to
        device copy (`quantize_canvas_u8`, +-0.5 of a level): 4x fewer
        bytes on the wire."""
        if not canvases:
            return []
        if uint8_wire:
            canvases = [quantize_canvas_u8(c) for c in canvases]
        results: list[list[Detection]] = []
        bs = batch_size or len(canvases)
        for start in range(0, len(canvases), bs):
            chunk = list(canvases[start:start + bs])
            n_real = len(chunk)
            while len(chunk) < bs:
                chunk.append(np.zeros_like(chunk[0]))
            out = self.run_batch(torch.from_numpy(np.stack(chunk)))
            det = out["detections"].float().cpu().numpy()
            masks = out["masks"].float().cpu().numpy()
            valid = out["valid"].cpu().numpy()
            for i in range(n_real):
                results.append(self.unmold(det[i], masks[i], valid[i],
                                           windows[start + i],
                                           paste_masks=paste_masks))
        return results

    def unmold(self, detections: np.ndarray, masks: np.ndarray,
               valid: np.ndarray, win: LetterboxWindow,
               paste_masks: bool | str = True) -> list[Detection]:
        """Normalized canvas coordinates -> original image pixels (the
        Matterport denorm convention, then the letterbox inverse)."""
        s = self.config.image_height - 1
        results: list[Detection] = []
        for row, mask, ok in zip(detections, masks, valid):
            if not ok:
                continue
            y1, x1, y2, x2, class_id, score = row
            cy1, cx1 = y1 * s, x1 * s
            cy2, cx2 = y2 * s + 1, x2 * s + 1
            oy1 = float(np.clip((cy1 - win.y1) / win.scale, 0,
                                win.orig_height))
            oy2 = float(np.clip((cy2 - win.y1) / win.scale, 0,
                                win.orig_height))
            ox1 = float(np.clip((cx1 - win.x1) / win.scale, 0,
                                win.orig_width))
            ox2 = float(np.clip((cx2 - win.x1) / win.scale, 0,
                                win.orig_width))
            box = (oy1, ox1, oy2, ox2)
            shape = (win.orig_height, win.orig_width)
            full = rle = None
            if paste_masks == "rle":
                region, ry, rx = paste_mask_region(mask, box, shape,
                                                   self.mask_threshold)
                r = mask_rle.encode_region(region, ry, rx, *shape)
                rle = {"size": [shape[0], shape[1]],
                       "counts": mask_rle.to_coco_counts(r)}
            elif paste_masks:
                full = paste_mask(mask, box, shape, self.mask_threshold)
            results.append(Detection(box=box, class_id=int(class_id),
                                     score=float(score), mask=full,
                                     rle=rle))
        return results


def paste_window(box, image_shape) -> tuple[int, int, int, int]:
    """The clipped integer rectangle a paste writes: (yy1, xx1, yy2, xx2)."""
    oy1, ox1, oy2, ox2 = box
    y0, x0 = int(np.rint(oy1)), int(np.rint(ox1))
    bh = max(int(np.rint(oy2)) - y0, 1)
    bw = max(int(np.rint(ox2)) - x0, 1)
    return (max(y0, 0), max(x0, 0),
            min(y0 + bh, image_shape[0]), min(x0 + bw, image_shape[1]))


def paste_mask_region(mask: np.ndarray, box, image_shape,
                      threshold: float = 0.5
                      ) -> tuple[np.ndarray, int, int]:
    """Only the clipped box region of `paste_mask`:
    ((yy2-yy1, xx2-xx1) bool, yy1, xx1). The canvas is zero everywhere
    else, so its consumer (`mask_rle.encode_region`) never builds or scans
    the full image: O(box area) per detection on the native path."""
    yy1, xx1, yy2, xx2 = paste_window(box, image_shape)
    if yy1 >= yy2 or xx1 >= xx2:
        return np.zeros((0, 0), bool), yy1, xx1

    from maskrcnn_tpu_torch.native import get_imageio_lib

    lib = get_imageio_lib()
    if lib is not None:
        import ctypes

        m = np.ascontiguousarray(mask, np.float32)
        region = np.empty((yy2 - yy1, xx2 - xx1), np.uint8)
        rc = lib.img_paste_mask_region(
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), m.shape[0],
            float(box[0]), float(box[1]), float(box[2]), float(box[3]),
            image_shape[0], image_shape[1], float(threshold),
            region.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            xx2 - xx1)
        if rc == 0:
            return region.view(bool), yy1, xx1

    full = paste_mask(mask, box, image_shape, threshold)
    return full[yy1:yy2, xx1:xx2], yy1, xx1


def paste_mask(mask: np.ndarray, box, image_shape,
               threshold: float = 0.5) -> np.ndarray:
    """Scale an (m, m) soft mask into its box and paste it into a full-size
    boolean canvas (Matterport `unmold_mask`): in the native library where
    it built, else with the PIL bilinear resample that it replicates."""
    from maskrcnn_tpu_torch.native import get_imageio_lib

    lib = get_imageio_lib()
    if lib is not None:
        import ctypes

        m = np.ascontiguousarray(mask, np.float32)
        canvas = np.empty(image_shape, np.uint8)
        rc = lib.img_paste_mask(
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), m.shape[0],
            float(box[0]), float(box[1]), float(box[2]), float(box[3]),
            image_shape[0], image_shape[1], float(threshold),
            canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == 0:
            return canvas.view(bool)

    from PIL import Image

    oy1, ox1, oy2, ox2 = box
    y0, x0 = int(np.rint(oy1)), int(np.rint(ox1))
    h = max(int(np.rint(oy2)) - y0, 1)
    w = max(int(np.rint(ox2)) - x0, 1)
    resized = Image.fromarray((np.asarray(mask) * 255).astype(np.uint8)
                              ).resize((w, h), Image.BILINEAR)
    resized = np.asarray(resized, np.float32) / 255.0
    canvas = np.zeros(image_shape, bool)
    yy1, xx1, yy2, xx2 = paste_window(box, image_shape)
    if yy1 < yy2 and xx1 < xx2:
        canvas[yy1:yy2, xx1:xx2] = (
            resized[yy1 - y0:yy2 - y0, xx1 - x0:xx2 - x0] >= threshold)
    return canvas
