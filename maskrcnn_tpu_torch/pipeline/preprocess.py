"""Letterbox preprocessing to the square network input, port of the host
half of `maskrcnn_tpu/pipeline/preprocess.py`: aspect-preserving PIL
bilinear resize, centered, zero-padded; the RGB mean is subtracted inside
the forward (`models/mask_rcnn.preprocess`). Canvases may go to the device
as uint8 (`quantize_canvas_u8`); the forward casts them there."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LetterboxWindow:
    """Where the image landed inside the square canvas (pixel coords) and
    the scale applied; needed to unmold boxes and masks."""
    y1: int
    x1: int
    y2: int
    x2: int
    scale: float
    orig_height: int
    orig_width: int


def quantize_canvas_u8(canvas: np.ndarray) -> np.ndarray:
    """Round an RGB [0, 255] float canvas to uint8 (round half to even), the
    one quantization of every uint8 wire path (stream frames,
    `uint8_wire`): 4x fewer host-to-device bytes, +-0.5 of a level."""
    if canvas.dtype == np.uint8:
        return canvas
    return np.clip(np.rint(canvas), 0, 255).astype(np.uint8)


def compute_window(orig_h: int, orig_w: int, size: int) -> LetterboxWindow:
    scale = min(size / orig_h, size / orig_w)
    new_h = max(int(round(orig_h * scale)), 1)
    new_w = max(int(round(orig_w * scale)), 1)
    top = (size - new_h) // 2
    left = (size - new_w) // 2
    return LetterboxWindow(top, left, top + new_h, left + new_w, scale,
                           orig_h, orig_w)


def letterbox_numpy(image: np.ndarray, size: int
                    ) -> tuple[np.ndarray, LetterboxWindow]:
    """(H, W, 3) uint8/float RGB -> (size, size, 3) float32 canvas + window."""
    from PIL import Image

    h, w = image.shape[:2]
    win = compute_window(h, w, size)
    pil = Image.fromarray(np.asarray(image, np.uint8))
    resized = pil.resize((win.x2 - win.x1, win.y2 - win.y1), Image.BILINEAR)
    canvas = np.zeros((size, size, 3), np.float32)
    canvas[win.y1:win.y2, win.x1:win.x2] = np.asarray(resized, np.float32)
    return canvas, win
