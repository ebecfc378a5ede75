"""Detection rendering, port of `maskrcnn_tpu/utils/render.py`: boxes
and translucent masks onto the original image, per-class deterministic
colors, box outlines, and a label with the score above each box.
"""

from __future__ import annotations

import colorsys
from typing import Sequence

import numpy as np

from maskrcnn_tpu_torch.pipeline.detector import Detection


def class_color(class_id: int, num_classes: int = 81) -> tuple[int, int, int]:
    """Deterministic bright color per class (golden-ratio hue walk)."""
    hue = (class_id * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(hue, 0.85, 1.0)
    return int(r * 255), int(g * 255), int(b * 255)


def render_detections(
    image: np.ndarray,
    detections: Sequence[Detection],
    class_names: Sequence[str] | None = None,
    box_width: int = 3,
    mask_alpha: float = 0.4,
) -> np.ndarray:
    """(H, W, 3) uint8 + detections -> annotated uint8 image."""
    from PIL import Image, ImageDraw

    canvas = np.asarray(image, np.float32).copy()
    for d in detections:
        color = np.asarray(class_color(d.class_id), np.float32)
        if d.mask is not None:
            m = d.mask.astype(bool)
            canvas[m] = canvas[m] * (1 - mask_alpha) + color * mask_alpha

    pil = Image.fromarray(canvas.clip(0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(pil)
    for d in detections:
        y1, x1, y2, x2 = d.box
        color = class_color(d.class_id)
        draw.rectangle([x1, y1, x2, y2], outline=color, width=box_width)
        label = (class_names[d.class_id] if class_names
                 and d.class_id < len(class_names) else str(d.class_id))
        draw.text((x1 + 2, max(y1 - 12, 0)), f"{label} {d.score:.2f}",
                  fill=color)
    return np.asarray(pil)
