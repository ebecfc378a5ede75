"""Inputs from the seed: scene images, video frames, letterboxed canvases.

Every seed gets the same set of image sizes, in another order, so the work
a run does is the same whatever its seed; the seed changes the content.
The letterbox is the benchmark's own (PIL bilinear resize, centered,
zero padding, rounded to uint8), so the program and the reference get the
same canvases.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def coco_sizes(n: int, long_side: int = 640, aspect=(0.56, 1.0)
               ) -> list[tuple[int, int]]:
    """n (h, w) sizes like COCO val2017's: the long side fixed, the short
    side's ratio spread evenly over `aspect`, landscape and portrait in
    turn."""
    sizes = []
    for i, a in enumerate(np.linspace(aspect[0], aspect[1], n)):
        short = int(round(long_side * a))
        sizes.append((short, long_side) if i % 2 == 0 else (long_side, short))
    return sizes


def synthetic_photo(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8: gradients, a few rectangles and noise, so JPEG and
    the detector see some structure (`chip_smoke.py::synthetic_photo`)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx * 255 / w, yy * 255 / h,
                    (xx + yy) * 127 / (h + w)], -1)
    for _ in range(6):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        img[y0:y0 + rng.integers(h // 8, h // 2),
            x0:x0 + rng.integers(w // 8, w // 2)] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 12, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def letterbox(image: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (size, size, 3) uint8 canvas: aspect-preserving
    bilinear resize, centered, zero padding."""
    h, w = image.shape[:2]
    scale = min(size / h, size / w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    top, left = (size - nh) // 2, (size - nw) // 2
    resized = Image.fromarray(image).resize((nw, nh), Image.BILINEAR)
    canvas = np.zeros((size, size, 3), np.uint8)
    canvas[top:top + nh, left:left + nw] = np.asarray(resized)
    return canvas


def photo_pool(rng: np.random.Generator, n: int, size: int,
               long_side: int = 640) -> np.ndarray:
    """(n, size, size, 3) uint8 letterboxed scenes at COCO sizes."""
    sizes = coco_sizes(n, long_side)
    order = rng.permutation(n)
    return np.stack([letterbox(synthetic_photo(rng, *sizes[i]), size)
                     for i in order])


def video_pool(rng: np.random.Generator, n: int, size: int,
               frame_hw=(720, 1280), shapes: int = 8) -> np.ndarray:
    """(n, size, size, 3) uint8 letterboxed frames of one clip: a fixed
    background and `shapes` rectangles of fixed colors moving at constant
    speeds, drawn from the seed."""
    h, w = frame_hw
    base = synthetic_photo(rng, h, w)
    hs = rng.integers(h // 10, h // 3, shapes)
    ws = rng.integers(w // 10, w // 3, shapes)
    pos = rng.uniform(0, 1, (shapes, 2)) * [h, w]
    vel = rng.uniform(-12, 12, (shapes, 2))
    colors = rng.integers(0, 256, (shapes, 3), dtype=np.uint8)
    frames = []
    for t in range(n):
        frame = base.copy()
        for k in range(shapes):
            y, x = (pos[k] + t * vel[k]) % [h, w]
            y, x = int(y), int(x)
            frame[y:y + hs[k], x:x + ws[k]] = colors[k]
        frames.append(letterbox(frame, size))
    return np.stack(frames)
