"""Host-side image loader, port of `maskrcnn_tpu/pipeline/loader.py` on its
PIL path: decode to RGB, letterbox to the square network input, and a
threaded prefetch that yields in input order, so the decode of batch t+1
overlaps the card's work on batch t.

The JAX package decodes JPEGs and resamples in its own C++ library where
that builds (`maskrcnn_tpu/native`), with PIL as the fallback; the port
takes the PIL path throughout (`letterbox_numpy`).

    canvas, window = load_letterboxed("img.jpg", 1024)
    for key, canvas, window in PrefetchLoader(((i, p) for i, p in ...), 1024):
        ...
"""

from __future__ import annotations

import io
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np

from maskrcnn_tpu_torch.pipeline.preprocess import (LetterboxWindow,
                                                    letterbox_numpy)


def decode_rgb(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def decode_rgb_bytes(data: bytes) -> np.ndarray:
    """Decode in-memory image bytes to (H, W, 3) uint8 RGB (the serving
    path's counterpart of `decode_rgb`)."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _ensure_rgb3(image: np.ndarray) -> np.ndarray:
    """Grayscale (H, W) / (H, W, 1) -> replicated RGB; RGBA -> RGB."""
    if image.ndim == 2:
        return np.repeat(image[:, :, None], 3, axis=2)
    if image.ndim != 3:
        raise ValueError(f"expected (H, W[, C]) image, got {image.shape}")
    if image.shape[-1] == 1:
        return np.repeat(image, 3, axis=2)
    if image.shape[-1] == 4:
        return image[..., :3]
    if image.shape[-1] != 3:
        raise ValueError(f"expected 1/3/4 channels, got {image.shape}")
    return image


def letterbox_rgb(image: np.ndarray, size: int
                  ) -> tuple[np.ndarray, LetterboxWindow]:
    """(H, W[, C]) uint8 image -> (size, size, 3) float32 canvas + window."""
    return letterbox_numpy(_ensure_rgb3(np.asarray(image)), size)


def load_letterboxed_bytes(data: bytes, size: int
                           ) -> tuple[np.ndarray, LetterboxWindow]:
    """In-memory image bytes -> letterboxed float32 canvas + window."""
    return letterbox_rgb(decode_rgb_bytes(data), size)


def load_letterboxed(path: str, size: int
                     ) -> tuple[np.ndarray, LetterboxWindow]:
    """Image file -> (size, size, 3) float32 canvas + letterbox window."""
    return letterbox_rgb(decode_rgb(path), size)


class PrefetchLoader:
    """Ordered, bounded, threaded letterbox loader.

    Iterating yields `(key, canvas, window)` in submission order while up to
    `depth` decodes run ahead on `workers` threads (PIL releases the
    interpreter lock while it decodes and resamples).
    """

    def __init__(self, items: Iterable[tuple[object, str]], size: int,
                 workers: int | None = None, depth: int | None = None):
        """`items` yields (key, path) pairs; keys pass through unchanged."""
        self._items = iter(items)
        self._size = size
        self._workers = workers or min(8, os.cpu_count() or 4)
        self._depth = depth or 2 * self._workers

    def __iter__(self) -> Iterator[tuple[object, np.ndarray,
                                         LetterboxWindow]]:
        with ThreadPoolExecutor(max_workers=self._workers) as pool:
            queue: deque = deque()

            def refill():
                while len(queue) < self._depth:
                    nxt = next(self._items, None)
                    if nxt is None:
                        return
                    key, path = nxt
                    queue.append((key, pool.submit(load_letterboxed, path,
                                                   self._size)))

            refill()
            while queue:
                key, fut = queue.popleft()
                canvas, win = fut.result()
                refill()
                yield key, canvas, win


def load_batch(paths: Sequence[str], size: int, workers: int | None = None
               ) -> tuple[np.ndarray, list[LetterboxWindow]]:
    """Decode and letterbox a list of files concurrently into one
    (B, S, S, 3) float32 batch plus per-image windows."""
    workers = workers or min(8, os.cpu_count() or 4)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = list(pool.map(lambda p: load_letterboxed(p, size), paths))
    return np.stack([c for c, _ in results]), [w for _, w in results]
