"""Host-side image loader, port of `maskrcnn_tpu/pipeline/loader.py`:
decode to RGB, letterbox to the square network input, and a threaded
prefetch that yields in input order, so the decode of batch t+1 overlaps
the card's work on batch t.

JPEG decode and the letterbox resample run in C++
(`maskrcnn_tpu_torch/native`, `src/imageio.cpp`; ctypes releases the
interpreter lock, so the prefetch threads decode in parallel). Every entry
point falls back to PIL when that library did not build, and for other
formats (JPEGs too where the library was built without libjpeg); the two
agree within ~1 level (`letterbox_numpy`).

    canvas, window = load_letterboxed("img.jpg", 1024)
    for key, canvas, window in PrefetchLoader(((i, p) for i, p in ...), 1024):
        ...
"""

from __future__ import annotations

import ctypes
import io
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np

from maskrcnn_tpu_torch.native import get_imageio_lib
from maskrcnn_tpu_torch.pipeline.preprocess import (LetterboxWindow,
                                                    letterbox_numpy)

_JPEG_EXTS = (".jpg", ".jpeg", ".jpe", ".jfif")


def _window_from_meta(meta: np.ndarray) -> LetterboxWindow:
    return LetterboxWindow(
        y1=int(meta[0]), x1=int(meta[1]), y2=int(meta[2]), x2=int(meta[3]),
        scale=float(meta[4]), orig_height=int(meta[5]),
        orig_width=int(meta[6]))


def decode_rgb(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB (native for JPEG)."""
    lib = get_imageio_lib()
    if (lib is not None and lib.has_jpeg
            and path.lower().endswith(_JPEG_EXTS)):
        hw = np.zeros(2, np.int64)
        p_hw = hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        if lib.img_jpeg_dims(path.encode(), p_hw) == 0 and hw.min() > 0:
            out = np.empty((int(hw[0]), int(hw[1]), 3), np.uint8)
            rc = lib.img_decode_jpeg(
                path.encode(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.size, p_hw)
            if rc == 0:
                return out
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def decode_rgb_bytes(data: bytes) -> np.ndarray:
    """Decode in-memory image bytes to (H, W, 3) uint8 RGB (the serving
    path's counterpart of `decode_rgb`; native for JPEG payloads)."""
    lib = get_imageio_lib()
    if (lib is not None and lib.has_jpeg
            and data[:2] == b"\xff\xd8"):  # JPEG magic
        buf = np.frombuffer(data, np.uint8)
        p_buf = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        hw = np.zeros(2, np.int64)
        p_hw = hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        if lib.img_jpeg_dims_mem(p_buf, len(data), p_hw) == 0 \
                and hw.min() > 0:
            out = np.empty((int(hw[0]), int(hw[1]), 3), np.uint8)
            rc = lib.img_decode_jpeg_mem(
                p_buf, len(data),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.size, p_hw)
            if rc == 0:
                return out
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _ensure_rgb3(image: np.ndarray) -> np.ndarray:
    """Grayscale (H, W) / (H, W, 1) -> replicated RGB; RGBA -> RGB.
    The native resampler reads exactly H*W*3 bytes."""
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
    """(H, W[, C]) uint8 image -> (size, size, 3) float32 canvas + window,
    native resample when available (PIL fallback otherwise)."""
    image = _ensure_rgb3(np.asarray(image))
    lib = get_imageio_lib()
    if lib is None:
        return letterbox_numpy(image, size)
    img = np.ascontiguousarray(image, np.uint8)
    canvas = np.empty((size, size, 3), np.float32)
    meta = np.zeros(7, np.float64)
    rc = lib.img_letterbox_rgb8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0], img.shape[1], size,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return letterbox_numpy(image, size)
    return canvas, _window_from_meta(meta)


def load_letterboxed_bytes(data: bytes, size: int
                           ) -> tuple[np.ndarray, LetterboxWindow]:
    """In-memory image bytes -> letterboxed float32 canvas + window (JPEG
    payloads decode and resample in one native call)."""
    lib = get_imageio_lib()
    if (lib is not None and lib.has_jpeg
            and data[:2] == b"\xff\xd8"):
        buf = np.frombuffer(data, np.uint8)
        canvas = np.empty((size, size, 3), np.float32)
        meta = np.zeros(7, np.float64)
        rc = lib.img_decode_letterbox_jpeg_mem(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            size, canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc == 0:
            return canvas, _window_from_meta(meta)
    return letterbox_rgb(decode_rgb_bytes(data), size)


def load_letterboxed(path: str, size: int
                     ) -> tuple[np.ndarray, LetterboxWindow]:
    """Image file -> (size, size, 3) float32 canvas + letterbox window.

    JPEGs take the fused native path (decode and resample never cross back
    into Python); other formats decode via PIL and resample natively.
    """
    lib = get_imageio_lib()
    if (lib is not None and lib.has_jpeg
            and path.lower().endswith(_JPEG_EXTS)):
        canvas = np.empty((size, size, 3), np.float32)
        meta = np.zeros(7, np.float64)
        rc = lib.img_decode_letterbox_jpeg(
            path.encode(), size,
            canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc == 0:
            return canvas, _window_from_meta(meta)
        # fall through: odd container with a .jpg name, etc.
    return letterbox_rgb(decode_rgb(path), size)


class PrefetchLoader:
    """Ordered, bounded, threaded letterbox loader.

    Iterating yields `(key, canvas, window)` in submission order while up to
    `depth` decodes run ahead on `workers` threads (the native library
    and PIL both release the interpreter lock while they decode and
    resample).
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
