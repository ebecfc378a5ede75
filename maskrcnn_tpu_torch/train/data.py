"""COCO training data: letterboxed images and padded GT batches, port of
`maskrcnn_tpu/train/data.py` on the port's PIL image path.

Each example is letterboxed to the square network input, its GT boxes
moved into normalized canvas coordinates, its instance segmentations
turned into fixed-size box-relative mini-masks, and everything padded to
`max_instances`, so every batch has one shape.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
from maskrcnn_tpu_torch.evalkit import mask_rle as M
from maskrcnn_tpu_torch.evalkit.coco import COCODataset


def minimask_from_annotation(ann, image_h: int, image_w: int,
                             mask_size: int) -> np.ndarray:
    """COCO segmentation -> (mask_size, mask_size) box-relative mini-mask."""
    from PIL import Image

    rle = M.from_coco_segmentation(ann["segmentation"], image_h, image_w)
    full = M.decode(rle)
    x, y, w, h = [int(round(v)) for v in ann["bbox"]]
    x2 = min(x + max(w, 1), image_w)
    y2 = min(y + max(h, 1), image_h)
    x, y = max(x, 0), max(y, 0)
    crop = full[y:y2, x:x2]
    if crop.size == 0:
        return np.zeros((mask_size, mask_size), np.float32)
    resized = Image.fromarray(crop * 255).resize(
        (mask_size, mask_size), Image.BILINEAR)
    return (np.asarray(resized, np.float32) / 255.0 >= 0.5).astype(np.float32)


class COCOTrainLoader:
    """Random-order batches over a COCO-format dataset.

    `flip_prob`: the probability of a horizontal flip per example
    (Matterport's Fliplr(0.5)); canvas, normalized boxes and mini-masks
    flip together (mini-masks are box-relative, so flipping the array is
    enough). `cache_images`: keep up to N decoded examples (before the
    flip) in host memory, keyed by image id, so a small fine-tuning set is
    decoded once (no eviction: the first N distinct images stay; 0
    disables). `image_dtype`: uint8 (default) rounds the resampled canvas,
    +-0.5 of a level, for 4x fewer host-to-device bytes; float32 keeps the
    resampled values (`cli train --exact`).

    Batch composition is a pure function of (seed, step), so a resumed run
    draws at step S the batch an uninterrupted run would."""

    def __init__(self, annotations_path: str, images_dir: str,
                 config: MaskRCNNConfig, batch_size: int = 2,
                 max_instances: int = 32, seed: int = 0,
                 flip_prob: float = 0.5, cache_images: int = 0,
                 image_dtype=np.uint8):
        self.dataset = COCODataset.from_file(annotations_path)
        self.images_dir = images_dir
        self.config = config
        self.batch_size = batch_size
        self.max_instances = max_instances
        self.flip_prob = flip_prob
        self.cache_images = cache_images
        self.image_dtype = np.dtype(image_dtype)
        self._cache: dict[int, tuple] = {}
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.image_ids = [
            im.id for im in self.dataset.iter_images()
            if self.dataset.annotations_for(im.id)]
        if not self.image_ids:
            raise ValueError("dataset has no annotated images")

    def load_example(self, image_id: int, flip: bool = False):
        if self.cache_images:
            raw = self._cache.get(image_id)
            if raw is None:
                raw = self._load_raw(image_id)
                if len(self._cache) < self.cache_images:
                    self._cache[image_id] = raw
            # copies: the flip writes into the boxes, and callers own what
            # they get
            canvas, boxes, classes, masks = (a.copy() for a in raw)
        else:
            canvas, boxes, classes, masks = self._load_raw(image_id)
        if flip:
            canvas = canvas[:, ::-1].copy()
            # every REAL instance flips (crowds are negative), padding rows
            # stay zero
            real = classes != 0
            fx1 = 1.0 - boxes[:, 3]
            fx2 = 1.0 - boxes[:, 1]
            boxes[real, 1] = fx1[real]
            boxes[real, 3] = fx2[real]
            masks = masks[:, :, ::-1].copy()
        return canvas, boxes, classes, masks

    def _load_raw(self, image_id: int):
        """Decode + letterbox + GT arrays for one example, no flip."""
        from maskrcnn_tpu_torch.pipeline.loader import load_letterboxed
        from maskrcnn_tpu_torch.pipeline.preprocess import quantize_canvas_u8

        im = self.dataset.images[image_id]
        path = os.path.join(self.images_dir, im.file_name)
        size = self.config.image_height
        canvas, win = load_letterboxed(path, size)
        if self.image_dtype == np.uint8:
            canvas = quantize_canvas_u8(canvas)

        g = self.max_instances
        boxes = np.zeros((g, 4), np.float32)
        classes = np.zeros((g,), np.int32)
        masks = np.zeros((g, self.config.mask_size, self.config.mask_size),
                         np.float32)
        s = size - 1
        anns = self.dataset.annotations_for(image_id)[:g]
        for i, ann in enumerate(anns):
            x, y, w, h = ann["bbox"]
            # original pixels -> canvas pixels -> normalized (the Matterport
            # convention of core/anchors.norm_boxes)
            cy1 = y * win.scale + win.y1
            cx1 = x * win.scale + win.x1
            cy2 = (y + h) * win.scale + win.y1
            cx2 = (x + w) * win.scale + win.x1
            boxes[i] = [cy1 / s, cx1 / s, (cy2 - 1) / s, (cx2 - 1) / s]
            cls = self.dataset.class_id_for_category(ann["category_id"])
            if ann.get("iscrowd", 0):
                # crowd regions carry NEGATIVE class ids: no matching, and
                # what overlaps them is neutral (train/targets.py)
                classes[i] = -cls
                continue
            classes[i] = cls
            if "segmentation" in ann:
                masks[i] = minimask_from_annotation(
                    ann, im.height, im.width, self.config.mask_size)
        return canvas, boxes, classes, masks

    def get_batch(self, step: int | None = None) -> dict[str, np.ndarray]:
        """The batch of training step `step` (a pure function of seed and
        step); without a step, the next of the loader's own stream."""
        rng = (self.rng if step is None
               else np.random.default_rng((self.seed, step)))
        ids = rng.choice(self.image_ids, self.batch_size,
                         replace=len(self.image_ids) < self.batch_size)
        flips = rng.random(self.batch_size) < self.flip_prob
        images, boxes, classes, masks = [], [], [], []
        for i, flip in zip(ids, flips):
            c, b, cl, m = self.load_example(int(i), flip=bool(flip))
            images.append(c)
            boxes.append(b)
            classes.append(cl)
            masks.append(m)
        return {
            "images": np.stack(images),
            "gt_boxes": np.stack(boxes),
            "gt_class_ids": np.stack(classes),
            "gt_masks": np.stack(masks),
        }


class PrefetchBatcher:
    """One-ahead prefetch: batch t+1 is loaded on a worker thread while the
    device runs step t (PIL decode and resample release the GIL)."""

    def __init__(self, loader: COCOTrainLoader):
        self._loader = loader
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._next = None  # (step, future) for the NEXT expected step

    def get_batch(self, step: int | None = None) -> dict[str, np.ndarray]:
        pre, self._next = self._next, None
        if pre is not None and pre[0] == step:
            batch = pre[1].result()
        else:  # first call, or the caller skipped or repeated a step
            if pre is not None:
                pre[1].cancel()
            batch = self._loader.get_batch(step)
        nxt = None if step is None else step + 1
        self._next = (nxt, self._pool.submit(self._loader.get_batch, nxt))
        return batch

    def close(self) -> None:
        """Cancel the prefetch in flight and release the worker thread."""
        if self._next is not None:
            self._next[1].cancel()
            self._next = None
        self._pool.shutdown(wait=False, cancel_futures=True)


def synthetic_train_batch(config, batch: int, device, seed: int = 1,
                          gt: int = 8) -> dict:
    """A fixed training batch from `seed`: random pixels, `gt` boxes an
    image (corners in [0, 0.6], sides 0.1-0.3), random classes and 28^2
    mini-masks (the config's size), on `device`. `cli train --synthetic`,
    `tools/bench.py --mode train` and the card's checks train on it."""
    import torch

    rng = np.random.default_rng(seed)
    m = config.mask_size
    yx1 = rng.uniform(0, 0.6, (batch, gt, 2))
    wh = rng.uniform(0.1, 0.3, (batch, gt, 2))
    arrays = {
        "images": rng.uniform(0, 255, (batch, config.image_height,
                                       config.image_width, 3)
                              ).astype(np.float32),
        "gt_boxes": np.concatenate([yx1, yx1 + wh], -1).astype(np.float32),
        "gt_class_ids": rng.integers(1, config.num_classes,
                                     (batch, gt)).astype(np.int32),
        "gt_masks": (rng.random((batch, gt, m, m)) > 0.5).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
