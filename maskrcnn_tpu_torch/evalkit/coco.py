"""COCO annotation reader/indexer, port of `maskrcnn_tpu/evalkit/coco.py`:
parses `instances_<type><year>.json`, indexes annotations by image id, and
iterates images with optional `limit`/`sort_by_id`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterator


@dataclasses.dataclass(frozen=True)
class COCOImage:
    id: int
    width: int
    height: int
    file_name: str


class COCODataset:
    """In-memory index over a COCO instances JSON."""

    def __init__(self, annotations: dict[str, Any]):
        self.images = {
            int(im["id"]): COCOImage(int(im["id"]), int(im["width"]),
                                     int(im["height"]), im.get("file_name",
                                                               ""))
            for im in annotations.get("images", [])
        }
        self.categories = {
            int(c["id"]): c.get("name", str(c["id"]))
            for c in annotations.get("categories", [])
        }
        self.anns_by_image: dict[int, list[dict[str, Any]]] = {}
        self.anns: dict[int, dict[str, Any]] = {}
        for ann in annotations.get("annotations", []):
            self.anns[int(ann["id"])] = ann
            self.anns_by_image.setdefault(int(ann["image_id"]), []).append(ann)
        self._sorted_cat_ids = sorted(self.categories)
        self._cat_to_class = {c: i + 1
                              for i, c in enumerate(self._sorted_cat_ids)}

    @classmethod
    def from_file(cls, path: str) -> "COCODataset":
        with open(path) as f:
            return cls(json.load(f))

    @classmethod
    def from_dir(cls, annotations_dir: str, coco_type: str = "val",
                 year: str = "2017") -> "COCODataset":
        """Same file-naming convention the reference resolves
        (`instances_val2017.json`)."""
        path = os.path.join(annotations_dir,
                            f"instances_{coco_type}{year}.json")
        return cls.from_file(path)

    # --- category id <-> contiguous class id ------------------------------
    # COCO category ids are sparse (1..90 with gaps); the model uses
    # contiguous 1..80 (+0 background), ordered by ascending category id —
    # the Matterport convention the weights were trained with.
    @property
    def sorted_category_ids(self) -> list[int]:
        return self._sorted_cat_ids

    def class_id_for_category(self, category_id: int) -> int:
        return self._cat_to_class[int(category_id)]

    def category_for_class_id(self, class_id: int) -> int:
        return self._sorted_cat_ids[int(class_id) - 1]

    def class_label(self, class_id: int) -> str:
        if class_id == 0:
            return "background"
        return self.categories[self.category_for_class_id(class_id)]

    # --- iteration ---------------------------------------------------------
    def iter_images(self, limit: int | None = None,
                    sort_by_id: bool = True) -> Iterator[COCOImage]:
        """Mirrors `COCO.ImageIterator` (COCO.swift:79-107): optional sort
        by id and count limit."""
        images = list(self.images.values())
        if sort_by_id:
            images.sort(key=lambda im: im.id)
        if limit is not None:
            images = images[:limit]
        yield from images

    def annotations_for(self, image_id: int) -> list[dict[str, Any]]:
        return self.anns_by_image.get(int(image_id), [])

    def __len__(self) -> int:
        return len(self.images)
