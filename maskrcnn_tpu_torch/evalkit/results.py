"""Detection results interchange, port of `maskrcnn_tpu/evalkit/results.py`.

Two formats:
  * the reference's protobuf schema (`results_pb2`, a byte-identical copy
    of the JAX package's generated module for its `results.proto`, so both
    packages register the same descriptor): boxes as normalized
    (x, y, w, h) rects; `google.protobuf` is imported only by the `.pb`
    functions;
  * the standard COCO results-list JSON (`bbox` in absolute pixels,
    optional RLE `segmentation`) read by the AP evaluator.
"""

from __future__ import annotations

import json
from typing import Any, Sequence

import numpy as np

from maskrcnn_tpu_torch.evalkit import mask_rle as M
from maskrcnn_tpu_torch.evalkit.coco import COCODataset
from maskrcnn_tpu_torch.pipeline.detector import Detection


def detections_to_coco_results(
    image_id: int,
    detections: Sequence[Detection],
    dataset: COCODataset,
    with_masks: bool = True,
) -> list[dict[str, Any]]:
    """Pipeline detections (original-image pixel space) -> COCO results rows."""
    rows = []
    for d in detections:
        y1, x1, y2, x2 = d.box
        row: dict[str, Any] = {
            "image_id": int(image_id),
            "category_id": dataset.category_for_class_id(d.class_id),
            "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
            "score": float(d.score),
        }
        if with_masks and d.rle is not None:
            # unmold(paste_masks="rle"): no full canvas was ever built
            row["segmentation"] = d.rle
        elif with_masks and d.mask is not None:
            rle = M.encode(d.mask.astype(np.uint8))
            row["segmentation"] = {
                "size": [rle.h, rle.w],
                "counts": M.to_coco_counts(rle),
            }
        rows.append(row)
    return rows


def save_coco_results(rows: list[dict[str, Any]], path: str) -> None:
    with open(path, "w") as f:
        json.dump(rows, f)


def load_coco_results(path: str) -> list[dict[str, Any]]:
    with open(path) as f:
        return json.load(f)


# --- reference-compatible protobuf (.pb) -----------------------------------

def build_results_proto(per_image: dict[int, Sequence[Detection]],
                        dataset: COCODataset,
                        dataset_id: str = "coco"):
    """Normalized-rect protobuf (`results_pb2.Results`) in the reference's
    serialization convention: origin = (x1, y1), size = (w, h), all
    divided by image dims."""
    from maskrcnn_tpu_torch.evalkit import results_pb2

    out = results_pb2.Results()
    for image_id, dets in per_image.items():
        im = dataset.images[int(image_id)]
        res = out.results.add()
        res.imageInfo.datasetID = dataset_id
        res.imageInfo.id = str(image_id)
        res.imageInfo.width = im.width
        res.imageInfo.height = im.height
        for d in dets:
            y1, x1, y2, x2 = d.box
            det = res.detections.add()
            det.probability = float(d.score)
            det.classID = int(d.class_id)
            det.classLabel = dataset.class_label(d.class_id)
            det.boundingBox.origin.x = float(x1 / im.width)
            det.boundingBox.origin.y = float(y1 / im.height)
            det.boundingBox.size.width = float((x2 - x1) / im.width)
            det.boundingBox.size.height = float((y2 - y1) / im.height)
    return out


def save_results_proto(msg, path: str) -> None:
    with open(path, "wb") as f:
        f.write(msg.SerializeToString())


def load_results_proto(path: str):
    from maskrcnn_tpu_torch.evalkit import results_pb2

    msg = results_pb2.Results()
    with open(path, "rb") as f:
        msg.ParseFromString(f.read())
    return msg


def proto_to_coco_results(msg, dataset: COCODataset) -> list[dict[str, Any]]:
    """Reference .pb blob -> COCO results rows (bbox only, pixel space)."""
    rows = []
    for res in msg.results:
        image_id = int(res.imageInfo.id)
        w, h = res.imageInfo.width, res.imageInfo.height
        for det in res.detections:
            rows.append({
                "image_id": image_id,
                "category_id": dataset.category_for_class_id(det.classID),
                "bbox": [det.boundingBox.origin.x * w,
                         det.boundingBox.origin.y * h,
                         det.boundingBox.size.width * w,
                         det.boundingBox.size.height * h],
                "score": det.probability,
            })
    return rows
