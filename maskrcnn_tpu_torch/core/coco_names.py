"""The 80 COCO category names in Matterport class-id order, port of
`maskrcnn_tpu/core/coco_names.py`: the standalone label table for the
demo / serve / stream surfaces that run without annotations
(`evalkit.coco.COCODataset.class_label` derives names from a dataset).

Index = Matterport class id (category ids sorted ascending, background
first). `COCO_CATEGORY_IDS[i]` is the official COCO category id for
class i (0 for background, which COCO does not number).
"""

from __future__ import annotations

# (category_id, name) for the 80 things categories of COCO 2014/2017,
# ascending by category id — the order Matterport (and our h5 loader)
# assigns class ids 1..80. Category ids are sparse (12, 26, 29, 30, 45,
# 66, 68, 69, 71, 83 are unused by COCO).
_COCO_CATEGORIES: tuple[tuple[int, str], ...] = (
    (1, "person"), (2, "bicycle"), (3, "car"), (4, "motorcycle"),
    (5, "airplane"), (6, "bus"), (7, "train"), (8, "truck"), (9, "boat"),
    (10, "traffic light"), (11, "fire hydrant"), (13, "stop sign"),
    (14, "parking meter"), (15, "bench"), (16, "bird"), (17, "cat"),
    (18, "dog"), (19, "horse"), (20, "sheep"), (21, "cow"),
    (22, "elephant"), (23, "bear"), (24, "zebra"), (25, "giraffe"),
    (27, "backpack"), (28, "umbrella"), (31, "handbag"), (32, "tie"),
    (33, "suitcase"), (34, "frisbee"), (35, "skis"), (36, "snowboard"),
    (37, "sports ball"), (38, "kite"), (39, "baseball bat"),
    (40, "baseball glove"), (41, "skateboard"), (42, "surfboard"),
    (43, "tennis racket"), (44, "bottle"), (46, "wine glass"), (47, "cup"),
    (48, "fork"), (49, "knife"), (50, "spoon"), (51, "bowl"),
    (52, "banana"), (53, "apple"), (54, "sandwich"), (55, "orange"),
    (56, "broccoli"), (57, "carrot"), (58, "hot dog"), (59, "pizza"),
    (60, "donut"), (61, "cake"), (62, "chair"), (63, "couch"),
    (64, "potted plant"), (65, "bed"), (67, "dining table"), (70, "toilet"),
    (72, "tv"), (73, "laptop"), (74, "mouse"), (75, "remote"),
    (76, "keyboard"), (77, "cell phone"), (78, "microwave"), (79, "oven"),
    (80, "toaster"), (81, "sink"), (82, "refrigerator"), (84, "book"),
    (85, "clock"), (86, "vase"), (87, "scissors"), (88, "teddy bear"),
    (89, "hair drier"), (90, "toothbrush"),
)

#: 81 entries: index 0 is background, index i in 1..80 is class i's name.
COCO_CLASS_NAMES: tuple[str, ...] = (
    ("background",) + tuple(name for _, name in _COCO_CATEGORIES))

#: COCO category id per class id (0 placeholder for background).
COCO_CATEGORY_IDS: tuple[int, ...] = (
    (0,) + tuple(cid for cid, _ in _COCO_CATEGORIES))


def class_name(class_id: int, num_classes: int = 81) -> str:
    """Name for a model class id; falls back to the numeric id for non-COCO
    class counts (custom-trained models carry their own label map)."""
    if num_classes == len(COCO_CLASS_NAMES) and 0 <= class_id < num_classes:
        return COCO_CLASS_NAMES[class_id]
    return str(class_id)
