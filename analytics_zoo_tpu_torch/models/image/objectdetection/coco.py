"""COCO dataset loading (the port's copy of
``analytics_zoo_tpu/models/image/objectdetection/coco.py``; reference
zoo/.../models/image/objectdetection/common/dataset/Coco.scala): COCO
annotations -> roi records for the SSD pipeline.

Two layouts are supported:

- The reference's devkit layout (Coco.scala:40-51): ``ImageSets/<set>.txt``
  lines of ``<image_path> <annotation_path>`` with one per-image JSON of
  ``{"image": {...}, "annotation": [{bbox, category_id, area}, ...]}``.
- The standard ``instances_*.json`` single-file layout (what COCO actually
  distributes; the reference relies on external preprocessing to split it).
"""

from __future__ import annotations

import json
import os

import numpy as np

# Coco.scala:59-140 — 80 categories with the original sparse COCO ids;
# background first, class indices 1-based in devkit order.
COCO_CAT_ID_AND_CLASS = (
    (0, "__background__"),
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
    (43, "tennis racket"), (44, "bottle"), (46, "wine glass"),
    (47, "cup"), (48, "fork"), (49, "knife"), (50, "spoon"), (51, "bowl"),
    (52, "banana"), (53, "apple"), (54, "sandwich"), (55, "orange"),
    (56, "broccoli"), (57, "carrot"), (58, "hot dog"), (59, "pizza"),
    (60, "donut"), (61, "cake"), (62, "chair"), (63, "couch"),
    (64, "potted plant"), (65, "bed"), (67, "dining table"),
    (70, "toilet"), (72, "tv"), (73, "laptop"), (74, "mouse"),
    (75, "remote"), (76, "keyboard"), (77, "cell phone"),
    (78, "microwave"), (79, "oven"), (80, "toaster"), (81, "sink"),
    (82, "refrigerator"), (84, "book"), (85, "clock"), (86, "vase"),
    (87, "scissors"), (88, "teddy bear"), (89, "hair drier"),
    (90, "toothbrush"),
)
COCO_CLASSES = tuple(n for _, n in COCO_CAT_ID_AND_CLASS)
# sparse COCO category id -> dense 1-based class index (Coco.scala:144-146;
# background's id 0 maps to 1 there, foreground starts at 2 — here
# background stays 0 and foreground is 1..80, matching the VOC convention
# used by the rest of this detection stack)
COCO_CAT_ID_TO_IND = {
    cid: i for i, (cid, _) in enumerate(COCO_CAT_ID_AND_CLASS)
}


def _boxes_from_annotations(anns, width, height, cat_to_ind):
    """bbox [x, y, w, h] -> clipped corners; skip degenerate/zero-area
    (Coco.scala:148-176 semantics)."""
    boxes, classes, crowd = [], [], []
    for a in anns:
        if a.get("area", 1) <= 0:
            continue
        x, y, w, h = a["bbox"]
        x1 = max(0.0, x)
        y1 = max(0.0, y)
        # corners from the RAW origin so boxes crossing the left/top edge
        # are clipped, not shifted (x2 anchored at x, not at clipped x1)
        x2 = min(width - 1.0, x + max(0.0, w - 1))
        y2 = min(height - 1.0, y + max(0.0, h - 1))
        if x2 < x1 or y2 < y1:
            continue
        cid = int(a["category_id"])
        if cid not in cat_to_ind:
            continue
        boxes.append([x1, y1, x2, y2])
        classes.append(float(cat_to_ind[cid]))
        crowd.append(float(a.get("iscrowd", 0)))
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(classes, np.float32),
            np.asarray(crowd, np.float32))


def load_coco_annotation(path: str, cat_to_ind=None) -> dict:
    """One per-image annotation JSON (reference Coco.loadAnnotation,
    Coco.scala:148-186)."""
    cat_to_ind = cat_to_ind or COCO_CAT_ID_TO_IND
    with open(path) as f:
        doc = json.load(f)
    img = doc["image"]
    boxes, classes, crowd = _boxes_from_annotations(
        doc["annotation"], float(img["width"]), float(img["height"]),
        cat_to_ind)
    return {"boxes": boxes, "classes": classes, "difficult": crowd}


class Coco:
    """COCO reader with the reference's devkit layout (Coco.scala:39-51)
    or a standard ``instances_*.json``."""

    def __init__(self, devkit_path: str, image_set: str = "train",
                 instances_json: str | None = None, cat_to_ind=None):
        self.devkit_path = devkit_path
        self.image_set = image_set
        self.instances_json = instances_json
        self.cat_to_ind = cat_to_ind or COCO_CAT_ID_TO_IND
        self.name = f"coco_{image_set}"

    @staticmethod
    def _read_image(path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def roidb(self, read_image: bool = True) -> list[dict]:
        if self.instances_json:
            return self._from_instances(read_image)
        lst = os.path.join(self.devkit_path, "ImageSets",
                           self.image_set + ".txt")
        records = []
        with open(lst) as f:
            for line in f:
                if not line.strip():
                    continue
                img_rel, ann_rel = line.split()
                img_path = os.path.join(self.devkit_path, img_rel)
                ann = load_coco_annotation(
                    os.path.join(self.devkit_path, ann_rel),
                    self.cat_to_ind)
                rec = dict(ann, path=img_path)
                if read_image:
                    rec["image"] = self._read_image(img_path)
                records.append(rec)
        return records

    def _from_instances(self, read_image: bool) -> list[dict]:
        with open(self.instances_json) as f:
            doc = json.load(f)
        by_image: dict[int, list] = {}
        for a in doc.get("annotations", []):
            by_image.setdefault(a["image_id"], []).append(a)
        records = []
        for img in doc.get("images", []):
            boxes, classes, crowd = _boxes_from_annotations(
                by_image.get(img["id"], []), float(img["width"]),
                float(img["height"]), self.cat_to_ind)
            img_path = os.path.join(self.devkit_path, img["file_name"])
            rec = {"boxes": boxes, "classes": classes, "difficult": crowd,
                   "path": img_path}
            if read_image:
                rec["image"] = self._read_image(img_path)
            records.append(rec)
        return records
