"""Pascal VOC dataset loading (the port's copy of
``analytics_zoo_tpu/models/image/objectdetection/voc.py``; reference
zoo/.../models/image/objectdetection/common/dataset/PascalVoc.scala:37-118
and Imdb.scala): VOCdevkit layout -> roi records for the SSD pipeline.

A roi record (see feature/image/roi.py): {"image": uint8 RGB HWC,
"boxes": (N,4) pixel corners, "classes": (N,) 1-based ids,
"difficult": (N,) 0/1, "path": str}.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

# PascalVoc.scala:80-88 — background is index 0; classes are 1-based.
VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat",
    "bottle", "bus", "car", "cat", "chair",
    "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
)
VOC_CLASS_TO_IND = {c: float(i) for i, c in enumerate(VOC_CLASSES)}


def load_voc_annotation(path: str, class_to_ind=None) -> dict:
    """Parse one Annotations/*.xml (PascalVoc.loadAnnotation,
    PascalVoc.scala:92-118)."""
    class_to_ind = class_to_ind or VOC_CLASS_TO_IND
    root = ET.parse(path).getroot()
    objs = root.findall("object")
    boxes = np.zeros((len(objs), 4), np.float32)
    classes = np.zeros((len(objs),), np.float32)
    difficult = np.zeros((len(objs),), np.float32)
    for i, obj in enumerate(objs):
        bb = obj.find("bndbox")
        boxes[i] = [float(bb.find(t).text)
                    for t in ("xmin", "ymin", "xmax", "ymax")]
        classes[i] = class_to_ind[obj.find("name").text.strip()]
        d = obj.find("difficult")
        difficult[i] = float(d.text) if d is not None else 0.0
    return {"boxes": boxes, "classes": classes, "difficult": difficult}


class PascalVoc:
    """VOCdevkit reader (PascalVoc.scala:37-76).

    ``devkit_path/VOC<year>/{ImageSets/Main/<image_set>.txt,
    Annotations/<idx>.xml, JPEGImages/<idx>.jpg}``.
    """

    def __init__(self, devkit_path: str, year: str = "2007",
                 image_set: str = "train", class_to_ind=None):
        if not os.path.isdir(devkit_path):
            raise FileNotFoundError(
                f"VOCdevkit path does not exist: {devkit_path}")
        self.devkit_path = devkit_path
        self.years = ["2007", "2012"] if year == "0712" else [year]
        self.image_set = image_set
        self.class_to_ind = class_to_ind or VOC_CLASS_TO_IND
        self.name = f"voc_{year}_{image_set}"

    def _index(self):
        out = []
        for y in self.years:
            data = os.path.join(self.devkit_path, "VOC" + y)
            lst = os.path.join(data, "ImageSets", "Main",
                               self.image_set + ".txt")
            with open(lst) as f:
                for line in f:
                    idx = line.split()[0].strip() if line.strip() else ""
                    if idx:
                        out.append((data, idx))
        return out

    @staticmethod
    def _read_image(path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def roidb(self, read_image: bool = True) -> list[dict]:
        """All records of the split (PascalVoc.getRoidb,
        PascalVoc.scala:53-76)."""
        records = []
        for data, idx in self._index():
            ann = load_voc_annotation(
                os.path.join(data, "Annotations", idx + ".xml"),
                self.class_to_ind)
            img_path = os.path.join(data, "JPEGImages", idx + ".jpg")
            rec = dict(ann, path=img_path)
            if read_image:
                rec["image"] = self._read_image(img_path)
            records.append(rec)
        return records
