"""ObjectDetector — the detection zoo model (counterpart of
``analytics_zoo_tpu/models/image/objectdetection/object_detector.py``).

Reference: objectdetection/ObjectDetector.scala (ZooModel subclass with
config-driven load + ``predictImageSet`` + label map) and the dataset padding
of SSDMiniBatch (variable gt counts -> fixed minibatch shapes).
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss import (
    MultiBoxLoss,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.postprocess import (
    decode_predictions,
    nms_decoded,
    visualize,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.ssd import (
    ssd_tiny,
    ssd_vgg300,
)

PASCAL_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def pad_ground_truth(boxes_list, labels_list, max_boxes: int) -> np.ndarray:
    """Variable per-image gt -> fixed (B, max_boxes, 5) with label -1
    padding (the SSDMiniBatch role: static shapes for the captured
    loss)."""
    b = len(boxes_list)
    out = np.zeros((b, max_boxes, 5), np.float32)
    out[..., 4] = -1.0
    for i, (boxes, labels) in enumerate(zip(boxes_list, labels_list)):
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        if len(boxes) > max_boxes:
            import logging

            logging.getLogger("analytics_zoo_tpu_torch").warning(
                "image %d has %d gt boxes; only the first max_boxes=%d are "
                "kept — raise max_boxes for crowded datasets",
                i, len(boxes), max_boxes)
        boxes = boxes[:max_boxes]
        labels = np.asarray(labels, np.float32).reshape(-1)[:max_boxes]
        out[i, :len(boxes), :4] = boxes
        out[i, :len(labels), 4] = labels
    return out


class ObjectDetector(ZooModel):
    """SSD detector with training loss + postprocess wired in
    (reference ObjectDetector.scala + SSDGraph)."""

    def __init__(self, variant: str = "ssd-vgg16-300",
                 class_names=PASCAL_CLASSES, input_shape=None):
        self.variant = variant
        self.class_names = tuple(class_names)
        self.input_shape = input_shape
        super().__init__()

    def build_model(self):
        n = len(self.class_names)
        if self.variant == "ssd-vgg16-300":
            net, priors = ssd_vgg300(
                n, self.input_shape or (300, 300, 3))
        elif self.variant == "ssd-tiny":
            net, priors = ssd_tiny(n, self.input_shape or (64, 64, 3))
        else:
            raise ValueError(f"unknown variant {self.variant!r}")
        self.priors = priors
        return net

    def loss(self, **kwargs) -> MultiBoxLoss:
        return MultiBoxLoss(self.priors, len(self.class_names), **kwargs)

    def compile(self, optimizer, loss=None, metrics=None):
        self.model.compile(optimizer, loss or self.loss(), metrics)
        return self

    def fit_detection(self, images, boxes_list, labels_list, batch_size=8,
                      nb_epoch=1, max_boxes=16):
        y = pad_ground_truth(boxes_list, labels_list, max_boxes)
        self.model.fit(np.asarray(images, np.float32), y,
                       batch_size=batch_size, nb_epoch=nb_epoch)
        return self

    def predict_image_set(self, images, conf_threshold=0.5,
                          iou_threshold=0.45, top_k=200):
        """Reference ``predictImageSet``: raw forward + decode + NMS.  The
        boxes are decoded and the scores taken on the model's device, each
        batch as its forward ends; only the decoded boxes and scores come
        to the host, for NMS."""
        priors = torch.as_tensor(np.asarray(self.priors, np.float32),
                                 device=self.model.device)

        def decode(raw):
            boxes, scores = decode_predictions(raw.float(), priors)
            return boxes.cpu().numpy(), scores.cpu().numpy()

        outs, n = self.model._predict_each(np.asarray(images, np.float32),
                                           decode)
        boxes = np.concatenate([b for b, _ in outs])[:n]
        scores = np.concatenate([s for _, s in outs])[:n]
        return nms_decoded(boxes, scores, conf_threshold, iou_threshold,
                           top_k)

    def visualize(self, image, detections, **kwargs):
        return visualize(image, detections, self.class_names, **kwargs)
