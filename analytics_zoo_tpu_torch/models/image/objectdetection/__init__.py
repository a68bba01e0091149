"""Object detection stack (counterpart of
``analytics_zoo_tpu/models/image/objectdetection``; reference
zoo/.../models/image/objectdetection): SSD graphs, MultiBox loss, NMS
postprocess, VOC mAP evaluation, the ObjectDetector zoo model, and box
visualization."""

from analytics_zoo_tpu_torch.models.image.objectdetection.evaluation import (
    PascalVocEvaluator,
    average_precision,
    mean_average_precision,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss import (
    MultiBoxLoss,
    decode_boxes,
    encode_boxes,
    iou_matrix,
    match_priors,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.object_detector import (
    PASCAL_CLASSES,
    ObjectDetector,
    pad_ground_truth,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.postprocess import (
    detect,
    nms_numpy,
    visualize,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.priors import (
    PriorSpec,
    SSD300_SPECS,
    generate_priors,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.ssd import (
    ssd_tiny,
    ssd_vgg300,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.coco import (
    COCO_CAT_ID_TO_IND,
    COCO_CLASSES,
    Coco,
    load_coco_annotation,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.voc import (
    VOC_CLASS_TO_IND,
    VOC_CLASSES,
    PascalVoc,
    load_voc_annotation,
)

__all__ = [
    "ObjectDetector", "PASCAL_CLASSES", "pad_ground_truth",
    "MultiBoxLoss", "match_priors", "encode_boxes", "decode_boxes",
    "iou_matrix", "detect", "nms_numpy", "visualize",
    "average_precision", "mean_average_precision", "PascalVocEvaluator",
    "PriorSpec", "SSD300_SPECS", "generate_priors",
    "ssd_vgg300", "ssd_tiny",
    "PascalVoc", "VOC_CLASSES", "VOC_CLASS_TO_IND", "load_voc_annotation",
    "Coco", "COCO_CLASSES", "COCO_CAT_ID_TO_IND", "load_coco_annotation",
]
