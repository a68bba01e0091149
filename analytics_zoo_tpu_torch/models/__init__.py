"""The model zoo: LeNet-5, ResNet, Inception-v1/v3 and the rest of the
ImageNet classification set (``imagenet_zoo``: AlexNet, VGG, SqueezeNet,
DenseNet, MobileNet and MobileNet-v2); the text classifier, the
recommenders (NeuralCF, WideAndDeep, SessionRecommender), the anomaly
detector and Seq2seq; KNRM (``textmatching.py``), all on ``ZooModel``
with the ``Ranker`` metrics; the SSD object detector
(``image.objectdetection``) and ``ImageClassifier``
(``image.imageclassification``)."""

from analytics_zoo_tpu_torch.models import imagenet_zoo  # noqa: F401
from analytics_zoo_tpu_torch.models.anomalydetection import (  # noqa: F401
    AnomalyDetector,
)
from analytics_zoo_tpu_torch.models.common import (  # noqa: F401
    Ranker,
    ZooModel,
)
from analytics_zoo_tpu_torch.models.image.objectdetection import (  # noqa: F401
    ObjectDetector,
)
from analytics_zoo_tpu_torch.models.inception import (  # noqa: F401
    Inception,
    inception_v3,
)
from analytics_zoo_tpu_torch.models.lenet import build_lenet  # noqa: F401
from analytics_zoo_tpu_torch.models.recommendation import (  # noqa: F401
    ColumnFeatureInfo,
    NeuralCF,
    Recommender,
    SessionRecommender,
    WideAndDeep,
    to_wide_deep_features,
)
from analytics_zoo_tpu_torch.models.resnet import ResNet  # noqa: F401
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq  # noqa: F401
from analytics_zoo_tpu_torch.models.textclassification import (  # noqa: F401
    TextClassifier,
)
from analytics_zoo_tpu_torch.models.textmatching import KNRM  # noqa: F401
