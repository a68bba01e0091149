"""tfpark's high-level APIs (counterpart of ``analytics_zoo_tpu/tfpark``).

The reference's tfpark trains user-defined graphs through a Keras-style
facade (``KerasModel``), spec-driven estimators (``TFEstimator``),
alternating GAN optimization (``GANEstimator``) and ready-made text models
(the Keras taggers of ``tfpark.text.keras`` and the BERT estimators of
``tfpark.text.estimator``).  The port keeps the API shapes over its own
``KerasNet`` and ``Estimator``: bring-your-own model function,
spec-driven estimators, alternating GAN phases, all building the port's
symbolic graph (autograd Variables and keras layers).
"""

from .estimator import TFEstimator, TFEstimatorSpec, ZooOptimizer, sparse_ce
from .gan import GANEstimator
from .model import KerasModel

__all__ = ["KerasModel", "TFEstimator", "TFEstimatorSpec", "ZooOptimizer",
           "sparse_ce", "GANEstimator"]
