"""tfpark's high-level APIs (counterpart of ``analytics_zoo_tpu/tfpark``).

The reference's tfpark trains user-defined graphs through a Keras-style
facade (``KerasModel``), spec-driven estimators (``TFEstimator``),
alternating GAN optimization (``GANEstimator``) and ready-made text models.
The port has ``KerasModel`` and the text taggers (``tfpark.text.keras``),
over its own ``KerasNet``.  ``TFEstimator``, ``TFEstimatorSpec``,
``ZooOptimizer``, ``sparse_ce``, ``GANEstimator`` and the BERT estimators
(``tfpark.text.estimator``) are not ported yet (ROADMAP queue 1 item 21):
importing one raises ``NotImplementedError``.
"""

from .model import KerasModel

__all__ = ["KerasModel"]

#: names of the reference's tfpark that wait for ROADMAP queue 1 item 21
UNPORTED = ("TFEstimator", "TFEstimatorSpec", "ZooOptimizer", "sparse_ce",
            "GANEstimator", "estimator", "gan")


def unported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"tfpark.{name} belongs to tfpark's estimator plane (TFEstimator, "
        f"GANEstimator and the BERT estimators), which the port does not "
        f"have yet (ROADMAP queue 1 item 21)")


def __getattr__(name):
    if name in UNPORTED:
        raise unported(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
