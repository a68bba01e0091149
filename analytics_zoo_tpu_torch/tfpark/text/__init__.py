"""tfpark's text models: the Keras taggers (``tfpark.text.keras``).  The
BERT estimators (``tfpark.text.estimator``) wait for ROADMAP queue 1 item
21: reaching for them raises ``NotImplementedError``."""

from . import keras  # noqa: F401


def __getattr__(name):
    from analytics_zoo_tpu_torch.tfpark import unported

    if name == "estimator":
        raise unported("text.estimator")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
