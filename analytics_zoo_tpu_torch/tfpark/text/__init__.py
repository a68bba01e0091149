"""tfpark's text models: the Keras taggers (``tfpark.text.keras``) and the
BERT estimators (``tfpark.text.estimator``)."""

from . import estimator, keras  # noqa: F401
