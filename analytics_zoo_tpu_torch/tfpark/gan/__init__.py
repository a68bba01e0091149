from .gan_estimator import GANEstimator

__all__ = ["GANEstimator"]
