"""Inference: the pooled InferenceModel, weight-only and calibrated int8."""

from analytics_zoo_tpu_torch.pipeline.inference import (  # noqa
    inference_model as _inference_model,
)
from analytics_zoo_tpu_torch.pipeline.inference.quantize import (  # noqa: F401
    Int8Model,
    calibrate_activations,
    dequantize_params,
    quantize_model,
    quantize_params,
    quantize_params_for_plan,
    quantized_matmul,
)

InferenceModel = _inference_model.InferenceModel
AbstractInferenceModel = _inference_model.AbstractInferenceModel
