"""analytics_zoo_tpu_torch — the PyTorch/CUDA port of analytics_zoo_tpu.

The layout mirrors the JAX package module for module, so each file here
has its counterpart under ``analytics_zoo_tpu/``.  Parameter trees keep
the reference's names, shapes and dtypes; the kernels the JAX package
wrote in Pallas are hand-written CUDA kernels under ``csrc/``, wrapped in
``ops/cuda/``.

This package imports ``torch`` and never ``jax`` or ``analytics_zoo_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

Ported so far: serving (``Input``/``Model`` → ``InferenceModel`` over
Dense, Dropout, BERT and TransformerLayer, in f32, bf16 and int8),
fine-tuning (``compile``/``fit``/``evaluate``), the single-device kernel
and precision planes (``parallel``), the compile plane, the
convolutional path (conv, pooling, BatchNorm, Merge and shape layers,
SGD, ``models.build_lenet`` and ``models.ResNet``), the ImageNet zoo,
fault-tolerant training (``ZooConfig``'s env tier, checkpoints with
mid-epoch resume and retry, TensorBoard summaries, the DISK and PMEM data
tiers), and every TPU kernel of the reference as a CUDA kernel.
"""

__version__ = "0.1.0"

from analytics_zoo_tpu_torch.common.engine import (  # noqa: E402,F401
    ZooConfig,
    ZooContext,
    get_zoo_context,
    init_zoo_context,
)
