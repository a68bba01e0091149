"""The port's hand-written CUDA kernels, one wrapper module each.

Counterpart of ``analytics_zoo_tpu/ops/pallas/``.  Each wrapper launches
its kernel for a CUDA tensor and takes its plain PyTorch version for a CPU
tensor, and counts both.  Which kernel a scope takes is the plan's
business: consumers ask ``parallel.plan.resolve_kernel(scope)``, and an
explicit ``"xla"`` pick routes the scope to its plain PyTorch path without
calling the wrapper at all.

This ``__init__`` stays import-light: it imports no kernel module, and
:func:`kernel_invocation_counts` reads only those already imported.
"""

from __future__ import annotations

import sys

# kernel name -> (module, launch counter, plain-version counter)
_COUNTERS = {
    "flash_attention_fwd": ("flash_attention", "launch_count",
                            "plain_count"),
    "flash_attention_bwd": ("flash_attention", "bwd_launch_count",
                            "bwd_plain_count"),
    "fused_adam": ("fused_adam", "launch_count", "plain_count"),
    "softmax_xent_fwd": ("fused_softmax_xent", "fwd_launch_count",
                         "fwd_plain_count"),
    "softmax_xent_bwd": ("fused_softmax_xent", "bwd_launch_count",
                         "bwd_plain_count"),
    "int8_matmul": ("int8_matmul", "launch_count", "plain_count"),
}


def kernel_invocation_counts() -> dict:
    """Per kernel ``{"kernel": launches, "plain": plain-version calls}``,
    over the kernel modules that are imported (an unimported kernel ran no
    time and is absent)."""
    out = {}
    for name, (module, kernel, plain) in _COUNTERS.items():
        mod = sys.modules.get(f"{__name__}.{module}")
        if mod is not None:
            out[name] = {"kernel": getattr(mod, kernel),
                         "plain": getattr(mod, plain)}
    return out
