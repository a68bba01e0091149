"""The port's hand-written CUDA kernels, one wrapper module each.

Counterpart of ``analytics_zoo_tpu/ops/pallas/``.  Each wrapper launches
its kernel for a CUDA tensor and takes its plain PyTorch version for a CPU
tensor, and counts both.  Which kernel a scope takes is the plan's
business: consumers ask ``parallel.plan.resolve_kernel(scope)``, and an
explicit ``"xla"`` pick routes the scope to its plain PyTorch path without
calling the wrapper at all.

This ``__init__`` stays import-light: it imports no kernel module, and
:func:`kernel_invocation_counts` reads only those already imported.

A replayed CUDA graph runs no Python, so the counters cannot move by
themselves under replay: a captured step (``parallel.plan.compile_step``)
takes :func:`counter_snapshot` around its capture, puts the counters back
(a capture launches nothing) and adds the capture's delta with
:func:`add_counters` on every replay.  :func:`kernel_step` sends an eager
kernel invocation through the same choke point.
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
    "int8_conv": ("int8_conv", "launch_count", "plain_count"),
}


# every counter of every kernel module, launches and plain calls alike
_ALL_COUNTERS = {
    "flash_attention": ("launch_count", "bwd_launch_count", "plain_count",
                        "bwd_plain_count", "bwd_blockwise_count"),
    "fused_adam": ("launch_count", "leaf_count", "plain_count"),
    "fused_softmax_xent": ("fwd_launch_count", "bwd_launch_count",
                           "fwd_plain_count", "bwd_plain_count"),
    "int8_matmul": ("launch_count", "plain_count"),
    "int8_conv": ("launch_count", "plain_count"),
}


def counter_snapshot() -> dict:
    """``{(module, counter): value}`` over the imported kernel modules."""
    out = {}
    for module, names in _ALL_COUNTERS.items():
        mod = sys.modules.get(f"{__name__}.{module}")
        if mod is not None:
            out.update({(module, n): getattr(mod, n) for n in names})
    return out


def counter_delta(before: dict, after: dict) -> dict:
    """What moved between two snapshots (a module imported in between
    counts from 0)."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add_counters(delta: dict, sign: int = 1) -> None:
    """Add ``delta`` (times ``sign``) to the counters it names."""
    for (module, name), n in delta.items():
        mod = sys.modules[f"{__name__}.{module}"]
        setattr(mod, name, getattr(mod, name) + sign * n)


_KERNEL_STEPS: dict = {}


def kernel_step(name: str, fn):
    """``fn`` through the compile plane's choke point under the
    ``kernel_<name>`` label, cached per (name, fn): the counterpart of the
    reference's ``ops/pallas/kernel_step``.  On the card the first call
    for an input signature captures ``fn`` into a CUDA graph and later
    calls replay it; on the CPU it runs eagerly.  Calls from inside a
    captured step must not come here: they are part of that step's
    graph."""
    key = (name, fn)
    step = _KERNEL_STEPS.get(key)
    if step is None:
        from analytics_zoo_tpu_torch.parallel.plan import compile_step

        step = _KERNEL_STEPS[key] = compile_step(fn, label=f"kernel_{name}")
    return step


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
