"""Engine context: device, seed, numerics policy and random generators.

Counterpart of ``analytics_zoo_tpu/common/engine.py``.  The reference's
context owns a device mesh; the port runs on one device, so the context
owns that device instead.  The sharding planes come with the
distribution slice.

Randomness: a ``torch.Generator`` stands in for a ``jax.random`` key.
:func:`fold_in` derives a child generator from its parent's seed alone
(the parent's state is not consumed), on the parent's device, as
``jax.random.fold_in`` derives a child key; :func:`step_generator` is the
training step's root, the counterpart of
``fold_in(PRNGKey(seed), step)``.  :func:`seed_pair` turns a generator
into the (seed0, seed1) pair the flash kernel's dropout hash takes, from
the seed alone, so the pair is the same on every device and reading it
never waits on the device.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading

import torch

from analytics_zoo_tpu_torch.common.utils import tree_map

logger = logging.getLogger("analytics_zoo_tpu_torch")


@dataclasses.dataclass
class ZooContext:
    """Runtime context: the device plus engine-level knobs."""

    device: torch.device
    seed: int = 0
    # Forward math dtype (params-in-compute); None = full f32.
    compute_dtype: torch.dtype | None = None


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device.  Raises when the
    device is CUDA and no GPU is visible: nothing falls back to the CPU
    unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return dev


_U32 = 0xFFFFFFFF


def make_generator(seed: int, device=None) -> torch.Generator:
    """A generator seeded with ``seed``, on ``device`` (default: CPU)."""
    gen = torch.Generator(device=torch.device(device or "cpu"))
    return gen.manual_seed(int(seed) % (1 << 63))


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    """A child generator on ``gen``'s device, determined by ``gen``'s seed
    and ``data`` alone (``gen``'s state is not consumed)."""
    return make_generator(gen.initial_seed() * 0x9E3779B1 + int(data) + 1,
                          gen.device)


def step_generator(seed: int, step: int, device=None) -> torch.Generator:
    """The root generator of training step ``step``: the counterpart of
    ``fold_in(PRNGKey(seed), step)`` in the reference's train step."""
    return fold_in(make_generator(seed, device), step)


def seed_pair(gen: torch.Generator) -> tuple[int, int]:
    """(seed0, seed1) for the flash kernel's dropout hash: the low and high
    32 bits of ``gen``'s seed, as unsigned 32-bit values."""
    s = gen.initial_seed()
    return s & _U32, (s >> 32) & _U32


def cast_floats(tree, dtype):
    """Cast floating-point leaves of a tree to ``dtype`` (None = no-op);
    integer leaves (labels, token ids) pass through untouched."""
    if dtype is None:
        return tree
    return tree_map(
        lambda a: a.to(dtype) if torch.is_tensor(a)
        and a.is_floating_point() else a, tree)


def _resolve_compute_dtype(spec):
    """Resolve the compute dtype policy.

    Precedence: explicit arg > ZOO_COMPUTE_DTYPE env > full f32.  The
    reference defaults to bf16 only on the TPU and computes in f32
    elsewhere, which is what the port's parity tolerances assume.
    """
    if spec is None:
        spec = os.environ.get("ZOO_COMPUTE_DTYPE")
    if spec is None:
        return None
    if spec in (torch.bfloat16, torch.float16, torch.float32):
        return None if spec == torch.float32 else spec
    s = str(spec).lower()
    if s in ("float32", "f32", "fp32", "none", ""):
        return None
    if s in ("bfloat16", "bf16"):
        return torch.bfloat16
    if s in ("float16", "f16", "fp16"):
        return torch.float16
    raise ValueError(f"unknown compute_dtype {spec!r}")


_LOCK = threading.Lock()
_CONTEXT: ZooContext | None = None  # guarded-by: _LOCK


def init_zoo_context(*, seed: int | None = None, device=None,
                     compute_dtype=None) -> ZooContext:
    """Initialise (or re-initialise) the global runtime context.

    ``device`` defaults to ``cuda`` and raises when no GPU is visible;
    tests pass ``device="cpu"``.  TF32 is switched off for matmuls and
    cuDNN: the reference computes in full f32 off-TPU, and the port's
    parity tolerances assume full f32.
    """
    global _CONTEXT
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = ZooContext(device=dev, seed=int(seed or 0),
                     compute_dtype=_resolve_compute_dtype(compute_dtype))
    with _LOCK:
        _CONTEXT = ctx
    logger.info("init_zoo_context: device %s, seed %d; TF32 off for "
                "matmul and cuDNN (full-f32 numerics)", dev, ctx.seed)
    return ctx


def get_zoo_context() -> ZooContext:
    """Current context, creating the default (``cuda``) one on demand."""
    with _LOCK:
        if _CONTEXT is not None:
            return _CONTEXT
    return init_zoo_context()
