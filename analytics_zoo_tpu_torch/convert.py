"""Parameter trees and optimizer state from the JAX package into the port.

``params_from_jax`` takes the JAX package's parameter tree with its leaves
as numpy arrays (or anything ``np.asarray`` accepts) and returns the
port's tree of tensors on a device.  A quantized leaf comes as the JAX
package's ``QuantizedTensor`` (anything with ``values``, ``scale`` and
``axis``) or as a ``(values, scale, axis)`` triple, and becomes the port's
``QuantizedTensor``.  ``opt_state_from_jax`` carries optax's
Adam state (``ScaleByAdamState``: count, mu, nu) into the port's
:class:`~analytics_zoo_tpu_torch.pipeline.api.keras.optimizers.AdamState`.
The JAX package is never imported: the caller hands over plain arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.engine import resolve_device
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import AdamState
from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
    QuantizedTensor,
)


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: move the bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _quantized(x):
    """(values, scale, axis) of a quantized leaf, else None."""
    if isinstance(x, tuple) and len(x) == 3 \
            and isinstance(x[2], (int, np.integer)):
        return x
    if all(hasattr(x, a) for a in ("values", "scale", "axis")):
        return x.values, x.scale, x.axis
    return None


def params_from_jax(tree, device=None):
    """The port's parameter tree for a JAX parameter tree (default device
    ``cuda``; pass ``device="cpu"`` on a machine without a GPU)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        q = _quantized(x)
        if q is not None:
            return QuantizedTensor(_tensor(q[0], dev), _tensor(q[1], dev),
                                   int(q[2]))
        return _tensor(x, dev)

    return conv(tree)


def opt_state_from_jax(state, device=None):
    """The port's ``AdamState`` for an optax Adam state: a
    ``ScaleByAdamState`` (anything with ``count``, ``mu`` and ``nu``), or
    the tuple ``optax.adam(...).init`` returns, whose first such element is
    taken (the learning-rate stage after it holds no arrays the port
    keeps: its count equals the Adam count)."""
    adam = state
    if not hasattr(adam, "mu"):
        adam = next((s for s in state if hasattr(s, "mu")), None)
        if adam is None:
            raise ValueError("no Adam state (count, mu, nu) in the given "
                             "optimizer state")
    dev = resolve_device(device)
    return AdamState(
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                           device=dev),
        mu=params_from_jax(adam.mu, dev), nu=params_from_jax(adam.nu, dev))
