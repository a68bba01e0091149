"""Parameter trees and optimizer state from the JAX package into the port.

``params_from_jax`` takes the JAX package's parameter tree with its leaves
as numpy arrays (or anything ``np.asarray`` accepts) and returns the
port's tree of tensors on a device.  A quantized leaf comes as the JAX
package's ``QuantizedTensor`` (anything with ``values``, ``scale`` and
``axis``) or as a ``(values, scale, axis)`` triple, and becomes the port's
``QuantizedTensor``.  ``opt_state_from_jax`` carries optax's
state of each optimizer of the reference's table into the port's: Adam's,
AdamW's and Adamax's ``ScaleByAdamState`` (count, mu, nu) into
:class:`~analytics_zoo_tpu_torch.pipeline.api.keras.optimizers.AdamState`,
SGD's (the empty ``add_decayed_weights`` state, the momentum
``TraceState`` and the schedule's ``ScaleByScheduleState``) into
``SGDState``, and RMSprop's ``ScaleByRmsState``, Adagrad's
``ScaleByRssState`` and Adadelta's ``ScaleByAdaDeltaState``, each with the
schedule's count, into ``RMSpropState``, ``AdagradState`` and
``AdadeltaState``.
The JAX package is never imported: the caller hands over plain arrays.

Every layer of the port keeps the reference's parameter names, shapes and
dtypes (the depthwise kernel (kh, kw, 1, in·dm), the pointwise (1, 1,
in·dm, out), the transposed convolution's (kh, kw, in, out), the locally
connected kernels (positions, patch, out)), so a tree converts leaf for
leaf, with no layout change; any layout a torch op wants is made inside
the layer's call.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.engine import resolve_device
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    AdadeltaState,
    AdagradState,
    AdamState,
    RMSpropState,
    SGDState,
)
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


def _has(stage, name: str) -> bool:
    """Whether an optax state stage holds the field ``name`` (a named
    tuple's field or an attribute, not a tuple method such as count)."""
    fields = getattr(stage, "_fields", None)
    if fields is not None:
        return name in fields
    return hasattr(stage, name) and not callable(getattr(stage, name))


def _stages(state) -> list:
    """The stages of a (nested) optax chain state, in order."""
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return [s for part in state for s in _stages(part)]
    return [state]


def opt_state_from_jax(state, device=None):
    """The port's optimizer state for an optax state (a stage or the
    nested tuple a chain's ``init`` returns), by the fields its stages
    hold.

    ``mu`` (a ``ScaleByAdamState``: Adam, AdamW, Adamax): an
    ``AdamState`` with that stage's count (a learning-rate stage after it
    counts the same steps).  ``sum_of_squares`` (Adagrad), ``e_g`` and
    ``e_x`` (Adadelta) or ``nu`` alone (RMSprop): an ``AdagradState``,
    ``AdadeltaState`` or ``RMSpropState``.  Otherwise SGD's ``trace``
    (absent without momentum): an ``SGDState``.  Where no stage holds a
    count (a constant rate), the count is 0."""
    dev = resolve_device(device)
    stages = _stages(state)

    def stage(name):
        return next((s for s in stages if _has(s, name)), None)

    def tree(x):
        return params_from_jax(x, dev)

    counts = [s for s in stages if _has(s, "count")]
    adam = stage("mu")
    if adam is not None:
        counts = [adam]
    count = torch.tensor(int(np.asarray(counts[0].count)) if counts else 0,
                         dtype=torch.int32, device=dev)
    if adam is not None:
        return AdamState(count=count, mu=tree(adam.mu), nu=tree(adam.nu))
    if stage("sum_of_squares") is not None:
        return AdagradState(count, tree(stage("sum_of_squares")
                                        .sum_of_squares))
    if stage("e_g") is not None:
        s = stage("e_g")
        return AdadeltaState(count, tree(s.e_g), tree(s.e_x))
    if stage("nu") is not None:
        return RMSpropState(count, tree(stage("nu").nu))
    traces = [s for s in stages if _has(s, "trace")]
    if not traces and not counts:
        raise ValueError(
            "no Adam (count, mu, nu), RMSprop, Adagrad, Adadelta or SGD "
            "(trace, count) state in the given optimizer state (a "
            "constant-rate SGD without momentum keeps no arrays: take the "
            "port optimizer's init)")
    return SGDState(count=count,
                    trace=tree(traces[0].trace) if traces else ())
