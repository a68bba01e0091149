"""Allow-listed deserialization for the port's model files.

Counterpart of ``analytics_zoo_tpu/common/safe_pickle.py``: a model file
is untrusted input, and a pickle can name any callable, so every load goes
through :func:`safe_load`, which refuses every class outside an exact set.

The set covers what the port writes: ``KerasNet.save``'s model files
(this package's classes, numpy arrays — weights are stored as numpy —,
torch dtype objects named by weight specs, and a few builtins) and the
estimator's checkpoints (dicts, lists, numpy arrays and scalars, ints,
floats and strings: no class of either package).  A checkpoint written by
the JAX package has the same format and loads; its model files hold JAX
objects and are refused.
"""

from __future__ import annotations

import io
import pickle

_ALLOWED_EXACT = {
    ("builtins", "frozenset"),
    ("builtins", "set"),
    ("builtins", "slice"),
    ("collections", "OrderedDict"),
    ("collections", "defaultdict"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
}

# torch dtypes pickle as the global ``torch.<name>``
_TORCH_DTYPES = frozenset({
    "bfloat16", "float16", "float32", "float64",
    "int8", "int16", "int32", "int64", "uint8", "bool",
})


def _allowed(module: str, name: str) -> bool:
    if module.split(".", 1)[0] == "analytics_zoo_tpu_torch":
        return True
    if (module, name) in _ALLOWED_EXACT:
        return True
    return module == "torch" and name in _TORCH_DTYPES


class CheckedUnpickler(pickle.Unpickler):
    """pickle.Unpickler with a class allow-list."""

    def find_class(self, module, name):
        if _allowed(module, name):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to deserialize {module}.{name}: not in the "
            f"analytics_zoo_tpu_torch allow-list (untrusted model file?)")


def safe_load(file):
    return CheckedUnpickler(file).load()


def safe_loads(data: bytes):
    return CheckedUnpickler(io.BytesIO(data)).load()
