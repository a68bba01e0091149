"""Keras-1-style layer/graph engine over parameter trees.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/engine.py``, with the
same contract: a ``Layer`` owns static config and weight specs; parameters
live in a tree (nested dicts/lists of tensors) passed to a pure
``call(params, inputs, state=None, training=False, rng=None)``.  Keeping
that contract keeps the port's trees one-to-one with the reference's:
the same position-canonical layer names, keys, shapes and dtypes.

Randomness is a ``torch.Generator``: initializers draw on the CPU and the
model moves the tree to its device afterwards, so the same seed gives the
same weights on every device.  :func:`fold_in` (from ``common/engine.py``)
derives a child generator per layer, as ``jax.random.fold_in`` derives a
child key; in training the generators live on the model's device, where
dropout draws its masks.

Shape convention (Keras-1): user-facing ``input_shape`` excludes the batch
dim; internal full shapes carry ``None`` in position 0.
"""

from __future__ import annotations

import collections
import itertools
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.engine import (  # noqa: F401
    fold_in,
    make_generator,
)
from analytics_zoo_tpu_torch.common.utils import to_tuple_shape


# ---------------------------------------------------------------------------
# Weight specs & initializers
# ---------------------------------------------------------------------------

_INIT_FNS = {}


def register_init(name):
    def deco(fn):
        _INIT_FNS[name] = fn
        return fn
    return deco


def _uniform_range(gen, shape, dtype, limit):
    return torch.empty(shape, dtype=dtype).uniform_(-limit, limit,
                                                    generator=gen)


def _normal_std(gen, shape, dtype, std):
    return std * torch.randn(shape, dtype=dtype, generator=gen)


@register_init("zero")
def _zero(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype)


@register_init("one")
def _one(gen, shape, dtype):
    return torch.ones(shape, dtype=dtype)


@register_init("glorot_uniform")
def _glorot_uniform(gen, shape, dtype):
    fan_in, fan_out = _compute_fans(shape)
    return _uniform_range(gen, shape, dtype,
                          math.sqrt(6.0 / (fan_in + fan_out)))


@register_init("glorot_normal")
def _glorot_normal(gen, shape, dtype):
    fan_in, fan_out = _compute_fans(shape)
    return _normal_std(gen, shape, dtype, math.sqrt(2.0 / (fan_in + fan_out)))


@register_init("he_normal")
def _he_normal(gen, shape, dtype):
    fan_in, _ = _compute_fans(shape)
    return _normal_std(gen, shape, dtype, math.sqrt(2.0 / fan_in))


@register_init("he_uniform")
def _he_uniform(gen, shape, dtype):
    fan_in, _ = _compute_fans(shape)
    return _uniform_range(gen, shape, dtype, math.sqrt(6.0 / fan_in))


@register_init("lecun_uniform")
def _lecun_uniform(gen, shape, dtype):
    fan_in, _ = _compute_fans(shape)
    return _uniform_range(gen, shape, dtype, math.sqrt(3.0 / fan_in))


@register_init("uniform")
def _uniform(gen, shape, dtype):
    return _uniform_range(gen, shape, dtype, 0.05)


@register_init("normal")
def _normal(gen, shape, dtype):
    return _normal_std(gen, shape, dtype, 0.05)


@register_init("orthogonal")
def _orthogonal(gen, shape, dtype):
    return torch.nn.init.orthogonal_(torch.empty(shape, dtype=dtype),
                                     generator=gen)


def _compute_fans(shape):
    """Fan-in/fan-out for conv kernels shaped (..spatial.., in, out) and
    dense kernels shaped (in, out)."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive


class NamedInit:
    """Picklable by-name initializer."""

    def __init__(self, name):
        self.name = name

    def __call__(self, gen, shape, dtype):
        return _INIT_FNS[self.name](gen, shape, dtype)

    def __repr__(self):
        return f"init({self.name})"


class ConstInit:
    def __init__(self, value):
        self.value = value

    def __call__(self, gen, shape, dtype):
        return torch.full(shape, self.value, dtype=dtype)


def get_initializer(init) -> Callable:
    """Resolve an init spec (name, callable, or constant) to a
    (generator, shape, dtype) -> tensor function."""
    if isinstance(init, (int, float)):
        return ConstInit(init)
    if callable(init):
        return init
    if isinstance(init, str) and init in _INIT_FNS:
        return NamedInit(init)
    raise ValueError(f"unknown initializer {init!r}")


class WeightSpec(
    collections.namedtuple("WeightSpec", "name shape init dtype trainable")
):
    pass


# ---------------------------------------------------------------------------
# Symbolic tensors (Variable) and graph nodes
# ---------------------------------------------------------------------------

_uid_counters: dict[str, itertools.count] = collections.defaultdict(
    lambda: itertools.count(1)
)


def unique_name(prefix: str) -> str:
    return f"{prefix}_{next(_uid_counters[prefix])}"


def reset_name_counters() -> None:
    _uid_counters.clear()


class Node:
    """One application of a layer to symbolic inputs."""

    def __init__(self, layer: "Layer", inbound: list["Variable"],
                 outputs: list["Variable"]):
        self.layer = layer
        self.inbound = inbound
        self.outputs = outputs


class Variable:
    """A symbolic tensor: output slot of a Node."""

    def __init__(self, node: Node | None, index: int, shape: tuple,
                 name: str | None = None):
        self.node = node
        self.index = index
        self.shape = tuple(shape)  # full shape, batch dim = None
        self.name = name or unique_name("variable")

    def __repr__(self):
        return f"Variable(name={self.name}, shape={self.shape})"


def Input(shape=None, name: str | None = None) -> Variable:
    """Symbolic model input; ``shape`` excludes the batch dim."""
    shape = to_tuple_shape(shape)
    layer = InputLayer(input_shape=shape, name=name)
    var = Variable(None, 0, (None,) + shape, name=layer.name)
    node = Node(layer, [], [var])
    var.node = node
    return var


# ---------------------------------------------------------------------------
# Layer base
# ---------------------------------------------------------------------------


class Layer:
    """Base layer: static config + weight specs; pure functional ``call``.

    Contract (as in the reference):
      - ``build(input_shape)``: declare weights/state via ``add_weight`` /
        ``add_state`` given the (batch-less) input shape.
      - ``call(params, inputs, state=None, training=False, rng=None)``: pure;
        returns outputs, or ``(outputs, new_state)`` if the layer is stateful.
      - ``compute_output_shape(input_shape)``: shape inference.
    """

    def __init__(self, input_shape=None, name: str | None = None, **kwargs):
        cls = type(self).__name__.lower()
        # Auto-named layers are canonically renamed when adopted by a
        # container (position-based), so param-tree keys depend only on model
        # structure, not on how many models were built earlier in the process.
        self._auto_named = name is None
        self.name = name or unique_name(cls)
        self.built = False
        self._weight_specs: list[WeightSpec] = []
        self._state_specs: list[WeightSpec] = []
        self._input_shape = (
            to_tuple_shape(input_shape) if input_shape is not None else None
        )
        self._build_shape = None
        self._config = {}
        if kwargs:
            raise TypeError(f"{type(self).__name__}: unexpected args {kwargs}")

    # -- weights ----------------------------------------------------------
    def add_weight(self, name, shape, init="glorot_uniform",
                   dtype=torch.float32, trainable=True):
        spec = WeightSpec(name, tuple(int(s) for s in shape),
                          get_initializer(init), dtype, trainable)
        if trainable:
            self._weight_specs.append(spec)
        else:
            self._state_specs.append(spec)
        return spec

    def add_state(self, name, shape, init="zero", dtype=torch.float32):
        return self.add_weight(name, shape, init, dtype, trainable=False)

    # -- build / init -----------------------------------------------------
    def build(self, input_shape):  # pragma: no cover - default no-op
        del input_shape

    def ensure_built(self, input_shape):
        if not self.built:
            self._weight_specs.clear()
            self._state_specs.clear()
            self.build(input_shape)
            self._build_shape = input_shape
            self.built = True
        return self._build_shape

    def init_params(self, rng: torch.Generator) -> dict:
        """Weights on the CPU, drawn from children of ``rng``."""
        if not self.built:
            raise RuntimeError(f"{self.name}: init_params before build")
        params = {}
        for i, spec in enumerate(self._weight_specs):
            params[spec.name] = spec.init(fold_in(rng, i), spec.shape,
                                          spec.dtype)
        return params

    def init_state(self) -> dict:
        state = {}
        for spec in self._state_specs:
            state[spec.name] = spec.init(make_generator(0), spec.shape,
                                         spec.dtype)
        return state

    @property
    def stateful(self) -> bool:
        return bool(self._state_specs)

    # -- forward ----------------------------------------------------------
    def call(self, params, inputs, state=None, training=False, rng=None):
        raise NotImplementedError

    def apply(self, params, inputs, state=None, training=False, rng=None):
        """Normalized forward: always returns (outputs, new_state)."""
        out = self.call(params, inputs, state=state, training=training,
                        rng=rng)
        if self.stateful or isinstance(self, _ContainerBase):
            return out  # stateful layers return (out, state) themselves
        return out, state

    # -- shapes -----------------------------------------------------------
    def compute_output_shape(self, input_shape):
        return input_shape

    # -- symbolic call ----------------------------------------------------
    def __call__(self, x):
        single = not isinstance(x, (list, tuple))
        xs = [x] if single else list(x)
        for v in xs:
            if not isinstance(v, Variable):
                raise TypeError(
                    f"{self.name} called on non-symbolic input {type(v)}; "
                    "use .apply(params, inputs) for concrete tensors"
                )
        in_shapes = [v.shape[1:] for v in xs]
        build_shape = in_shapes[0] if single else in_shapes
        self.ensure_built(build_shape)
        out_shape = self.compute_output_shape(
            xs[0].shape if single else [v.shape for v in xs]
        )
        multi = isinstance(out_shape, list)
        out_shapes = out_shape if multi else [out_shape]
        outs = [Variable(None, i, s) for i, s in enumerate(out_shapes)]
        node = Node(self, xs, outs)
        for v in outs:
            v.node = node
        return outs if multi else outs[0]

    # -- misc -------------------------------------------------------------
    def param_count(self) -> int:
        if not self.built:
            raise RuntimeError(f"{self.name}: param_count before build")
        return sum(int(np.prod(s.shape)) for s in self._weight_specs) + sum(
            int(np.prod(s.shape)) for s in self._state_specs
        )

    def get_config(self) -> dict:
        return dict(self._config)

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name})"


class InputLayer(Layer):
    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.built = True
        self._build_shape = self._input_shape

    def call(self, params, inputs, state=None, training=False, rng=None):
        return inputs

    def compute_output_shape(self, input_shape):
        return input_shape


class _ContainerBase(Layer):
    """Marker base for containers (Sequential/Model) whose ``call`` always
    returns (outputs, state)."""


# ---------------------------------------------------------------------------
# Graph executor
# ---------------------------------------------------------------------------


def canonicalize_names(layers: Sequence["Layer"]) -> None:
    """Rename auto-named layers to position-based canonical names within a
    container (``dense_0``, ``dense_1``, ... in adoption order).  Must run
    before params are materialized."""
    taken = {l.name for l in layers if not l._auto_named}
    counters: dict[str, int] = collections.defaultdict(int)
    for layer in layers:
        if not layer._auto_named:
            continue
        cls = type(layer).__name__.lower()
        while True:
            cand = f"{cls}_{counters[cls]}"
            counters[cls] += 1
            if cand not in taken:
                break
        layer.name = cand
        taken.add(cand)
        layer._auto_named = False
    names = [l.name for l in layers]
    if len(names) != len(set(names)):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(
            f"duplicate layer names in one container: {dupes}; rename the "
            "layers (layers adopted from different containers can collide)"
        )


def topological_nodes(outputs: Sequence[Variable]) -> list[Node]:
    """Topologically sorted nodes reaching ``outputs`` (inputs first)."""
    order: list[Node] = []
    seen: set[int] = set()

    def visit(node: Node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for v in node.inbound:
            visit(v.node)
        order.append(node)

    for v in outputs:
        visit(v.node)
    return order


class GraphFunction:
    """Executable function compiled from a symbolic graph: a node list plus
    param/state trees keyed by layer name."""

    def __init__(self, inputs: Sequence[Variable],
                 outputs: Sequence[Variable]):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.nodes = topological_nodes(self.outputs)
        self.layers: list[Layer] = []
        seen_layers = set()
        for node in self.nodes:
            if id(node.layer) not in seen_layers:
                seen_layers.add(id(node.layer))
                self.layers.append(node.layer)
        canonicalize_names(self.layers)
        input_ids = {id(v) for v in self.inputs}
        for node in self.nodes:
            if isinstance(node.layer, InputLayer):
                if node.outputs and id(node.outputs[0]) not in input_ids:
                    raise ValueError(
                        "graph contains an Input not listed in `inputs`"
                    )

    def init_params(self, rng: torch.Generator) -> dict:
        params = {}
        for i, layer in enumerate(self.layers):
            if isinstance(layer, InputLayer):
                continue
            p = layer.init_params(fold_in(rng, i))
            if p:
                params[layer.name] = p
        return params

    def init_state(self) -> dict:
        state = {}
        for layer in self.layers:
            s = layer.init_state()
            if s:
                state[layer.name] = s
        return state

    def __call__(self, params, inputs, state=None, training=False, rng=None):
        state = state or {}
        values: dict[int, Any] = {}
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if len(xs) != len(self.inputs):
            raise ValueError(
                f"expected {len(self.inputs)} inputs, got {len(xs)}"
            )
        for var, x in zip(self.inputs, xs):
            values[id(var)] = x
        new_state = dict(state)
        for i, node in enumerate(self.nodes):
            layer = node.layer
            if isinstance(layer, InputLayer):
                continue
            args = [values[id(v)] for v in node.inbound]
            arg = args[0] if len(args) == 1 else args
            lrng = fold_in(rng, i) if rng is not None else None
            out, s = layer.apply(
                params.get(layer.name, {}), arg,
                state=new_state.get(layer.name),
                training=training, rng=lrng,
            )
            if s:  # {} stays omitted, mirroring init's `if s:` filter
                new_state[layer.name] = s
            outs = out if isinstance(out, (list, tuple)) else [out]
            for v, o in zip(node.outputs, outs):
                values[id(v)] = o
        results = [values[id(v)] for v in self.outputs]
        result = results[0] if len(results) == 1 else results
        return result, new_state
