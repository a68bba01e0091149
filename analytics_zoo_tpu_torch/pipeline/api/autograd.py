"""Autograd facade — Variable math, AutoGrad ops, CustomLoss, Lambda,
Parameter.

Counterpart of ``analytics_zoo_tpu/pipeline/api/autograd.py``.  A
``Variable`` is a symbolic tensor over the graph the Keras ``Model`` runs
(``engine.Variable``); every op here appends a ``LambdaOp`` node whose body
is plain torch, and ``torch.autograd`` differentiates the traced graph, so
no op has backward code of its own.  The same functions run eagerly on
tensors, which is how they serve inside a ``CustomLoss`` body.

The reference's rules are kept: an axis counts the batch dimension and
``mean``/``sum`` default to ``axis=0``; ``clip`` and ``maximum`` are
``minimum``/``maximum`` pairs, which split the gradient evenly at a tie as
``jnp.clip`` and ``jnp.maximum`` do; ``l2_normalize`` and
``batch_dot(normalize=True)`` divide by the norm clipped at 1e-12, the norm
as ``jnp.linalg.norm`` computes it (so a zero row's gradient is NaN in
both packages); ``index_select`` is ``jnp.take``'s: a negative index wraps
once, an index out of range gives a NaN-filled result (the smallest
integer for signed integer inputs).  The index and every shape are
Python ints, so each op is fixed when the graph is built: no host sync, no
device assert, nothing made on the host in the body, and a CUDA graph
captures it as it captures any layer.

The functions a user writes (a ``Lambda``'s body, a ``CustomLoss``'s, a
``LambdaOp``'s) run on torch tensors in the port: write them with these
ops or with torch.

Example (a custom loss, as in the reference's autograd/math.scala):

    def mean_absolute_error(y_true, y_pred):
        return AutoGrad.mean(AutoGrad.abs(y_true - y_pred), axis=1)
    model.compile(optimizer=..., loss=CustomLoss(mean_absolute_error))
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    Layer,
    Node,
    Variable,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
    LossFunction,
)


class LambdaOp(Layer):
    """A node of the symbolic graph whose body is a torch function."""

    def __init__(self, fn: Callable, out_shape_fn: Callable, op_name="op",
                 name=None):
        super().__init__(name=name)
        self.fn = fn
        self.out_shape_fn = out_shape_fn
        self.op_name = op_name
        self.built = True
        self._build_shape = None

    def ensure_built(self, input_shape):
        self._build_shape = input_shape
        return input_shape

    def call(self, params, inputs, state=None, training=False, rng=None):
        if isinstance(inputs, (list, tuple)):
            return self.fn(*inputs)
        return self.fn(inputs)

    def compute_output_shape(self, input_shape):
        return self.out_shape_fn(input_shape)

    def param_count(self):
        return 0


def _apply_op(fn, shape_fn, op_name, *variables):
    """Apply an op: symbolically (any Variable among the arguments: a
    ``LambdaOp`` node) or eagerly (tensors: ``fn`` called at once)."""
    if any(isinstance(v, Variable) for v in variables):
        op = LambdaOp(fn, shape_fn, op_name=op_name)
        return op(list(variables) if len(variables) > 1 else variables[0])
    return fn(*variables)


def _broadcast_shapes(a, b):
    """Numpy-style broadcast of symbolic shapes (None = unknown/batch)."""
    out = []
    ra, rb = list(a)[::-1], list(b)[::-1]
    for i in range(max(len(ra), len(rb))):
        da = ra[i] if i < len(ra) else 1
        db = rb[i] if i < len(rb) else 1
        if da is None or db is None:
            out.append(None)
        elif da == 1:
            out.append(db)
        elif db == 1 or da == db:
            out.append(da)
        else:
            raise ValueError(f"cannot broadcast {a} and {b}")
    return tuple(out[::-1])


def _binop(name, fn):
    def op(self, other):
        if isinstance(other, Variable):
            shape = _broadcast_shapes(self.shape, other.shape)
            return _apply_op(fn, lambda s: shape, name, self, other)
        const = other

        def unary(x):
            return fn(x, const)

        return _apply_op(unary, lambda s: s, name, self)

    return op


def _rbinop(name, fn):
    def op(self, other):
        const = other

        def unary(x):
            return fn(const, x)

        return _apply_op(unary, lambda s: s, name, self)

    return op


# -- operators on the port's symbolic Variable class ------------------------
Variable.__add__ = _binop("add", lambda a, b: a + b)
Variable.__radd__ = _rbinop("radd", lambda a, b: a + b)
Variable.__sub__ = _binop("sub", lambda a, b: a - b)
Variable.__rsub__ = _rbinop("rsub", lambda a, b: a - b)
Variable.__mul__ = _binop("mul", lambda a, b: a * b)
Variable.__rmul__ = _rbinop("rmul", lambda a, b: a * b)
Variable.__truediv__ = _binop("div", lambda a, b: a / b)
Variable.__rtruediv__ = _rbinop("rdiv", lambda a, b: a / b)
Variable.__pow__ = _binop("pow", lambda a, b: a ** b)
Variable.__neg__ = lambda self: _apply_op(
    lambda x: -x, lambda s: s, "neg", self
)


def _axis(dim, ndim):
    return dim if dim >= 0 else ndim + dim


def _slice_shape(shape, dim, start, length):
    s = list(shape)
    s[dim] = length
    return tuple(s)


def _variable_slice(self, dim, start_index, length):
    """The reference's ``Variable.slice``: ``length`` entries along
    ``dim`` from ``start_index``."""

    def fn(x):
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start_index, start_index + length)
        return x[tuple(idx)]

    return _apply_op(fn, lambda s: _slice_shape(s, dim, start_index, length),
                     "slice", self)


def _fill_value(dtype):
    """``jnp.take``'s fill for an index out of range."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed \
        else torch.iinfo(dtype).max


def take(x, index: int, dim: int):
    """``jnp.take(x, index, axis=dim)`` for a Python int ``index``: a
    negative index wraps once; one out of ``[-n, n)`` gives the result's
    shape filled with :func:`_fill_value`."""
    d = _axis(dim, x.dim())
    n = x.shape[d]
    i = int(index)
    if -n <= i < n:
        return x.select(d, i % n)
    shape = x.shape[:d] + x.shape[d + 1:]
    return torch.full(shape, _fill_value(x.dtype), dtype=x.dtype,
                      device=x.device)


def _variable_index_select(self, dim, index):
    """The reference's ``Variable.indexSelect``: one index along ``dim``
    (``dim`` may be negative; the batch dimension is 0), as
    ``jnp.take``."""
    if not isinstance(index, (int, np.integer)):
        raise TypeError(f"index_select takes one int index, got {index!r}")

    def shape_fn(s):
        s = list(s)
        del s[_axis(dim, len(s))]
        return tuple(s)

    return _apply_op(lambda x: take(x, index, dim), shape_fn, "index_select",
                     self)


def _squeeze(x, dim):
    """``jnp.squeeze(x, axis=dim)``: raises where that axis is not 1."""
    if x.shape[_axis(dim, x.dim())] != 1:
        raise ValueError(f"cannot select an axis to squeeze out which has "
                         f"size not equal to one: {tuple(x.shape)}, "
                         f"axis {dim}")
    return x.squeeze(dim)


def _variable_squeeze(self, dim):
    def shape_fn(s):
        s = list(s)
        del s[_axis(dim, len(s))]
        return tuple(s)

    return _apply_op(lambda x: _squeeze(x, dim), shape_fn, "squeeze", self)


Variable.slice = _variable_slice
Variable.index_select = _variable_index_select
Variable.squeeze = _variable_squeeze


def _full(x, value):
    """A 0-d tensor of ``x``'s dtype and device holding ``value`` (a device
    fill: a CUDA graph captures it)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _maximum(x, y):
    return torch.maximum(x, y if torch.is_tensor(y) else _full(x, y))


def _minimum(x, y):
    return torch.minimum(x, y if torch.is_tensor(y) else _full(x, y))


def clip_values(x, lo=None, hi=None):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, either bound None."""
    if lo is not None:
        x = _maximum(x, lo)
    if hi is not None:
        x = _minimum(x, hi)
    return x


def _norm(x, axis):
    """``jnp.linalg.norm(x, axis=axis, keepdims=True)`` for a vector axis:
    the square root of the sum of squares."""
    return torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))


def _normalize(x, axis):
    return x / clip_values(_norm(x, axis), 1e-12)


class AutoGrad:
    """Namespace of autograd math ops (the reference's ``AutoGrad``
    object, autograd/math.scala:32-363)."""

    @staticmethod
    def abs(x: Variable) -> Variable:
        return _apply_op(torch.abs, lambda s: s, "abs", x)

    @staticmethod
    def sum(x: Variable, axis=0, keepdims=False) -> Variable:
        return AutoGrad._reduce(torch.sum, x, axis, keepdims)

    @staticmethod
    def mean(x: Variable, axis=0, keepdims=False) -> Variable:
        return AutoGrad._reduce(torch.mean, x, axis, keepdims)

    @staticmethod
    def _reduce(fn, x, axis, keepdims):
        def run(v):
            return fn(v, dim=axis, keepdim=keepdims)

        def shape_fn(s):
            s = list(s)
            d = _axis(axis, len(s))
            if keepdims:
                s[d] = 1
            else:
                del s[d]
            return tuple(s)

        return _apply_op(run, shape_fn, "reduce", x)

    @staticmethod
    def clip(x: Variable, min, max) -> Variable:
        return _apply_op(lambda v: clip_values(v, min, max), lambda s: s,
                         "clip", x)

    @staticmethod
    def square(x: Variable) -> Variable:
        return _apply_op(torch.square, lambda s: s, "square", x)

    @staticmethod
    def sqrt(x: Variable) -> Variable:
        return _apply_op(torch.sqrt, lambda s: s, "sqrt", x)

    @staticmethod
    def exp(x: Variable) -> Variable:
        return _apply_op(torch.exp, lambda s: s, "exp", x)

    @staticmethod
    def log(x: Variable) -> Variable:
        return _apply_op(torch.log, lambda s: s, "log", x)

    @staticmethod
    def pow(x: Variable, a: float) -> Variable:
        return _apply_op(lambda v: v ** a, lambda s: s, "pow", x)

    @staticmethod
    def epsilon() -> float:
        return 1e-7

    @staticmethod
    def maximum(x, y):
        if isinstance(y, Variable):
            return _apply_op(_maximum, lambda s: s, "maximum", x, y)
        return _apply_op(lambda v: _maximum(v, y), lambda s: s, "maximum",
                         x)

    @staticmethod
    def erf(x: Variable) -> Variable:
        return _apply_op(torch.erf, lambda s: s, "erf", x)

    @staticmethod
    def softsign(x: Variable) -> Variable:
        return _apply_op(lambda v: v / (1 + torch.abs(v)), lambda s: s,
                         "softsign", x)

    @staticmethod
    def softplus(x: Variable) -> Variable:
        # jax.nn.softplus is logaddexp(x, 0)
        return _apply_op(lambda v: torch.logaddexp(v, _full(v, 0.0)),
                         lambda s: s, "softplus", x)

    @staticmethod
    def l2_normalize(x: Variable, axis=-1) -> Variable:
        return _apply_op(lambda v: _normalize(v, axis), lambda s: s,
                         "l2_normalize", x)

    @staticmethod
    def mm(x: Variable, y: Variable, axes=None) -> Variable:
        """Batched matrix multiply contracting ``axes=[ax_of_x, ax_of_y]``
        (the reference's AutoGrad.mm).  The default contracts x's last
        axis with y's second-to-last (a plain matmul)."""

        def fn(a, b):
            if axes is None:
                return torch.matmul(a, b)
            aa = torch.movedim(a, axes[0], -1)
            bb = torch.movedim(b, axes[1], -1)
            if aa.dim() == 3 and bb.dim() == 3:
                return torch.einsum("bid,bjd->bij", aa, bb)
            if aa.dim() == 2 and bb.dim() == 2:
                return torch.einsum("id,jd->ij", aa, bb)
            raise ValueError(
                f"mm supports 2-3D inputs with axes; got {tuple(a.shape)}, "
                f"{tuple(b.shape)}"
            )

        def shape_fn(shapes):
            sa, sb = [list(s) for s in shapes]
            if axes is None:
                return tuple(sa[:-1]) + (sb[-1],)
            ax = axes[0] % len(sa)
            ay = axes[1] % len(sb)
            da = [d for i, d in enumerate(sa) if i != ax]
            db = [d for i, d in enumerate(sb) if i != ay]
            if len(sa) == 3:
                return (sa[0], da[1], db[1])
            return (da[0], db[0])

        return _apply_op(fn, shape_fn, "mm", x, y)

    @staticmethod
    def batch_dot(x: Variable, y: Variable, axes=(2, 2),
                  normalize=False) -> Variable:
        """The reference's AutoGrad.batchDot: per-sample contraction over
        ``axes`` of 3-D inputs (B, I, D)·(B, J, D) → (B, I, J); with
        ``normalize=True`` the rows are l2-normalized first (cosine)."""
        ax, ay = axes

        def fn(a, b):
            if a.dim() != 3 or b.dim() != 3:
                raise ValueError(
                    f"batch_dot expects 3-D inputs, got {tuple(a.shape)}, "
                    f"{tuple(b.shape)}"
                )
            aa, bb = a, b
            if normalize:
                aa = _normalize(aa, ax)
                bb = _normalize(bb, ay)
            aa = torch.movedim(aa, ax, -1)
            bb = torch.movedim(bb, ay, -1)
            return torch.einsum("bid,bjd->bij", aa, bb)

        def shape_fn(shapes):
            sa, sb = [list(s) for s in shapes]
            d_a = [d for i, d in enumerate(sa) if i not in (0, ax % len(sa))]
            d_b = [d for i, d in enumerate(sb) if i not in (0, ay % len(sb))]
            return tuple([sa[0]] + d_a + d_b)

        return _apply_op(fn, shape_fn, "batch_dot", x, y)

    @staticmethod
    def contiguous(x: Variable) -> Variable:
        return x

    @staticmethod
    def expand_dims(x: Variable, axis) -> Variable:
        def shape_fn(s):
            s = list(s)
            d = axis if axis >= 0 else len(s) + 1 + axis
            s.insert(d, 1)
            return tuple(s)

        return _apply_op(lambda v: torch.unsqueeze(v, axis), shape_fn,
                         "expand_dims", x)

    @staticmethod
    def stack(inputs: Sequence[Variable], axis=1) -> Variable:
        def fn(*xs):
            return torch.stack(xs, dim=axis)

        def shape_fn(shapes):
            s = list(shapes[0])
            s.insert(axis if axis >= 0 else len(s) + 1 + axis, len(inputs))
            return tuple(s)

        return _apply_op(fn, shape_fn, "stack", *inputs)


# module-level aliases (the reference exposes both forms)
mean = AutoGrad.mean
abs = AutoGrad.abs  # noqa: A001 - mirrors reference API name
sum = AutoGrad.sum  # noqa: A001
clip = AutoGrad.clip
square = AutoGrad.square
sqrt = AutoGrad.sqrt
exp = AutoGrad.exp
log = AutoGrad.log
maximum = AutoGrad.maximum
l2_normalize = AutoGrad.l2_normalize
mm = AutoGrad.mm
batch_dot = AutoGrad.batch_dot
erf = AutoGrad.erf
epsilon = AutoGrad.epsilon
expand_dims = AutoGrad.expand_dims
stack = AutoGrad.stack


class Parameter(Layer):
    """A leaf tensor of the graph (the reference's KerasParameter.scala:
    31-100): a source node with no inbound edges, ``w = Parameter((3,
    4))(); y = x + w``.  Trainable, its value is ``params[name]["value"]``;
    frozen (``trainable=False``), ``state[name]["value"]``."""

    def __init__(self, shape, init_weight=None, init="glorot_uniform",
                 trainable=True, name=None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.shape = tuple(int(s) for s in shape)
        self.init = init
        self.init_weight = init_weight
        self.trainable = trainable

    def build(self, input_shape):
        if self.init_weight is not None:
            from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embedding \
                import _Pretrained

            w = np.asarray(self.init_weight)
            if tuple(w.shape) != self.shape:
                raise ValueError(
                    f"Parameter init_weight shape {w.shape} != declared "
                    f"shape {self.shape}"
                )
            self.add_weight("value", self.shape, _Pretrained(w),
                            trainable=self.trainable)
        else:
            self.add_weight("value", self.shape, self.init,
                            trainable=self.trainable)

    def call(self, params, inputs, state=None, training=False, rng=None):
        if "value" in params:
            return params["value"]
        return state["value"], state

    @property
    def stateful(self):
        return not self.trainable

    def __call__(self, x=None):
        """Symbolic: a Variable carrying the value.  With no argument the
        node has no inbound edges (a graph source)."""
        if x is not None:
            return super().__call__(x)
        self.ensure_built(None)
        var = Variable(None, 0, (None,) + self.shape, name=self.name)
        node = Node(self, [], [var])
        var.node = node
        return var

    def compute_output_shape(self, input_shape):
        return (None,) + self.shape


class Lambda(Layer):
    """A Python function over tensors as a layer (the reference's
    Lambda.scala / pyzoo autograd.Lambda).  The function is torch code
    (or these ``AutoGrad`` ops); its output shape comes from one call on
    ``meta``-device zeros with batch 1, which computes and allocates
    nothing."""

    def __init__(self, function: Callable, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.function = function
        self.built = True

    def ensure_built(self, input_shape):
        self._build_shape = input_shape
        return input_shape

    def call(self, params, inputs, state=None, training=False, rng=None):
        if isinstance(inputs, (list, tuple)):
            return self.function(*inputs)
        return self.function(inputs)

    def compute_output_shape(self, input_shape):
        shapes = input_shape if isinstance(input_shape, list) \
            else [input_shape]
        dummies = [torch.zeros([1 if d is None else d for d in s],
                               device="meta") for s in shapes]
        out = self.function(*dummies)
        return (None,) + tuple(out.shape)[1:]


def _as_tensor(a):
    """A tensor of ``a``, float64 arrays as float32 (``jnp.asarray``'s
    default)."""
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    return t.float() if t.dtype == torch.float64 else t


class CustomLoss(LossFunction):
    """A loss from a Python function over (y_true, y_pred) tensors (the
    reference's CustomLoss.scala; pyzoo autograd.CustomLoss).  The function
    is torch code (or these ``AutoGrad`` ops, which run eagerly on
    tensors) and may return per-sample or scalar values: a scalar becomes
    a one-element batch, more than one axis is averaged per sample."""

    def __init__(self, loss_fn: Callable, y_pred_shape=None,
                 y_true_shape=None):
        self.user_fn = loss_fn
        super().__init__(self._run, "custom_loss")

    def _run(self, y_true, y_pred):
        out = self.user_fn(y_true, y_pred)
        if isinstance(out, Variable):
            raise TypeError(
                "CustomLoss function must use torch ops on its tensor "
                "arguments (it runs eagerly), not symbolic Variables"
            )
        out = _as_tensor(out)
        if out.dim() == 0:
            return out[None]
        if out.dim() > 1:
            return out.reshape(out.shape[0], -1).mean(dim=-1)
        return out

    def forward(self, y_true, y_pred):
        """Evaluate the loss eagerly (the reference's
        CustomLoss.forward)."""
        return float(torch.mean(self._run(_as_tensor(y_true),
                                          _as_tensor(y_pred))))
