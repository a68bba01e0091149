"""ONNX op -> torch mappers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/onnx/mapper.py`` (the
reference's pyzoo/zoo/pipeline/api/onnx/mapper/*.py, one OperatorMapper
per op).  Each mapper is a plain function ``fn(attrs, consts, *args) ->
output(s)`` over torch tensors, with the JAX package's op set and
semantics: ONNX's NCHW layout is kept, so ``F.conv2d`` and the pooling
ops run on the graph's tensors as they are, with no layout copy.

``consts`` maps input names to *static* numpy values (initializers and
Constant outputs) for ops whose ONNX inputs are really attributes
(Reshape shape, Slice starts/ends, Pad pads...).  Its ``"__tensor__"``
entry turns a numpy value into a tensor on the device of the tensor it
meets (``OnnxNet`` makes each such copy once, before any capture, and
keeps it).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MAPPERS: dict = {}


def register(*op_types):
    def deco(fn):
        for op in op_types:
            MAPPERS[op] = fn
        return fn
    return deco


def _pair(v, n=2, default=1):
    if v is None:
        return (default,) * n
    v = list(v)
    return tuple(v[:n]) if len(v) >= n else tuple(v) * n


def _plain_tensor(a, like):
    return torch.as_tensor(np.asarray(a), device=like.device)


def _t(consts, a, like):
    """``a`` as a tensor on ``like``'s device (a numpy constant through
    ``consts["__tensor__"]``); a tensor or a Python scalar as it is."""
    if isinstance(a, np.ndarray) and torch.is_tensor(like):
        return consts.get("__tensor__", _plain_tensor)(a, like)
    return a


def _tensors(consts, *xs):
    like = next((x for x in xs if torch.is_tensor(x)), None)
    return [_t(consts, x, like) for x in xs]


def _conv_padding(attrs, spatial_rank, in_sizes=None, kernel=None,
                  strides=None, dilations=None):
    pads = attrs.get("pads")
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        # explicit per-dim pads so SAME_LOWER's extra pad at the start is
        # honoured
        out = []
        strides = strides or (1,) * spatial_rank
        dilations = dilations or (1,) * spatial_rank
        for size, k, s, d in zip(in_sizes, kernel, strides, dilations):
            eff = (k - 1) * d + 1
            n_out = -(-size // s)  # ceil
            total = max(0, (n_out - 1) * s + eff - size)
            small, big = total // 2, total - total // 2
            out.append((big, small) if auto == "SAME_LOWER"
                       else (small, big))
        return out
    if pads is None:
        return [(0, 0)] * spatial_rank
    # onnx pads = [x1_begin, x2_begin, ..., x1_end, x2_end, ...]
    return [(int(pads[i]), int(pads[i + spatial_rank]))
            for i in range(spatial_rank)]


def _pad_spatial(x, pads, value=0.0):
    """``x`` padded on its trailing spatial dims by ``[(lo, hi), ...]``."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [int(lo), int(hi)]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


# ---------------------------------------------------------------------------
# math / activations
# ---------------------------------------------------------------------------

def _binary(fn):
    def mapper(attrs, consts, a, b):
        a, b = _tensors(consts, a, b)
        return fn(a, b)
    return mapper


MAPPERS["Add"] = _binary(lambda a, b: a + b)
MAPPERS["Sub"] = _binary(lambda a, b: a - b)
MAPPERS["Mul"] = _binary(lambda a, b: a * b)
MAPPERS["Div"] = _binary(lambda a, b: a / b)
MAPPERS["Pow"] = _binary(torch.pow)


@register("Neg")
def _neg(attrs, consts, a):
    return -a


@register("Abs")
def _abs(attrs, consts, a):
    return torch.abs(a)


@register("Exp")
def _exp(attrs, consts, a):
    return torch.exp(a)


@register("Log")
def _log(attrs, consts, a):
    return torch.log(a)


@register("Sqrt")
def _sqrt(attrs, consts, a):
    return torch.sqrt(a)


@register("Reciprocal")
def _recip(attrs, consts, a):
    return 1.0 / a


@register("Relu")
def _relu(attrs, consts, a):
    return torch.relu(a)


@register("LeakyRelu")
def _leaky(attrs, consts, a):
    return torch.where(a >= 0, a, attrs.get("alpha", 0.01) * a)


@register("Elu")
def _elu(attrs, consts, a):
    alpha = attrs.get("alpha", 1.0)
    return torch.where(a >= 0, a, alpha * torch.expm1(a))


@register("Sigmoid")
def _sigmoid(attrs, consts, a):
    return torch.sigmoid(a)


@register("HardSigmoid")
def _hard_sigmoid(attrs, consts, a):
    alpha = attrs.get("alpha", 0.2)
    beta = attrs.get("beta", 0.5)
    return torch.clamp(alpha * a + beta, 0.0, 1.0)


@register("Tanh")
def _tanh(attrs, consts, a):
    return torch.tanh(a)


def _softmax_like(fn):
    def mapper(attrs, consts, a):
        opset = consts.get("__opset__", 13)
        if opset >= 13:
            return fn(a, dim=attrs.get("axis", -1))
        # pre-13: coerce to 2D at `axis` (default 1), softmax the trailing
        # flattened block, restore the shape
        axis = attrs.get("axis", 1) % a.dim()
        lead = int(np.prod(a.shape[:axis])) if axis else 1
        return fn(a.reshape(lead, -1), dim=-1).reshape(a.shape)
    return mapper


MAPPERS["Softmax"] = _softmax_like(torch.softmax)
MAPPERS["LogSoftmax"] = _softmax_like(torch.log_softmax)


@register("Softplus")
def _softplus(attrs, consts, a):
    # log(1 + e^x) as jax.nn.softplus (logaddexp(x, 0)), no threshold
    return torch.logaddexp(a, torch.zeros((), dtype=a.dtype,
                                          device=a.device))


@register("Clip")
def _clip(attrs, consts, a, *bounds):
    from analytics_zoo_tpu_torch.pipeline.api.autograd import clip_values

    lo = bounds[0] if len(bounds) > 0 else attrs.get("min")
    hi = bounds[1] if len(bounds) > 1 else attrs.get("max")
    # minimum(maximum(...)) as jnp.clip: a tie splits the gradient evenly
    return clip_values(a, *(_t(consts, b, a) for b in (lo, hi)))


@register("Erf")
def _erf(attrs, consts, a):
    return torch.erf(a)


@register("Max")
def _max(attrs, consts, *xs):
    xs = _tensors(consts, *xs)
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x)
    return out


@register("Min")
def _min(attrs, consts, *xs):
    xs = _tensors(consts, *xs)
    out = xs[0]
    for x in xs[1:]:
        out = torch.minimum(out, x)
    return out


@register("Sum")
def _sum(attrs, consts, *xs):
    xs = _tensors(consts, *xs)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


# ---------------------------------------------------------------------------
# linear algebra
# ---------------------------------------------------------------------------

@register("MatMul")
def _matmul(attrs, consts, a, b):
    a, b = _tensors(consts, a, b)
    return a @ b


@register("Gemm")
def _gemm(attrs, consts, a, b, c=None):
    a, b, c = _tensors(consts, a, b, c)
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    if attrs.get("transA", 0):
        a = a.T
    if attrs.get("transB", 0):
        b = b.T
    y = a @ b
    if alpha != 1.0:
        y = alpha * y
    if c is not None:
        y = y + (c if beta == 1.0 else beta * c)
    return y


# ---------------------------------------------------------------------------
# convolution / pooling (NCHW, per ONNX spec)
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Conv")
def _conv(attrs, consts, x, w, b=None):
    x, w, b = _tensors(consts, x, w, b)
    rank = x.dim() - 2
    strides = _pair(attrs.get("strides"), rank)
    dilations = _pair(attrs.get("dilations"), rank)
    groups = int(attrs.get("group", 1))
    pads = _conv_padding(attrs, rank, x.shape[2:], w.shape[2:], strides,
                         dilations)
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        x, padding = _pad_spatial(x, pads), 0
    return _CONV[rank](x, w, b, stride=strides, padding=padding,
                       dilation=dilations, groups=groups)


@register("ConvTranspose")
def _conv_transpose(attrs, consts, x, w, b=None):
    x, w, b = _tensors(consts, x, w, b)
    rank = x.dim() - 2
    if int(attrs.get("group", 1)) != 1:
        raise NotImplementedError("ConvTranspose: group > 1")
    if attrs.get("output_shape") is not None:
        raise NotImplementedError(
            "ConvTranspose: explicit output_shape (use pads/output_padding)"
        )
    strides = _pair(attrs.get("strides"), rank)
    dilations = _pair(attrs.get("dilations"), rank)
    out_pad = _pair(attrs.get("output_padding"), rank, default=0)
    pads = _conv_padding(attrs, rank, x.shape[2:], w.shape[2:], strides,
                         dilations)
    # the full transposed convolution, then onnx's pads trim it and
    # output_padding extends its end with positions no input reaches;
    # the onnx kernel (in, out, *k) is torch's own layout
    y = _CONV_T[rank](x, w, None, stride=strides, dilation=dilations)
    for i, ((lo, hi), op) in enumerate(zip(pads, out_pad)):
        dim, full = 2 + i, y.shape[2 + i]
        grow = op - hi
        if grow > 0:
            shape = list(y.shape)
            shape[dim] = grow
            y = torch.cat([y, y.new_zeros(shape)], dim=dim)
        y = y.narrow(dim, lo, full - lo - hi + op)
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * rank)
    return y


def _window_reduce(x, k, strides, dilations, mode):
    """Max or sum over windows of ``x``'s trailing spatial dims (already
    padded), any rank and dilation, through unfolded views."""
    rank = len(k)
    y = x
    for i in range(rank):
        eff = (k[i] - 1) * dilations[i] + 1
        y = y.unfold(2 + i, eff, strides[i])
        if dilations[i] > 1:
            y = y[..., ::dilations[i]]
    y = y.reshape(y.shape[:2 + rank] + (-1,))
    return y.amax(dim=-1) if mode == "max" else y.sum(dim=-1)


def _pool_sum_or_max(x, k, strides, dilations, mode):
    rank = len(k)
    if rank in (1, 2, 3) and mode == "max":
        return {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[rank](
            x, k, strides, dilation=dilations)
    if rank in (2, 3) and all(d == 1 for d in dilations):
        return {2: F.avg_pool2d, 3: F.avg_pool3d}[rank](
            x, k, strides, divisor_override=1)
    return _window_reduce(x, k, strides, dilations, mode)


def _pool(x, attrs, mode, is_avg=False):
    rank = x.dim() - 2
    k = tuple(attrs["kernel_shape"])
    strides = _pair(attrs.get("strides"), rank)
    dilations = _pair(attrs.get("dilations"), rank)
    pads = _conv_padding(attrs, rank, x.shape[2:], k, strides, dilations)
    if attrs.get("ceil_mode", 0):
        # extend the end padding so the window count is the ceil one
        new = []
        for size, ki, s, d, (lo, hi) in zip(x.shape[2:], k, strides,
                                            dilations, pads):
            eff = (ki - 1) * d + 1
            n_ceil = -(-(size + lo + hi - eff) // s) + 1
            needed = (n_ceil - 1) * s + eff - (size + lo + hi)
            new.append((lo, hi + max(0, needed)))
        pads = new
    fill = -float("inf") if mode == "max" else 0.0
    y = _pool_sum_or_max(_pad_spatial(x, pads, fill), k, strides, dilations,
                         mode)
    if is_avg:
        if attrs.get("count_include_pad", 0):
            return y / float(np.prod(k))
        ones = _pad_spatial(torch.ones_like(x), pads, 0.0)
        y = y / _pool_sum_or_max(ones, k, strides, dilations, "sum")
    return y


@register("MaxPool")
def _maxpool(attrs, consts, x):
    return _pool(x, attrs, "max")


@register("AveragePool")
def _avgpool(attrs, consts, x):
    return _pool(x, attrs, "sum", is_avg=True)


@register("GlobalAveragePool")
def _gap(attrs, consts, x):
    return torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)


@register("GlobalMaxPool")
def _gmp(attrs, consts, x):
    return torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True)


@register("BatchNormalization")
def _batchnorm(attrs, consts, x, scale, bias, mean, var):
    x, scale, bias, mean, var = _tensors(consts, x, scale, bias, mean, var)
    eps = attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(var + eps)
    return (x - mean.reshape(shape)) * (scale * inv).reshape(shape) \
        + bias.reshape(shape)


@register("InstanceNormalization")
def _instancenorm(attrs, consts, x, scale, bias):
    x, scale, bias = _tensors(consts, x, scale, bias)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, unbiased=False)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) * torch.rsqrt(var + eps) * scale.reshape(shape) \
        + bias.reshape(shape)


def channel_window_sum(sq, size):
    """Sum of ``size`` neighbouring channels (axis 1) of ``sq``, the window
    centred as caffe's and onnx's LRN centre it (zero beyond the ends)."""
    lo = (size - 1) // 2
    shape = list(sq.shape)
    pieces = []
    if lo:
        shape[1] = lo
        pieces.append(sq.new_zeros(shape))
    pieces.append(sq)
    if size - 1 - lo:
        shape[1] = size - 1 - lo
        pieces.append(sq.new_zeros(shape))
    padded = torch.cat(pieces, dim=1) if len(pieces) > 1 else sq
    c = sq.shape[1]
    out = padded.narrow(1, 0, c)
    for i in range(1, size):
        out = out + padded.narrow(1, i, c)
    return out


@register("LRN")
def _lrn(attrs, consts, x):
    size = int(attrs["size"])
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    k = attrs.get("bias", 1.0)
    window = channel_window_sum(torch.square(x), size)
    return x / torch.pow(k + alpha / size * window, beta)


@register("Dropout", "Identity")
def _identity(attrs, consts, x, *rest):
    return x


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------

@register("Reshape")
def _reshape(attrs, consts, x, shape=None):
    if shape is None:
        shape_vals = attrs.get("shape")  # opset 1
    elif isinstance(shape, np.ndarray):
        shape_vals = [int(s) for s in shape]
    else:
        raise ValueError(
            "Reshape: the shape input must be a graph constant "
            "(initializer/Constant output): the step's shapes are fixed "
            "when it is built")
    out_shape = [x.shape[i] if s == 0 else int(s)
                 for i, s in enumerate(shape_vals)]
    return torch.reshape(x, out_shape)


@register("Flatten")
def _flatten(attrs, consts, x):
    axis = attrs.get("axis", 1)
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return torch.reshape(x, (lead, -1))


@register("Transpose")
def _transpose(attrs, consts, x):
    perm = attrs.get("perm")
    if perm is None:
        perm = tuple(reversed(range(x.dim())))
    return x.permute(*perm)


@register("Concat")
def _concat(attrs, consts, *xs):
    return torch.cat(_tensors(consts, *xs), dim=attrs.get("axis", 0))


@register("Squeeze")
def _squeeze(attrs, consts, x, axes=None):
    ax = attrs.get("axes")
    if isinstance(axes, np.ndarray):
        ax = [int(a) for a in axes]
    if not ax:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=tuple(a % x.dim() for a in ax))


@register("Unsqueeze")
def _unsqueeze(attrs, consts, x, axes=None):
    ax = attrs.get("axes")
    if isinstance(axes, np.ndarray):
        ax = [int(a) for a in axes]
    for a in sorted(ax):
        x = torch.unsqueeze(x, a)
    return x


@register("Gather")
def _gather(attrs, consts, x, indices):
    x, indices = _tensors(consts, x, indices)
    axis = attrs.get("axis", 0) % x.dim()
    idx = indices.long()
    # jnp.take: a negative index wraps once
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(indices.shape)
                       + tuple(x.shape[axis + 1:]))


@register("Slice")
def _slice(attrs, consts, x, *args):
    if args:  # opset >= 10: starts/ends/axes/steps as const inputs
        vals = [None if a is None else [int(v) for v in np.asarray(a)]
                for a in args]
        starts, ends = vals[0], vals[1]
        axes = vals[2] if len(vals) > 2 and vals[2] is not None \
            else list(range(len(starts)))
        steps = vals[3] if len(vals) > 3 and vals[3] is not None \
            else [1] * len(starts)
    else:  # opset 1: attributes
        starts = attrs["starts"]
        ends = attrs["ends"]
        axes = attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    idx = [slice(None)] * x.dim()
    for s, e, a, st in zip(starts, ends, axes, steps):
        if st < 0:
            raise NotImplementedError("Slice: negative steps")
        idx[a] = slice(s, None if e >= x.shape[a] else e, st)
    return x[tuple(idx)]


@register("Split")
def _split(attrs, consts, x, split=None):
    axis = attrs.get("axis", 0)
    parts = attrs.get("split")
    if isinstance(split, np.ndarray):
        parts = [int(s) for s in split]
    if parts is None:
        raise ValueError("Split: missing split sizes")
    return list(torch.split(x, [int(p) for p in parts], dim=axis))


@register("Pad")
def _pad(attrs, consts, x, pads=None, value=None):
    p = attrs.get("pads")
    if isinstance(pads, np.ndarray):
        p = [int(v) for v in pads]
    mode = attrs.get("mode", "constant")
    half = len(p) // 2
    widths = [(p[i], p[i + half]) for i in range(half)]
    flat = []
    for lo, hi in reversed(widths):
        flat += [int(lo), int(hi)]
    if mode == "constant":
        cval = float(np.asarray(value)) if value is not None \
            else attrs.get("value", 0.0)
        return F.pad(x, flat, value=cval)
    # reflect/edge pad the trailing dims; the leading widths must be 0
    while flat[-2:] == [0, 0] and len(flat) > 2:
        flat = flat[:-2]
    return F.pad(x, flat, mode={"reflect": "reflect",
                                "edge": "replicate"}[mode])


@register("Shape")
def _shape(attrs, consts, x):
    return np.asarray(x.shape, dtype=np.int64)


_TORCH_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                 6: torch.int32, 7: torch.int64, 9: torch.bool,
                 11: torch.float64}


@register("Cast")
def _cast(attrs, consts, x):
    return x.to(_TORCH_DTYPES[int(attrs["to"])])


@register("Expand")
def _expand(attrs, consts, x, shape):
    target = [int(s) for s in np.asarray(shape)]
    # onnx Expand: numpy-style right-aligned broadcast; either side may
    # have more dims, and target dims of 1 keep the input size
    ndim = max(x.dim(), len(target))
    xs = (1,) * (ndim - x.dim()) + tuple(x.shape)
    ts = [1] * (ndim - len(target)) + target
    out = [max(t, s) for t, s in zip(ts, xs)]
    return torch.broadcast_to(x, out)


@register("Tile")
def _tile(attrs, consts, x, repeats):
    return torch.tile(x, tuple(int(r) for r in np.asarray(repeats)))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduce(fn):
    def mapper(attrs, consts, x, axes_in=None):
        axes = attrs.get("axes")
        if isinstance(axes_in, np.ndarray):
            axes = [int(a) for a in axes_in]
        keep = bool(attrs.get("keepdims", 1))
        ax = tuple(axes) if axes else tuple(range(x.dim()))
        return fn(x, ax, keep)
    return mapper


def _prod(x, ax, keep):
    for a in sorted((a % x.dim() for a in ax), reverse=True):
        x = torch.prod(x, dim=a, keepdim=keep)
    return x


MAPPERS["ReduceMean"] = _reduce(
    lambda x, ax, keep: torch.mean(x, dim=ax, keepdim=keep))
MAPPERS["ReduceSum"] = _reduce(
    lambda x, ax, keep: torch.sum(x, dim=ax, keepdim=keep))
MAPPERS["ReduceMax"] = _reduce(
    lambda x, ax, keep: torch.amax(x, dim=ax, keepdim=keep))
MAPPERS["ReduceMin"] = _reduce(
    lambda x, ax, keep: torch.amin(x, dim=ax, keepdim=keep))
MAPPERS["ReduceProd"] = _reduce(_prod)


@register("ArgMax")
def _argmax(attrs, consts, x):
    axis = attrs.get("axis", 0)
    keep = bool(attrs.get("keepdims", 1))
    # int32 indices, as the reference's jnp.argmax gives them
    return torch.argmax(x, dim=axis, keepdim=keep).to(torch.int32)


@register("Constant")
def _constant(attrs, consts):
    # numpy (not a tensor), so the interpreter keeps it static and
    # shape-consuming ops (Reshape/Slice...) can read concrete values
    return np.asarray(attrs["value"])
