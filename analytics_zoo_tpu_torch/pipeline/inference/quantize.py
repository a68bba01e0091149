"""int8 quantization for inference: weight-only and calibrated.

Counterpart of ``analytics_zoo_tpu/pipeline/inference/quantize.py``.

Weight-only: per-output-channel symmetric int8 quantization of the
parameter tree, dequantized right before use.  Rounding is half-to-even on
both sides (``torch.round``, like ``jnp.round``), so the int8 values equal
the reference's.  :func:`quantize_params_for_plan` quantizes exactly the
leaves a plan's ``dtype_rules`` mark ``"int8"``, and
:func:`quantized_matmul` is the consumer of one quantized weight: under a
plan whose ``kernel_rules`` route ``serving.int8_matmul`` to
``int8_matmul`` it takes the CUDA kernel (``ops/cuda/int8_matmul.py``),
otherwise dequantize-then-matmul, as in the reference.

Calibrated: :func:`calibrate_activations` records the input range of
each top-level Dense and conv layer (the reference's ``_ConvND``:
``Convolution1D/2D/3D``, ``AtrousConvolution1D/2D``,
``ShareConvolution2D``) over calibration batches; :class:`Int8Model` then
runs those layers as int8 x int8 -> int32 with one rescale to float after,
in the reference's order (:func:`_int8_dense`, :func:`_int8_conv`),
through per-layer ``apply`` hooks installed for the duration of a forward
(:func:`_hooked`).  Each hooked layer is two calls of
``ops/cuda/int8_conv.py`` (two kernel launches on the card, their plain
versions on the CPU): ``quantize_act`` (the input quantized, its channels
zero-padded to a multiple of 16) and ``int8_conv`` with its fused
epilogue (the int32 sums times ``act_scale * w_scale``, the bias, and a
relu activation; a Dense is a 1x1 convolution over its rows); any other
activation follows in torch.  The kernel reads each hooked kernel as a
(Cout, K) copy with zero rows for the padded channels, the epilogue its
``act_scale * w_scale``, and a split launch the layer's own tickets, all
made by :class:`Int8Model` once, before any capture, and held for its life: a replayed forward reads them by
address.  The depthwise, separable, transposed and locally connected
convolutions are no targets, in either package, and stay float.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.utils import tree_leaves, tree_map
from analytics_zoo_tpu_torch.ops.cuda.int8_conv import (
    conv_weight_t,
    int8_conv,
    new_tickets,
    quantize_act,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (
    ShareConvolution2D,
    _ConvND,
    same_pads,
)


class QuantizedTensor:
    """int8 values + per-channel float scale; one leaf of a param tree."""

    def __init__(self, values, scale, axis: int):
        self.values = values          # int8, original shape
        self.scale = scale            # f32, broadcastable to values
        self.axis = axis

    def dequantize(self, dtype=torch.float32):
        return self.values.to(dtype) * self.scale.to(dtype)

    @property
    def shape(self):
        return self.values.shape


def _quantize_array(a, axis: int) -> QuantizedTensor:
    axis = axis % a.dim()
    reduce_axes = tuple(i for i in range(a.dim()) if i != axis)
    amax = a.abs().amax(dim=reduce_axes, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale, axis)


def quantize_params(params, min_size: int = 1024):
    """Quantize every large (>= min_size elements, ndim >= 2) floating
    weight to int8 over its last (output-channel) axis; biases and norms
    stay in full precision."""
    def q(leaf):
        if leaf.dim() >= 2 and leaf.numel() >= min_size \
                and leaf.is_floating_point():
            return _quantize_array(leaf, axis=-1)
        return leaf

    return tree_map(q, params)


def quantize_params_for_plan(params, plan, min_size: int = 1024):
    """Quantize exactly the leaves whose dtype role under
    ``plan.dtype_rules`` is ``"int8"`` (:func:`~analytics_zoo_tpu_torch.
    parallel.plan.int8_serving` marks every leaf).  The structural gate of
    :func:`quantize_params` still applies to each marked leaf (ndim >= 2,
    >= ``min_size`` elements, floating), so a catch-all rule leaves biases
    and norms alone.  A plan that marks nothing int8 returns the tree
    itself."""
    from analytics_zoo_tpu_torch.parallel.partition import (
        leaf_path_name,
        tree_map_with_path,
    )

    roles = plan.dtype_roles(params)
    if not any(r == "int8" for r in roles.values()):
        return params

    def q(path, leaf):
        if (roles.get(leaf_path_name(path)) == "int8"
                and leaf.dim() >= 2 and leaf.numel() >= min_size
                and leaf.is_floating_point()):
            return _quantize_array(leaf, axis=-1)
        return leaf

    return tree_map_with_path(q, params)


def quantized_matmul(x, qt):
    """``x @ dequantize(qt)``, the consumer of a quantized dense weight.

    Under a plan whose ``kernel_rules`` route ``serving.int8_matmul`` to
    ``int8_matmul``, a 2-D weight with its scale on the last axis goes to
    :func:`~analytics_zoo_tpu_torch.ops.cuda.int8_matmul.int8_matmul` (the
    kernel for a CUDA tensor, its plain version for a CPU one): the weight
    stays one byte per element.  x may have any leading dims and strides
    (a (B, L, K) activation, a transposed view): they are flattened into
    one contiguous (M, K) operand, so one kernel launch covers the call,
    and the output takes x's leading dims back.  Every other case (no
    plan, no rule, an explicit ``"xla"`` pick, 3-D values, an axis-0 scale)
    is dequantize-then-matmul, as in the reference.  A plain tensor is a
    plain matmul."""
    if isinstance(qt, QuantizedTensor) and qt.values.dim() == 2 \
            and qt.axis == qt.values.dim() - 1:
        from analytics_zoo_tpu_torch.parallel.plan import resolve_kernel

        if resolve_kernel("serving.int8_matmul") == "int8_matmul":
            from analytics_zoo_tpu_torch.ops.cuda.int8_matmul import (
                int8_matmul,
            )

            x2 = x.reshape(-1, x.shape[-1]).contiguous()
            out = int8_matmul(x2, qt.values, qt.scale.reshape(-1))
            return out.reshape(*x.shape[:-1], out.shape[-1])
    if isinstance(qt, QuantizedTensor):
        return x @ qt.dequantize(x.dtype)
    return x @ qt


def quantized_bytes_ratio(params, qparams) -> float:
    """quantized-bytes / original-bytes over the whole tree (int8 values +
    f32 scales vs the float original; unquantized leaves count at full
    width on both sides)."""
    def nbytes(leaf):
        if isinstance(leaf, QuantizedTensor):
            return (leaf.values.numel() * leaf.values.element_size()
                    + leaf.scale.numel() * leaf.scale.element_size())
        return leaf.numel() * leaf.element_size()

    orig = sum(nbytes(l) for l in tree_leaves(params))
    quant = sum(nbytes(l) for l in tree_leaves(qparams))
    return float(quant) / float(orig) if orig else 1.0


def dequantize_params(params, dtype=torch.float32):
    """Materialize a float tree from a quantized one, on the tree's
    device."""
    return tree_map(lambda leaf: leaf.dequantize(dtype)
                    if isinstance(leaf, QuantizedTensor) else leaf, params)


def quantization_error(params, qparams) -> float:
    """Max relative L2 error across quantized leaves (calibration check)."""
    errs = []
    for a, qa in zip(tree_leaves(params), tree_leaves(qparams)):
        if isinstance(qa, QuantizedTensor):
            a = a.detach().cpu().numpy()
            d = qa.dequantize().cpu().numpy()
            denom = np.linalg.norm(a)
            if denom > 0:
                errs.append(float(np.linalg.norm(a - d) / denom))
    return max(errs) if errs else 0.0


# ---------------------------------------------------------------------------
# Activation calibration + int8 x int8 execution
# ---------------------------------------------------------------------------

#: conv layer classes that are calibration targets (the reference's
#: ``_ConvND``), run by :func:`_int8_conv`
_CONV_TYPES: tuple = (_ConvND,)


def _target_layers(net):
    """The net's top-level Dense and conv layers, as in the reference:
    layers nested inside another layer (BERT's own projections) are not
    targets."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import Dense

    return [l for l in net.layers
            if isinstance(l, (Dense,) + _CONV_TYPES)
            and getattr(l, "name", None)]


# Serializes every apply-hook installation and every forward that could
# observe one: a layer's ``apply`` is shared by every user of the net, so
# a float forward of the same net racing an int8 installation would run the
# int8 path.  A captured forward bakes the hooks into its CUDA graph, as
# the reference's executable does: they are installed only for its eager
# run and its capture, and its replays take no lock.  Every forward that
# runs in Python (on the CPU, every one) installs them anew, and such
# forwards of any model run one at a time.
HOOK_LOCK = threading.RLock()


@contextmanager
def _hooked(assignments):
    """Install {layer: wrapped_apply}, restore on exit, under HOOK_LOCK."""
    originals = {}
    with HOOK_LOCK:
        try:
            for layer, wrapped in assignments.items():
                originals[layer] = layer.apply
                layer.apply = wrapped
            yield
        finally:
            for layer, orig in originals.items():
                layer.apply = orig


def _as_input(xb, device):
    t = torch.from_numpy(np.ascontiguousarray(xb))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def calibrate_activations(net, x_batches, params=None, state=None):
    """Per-layer input abs-max over calibration batches (eager forwards
    with per-instance ``apply`` hooks); returns {layer_name: scale}, where
    the scale maps float inputs to int8 (amax / 127)."""
    params = params if params is not None else net.params
    state = state if state is not None else net.state
    amax: dict[str, float] = {}

    def hook(layer, orig):
        def wrapped(p, inputs, **kw):
            m = float(inputs.abs().max())
            amax[layer.name] = max(amax.get(layer.name, 0.0), m)
            return orig(p, inputs, **kw)

        return wrapped

    assignments = {l: hook(l, l.apply) for l in _target_layers(net)}
    with _hooked(assignments), torch.inference_mode():
        for xb in x_batches:
            net.forward(params, _as_input(xb, net.device), state=state,
                        training=False)
    return {k: (v / 127.0 if v > 0 else 1.0) for k, v in amax.items()}


def _epilogue(layer, qt, act_scale, params, mult, tickets):
    """The fused convolution's epilogue arguments of a hooked layer:
    ``mult`` (made here as the reference makes it, ``act_scale *
    w_scale``, when not given), the bias or None, whether its activation
    is relu (fused; any other activation runs after the kernel), and the
    layer's split-K tickets."""
    if mult is None:
        mult = act_scale * qt.scale.reshape(-1)  # per output channel
    relu = getattr(layer.activation, "name", None) == "relu"
    return dict(mult=mult, bias=params["bias"] if layer.bias else None,
                relu=relu, tickets=tickets)


def _int8_dense(layer, qt, act_scale, params, x, w_t=None, mult=None,
                tickets=None):
    """The reference's ``_int8_dense``: the input quantized (its features
    zero-padded to the (Cout, K_p) copy ``w_t``'s K_p, made here when not
    given), its int8 product with the kernel as a 1x1 ``int8_conv`` over
    the rows with the epilogue ``acc * (act_scale * w_scale)``, the bias
    and a relu fused, then any other activation."""
    if w_t is None:
        w_t = conv_weight_t(qt.values, pad=True)
    xs = quantize_act(x.contiguous(), act_scale, w_t.shape[1])
    ep = _epilogue(layer, qt, act_scale, params, mult, tickets)
    y = int8_conv(xs.reshape(-1, 1, w_t.shape[1]), w_t, (1,), (1,), (1,),
                  ((0, 0),), **ep)
    y = y.reshape(*x.shape[:-1], w_t.shape[0])
    return y if ep["relu"] else layer.activation(y)


def _conv_pads(layer, spatial):
    """(before, after) per spatial dim: the reference pads by
    ``layer.border_mode`` alone (XLA's SAME with the dilated window, or
    none)."""
    if layer.border_mode == "same":
        return tuple(same_pads(int(n), k, s, d) for n, k, s, d in zip(
            spatial, layer.kernel_size, layer.subsample, layer.dilation))
    return ((0, 0),) * len(spatial)


def _int8_conv(layer, qt, act_scale, params, x, w_t=None, mult=None,
               tickets=None):
    """The reference's ``_int8_conv``: the input quantized (its channels
    zero-padded to those of the (Cout, K) kernel copy ``w_t``, made here
    padded to a multiple of 16 when not given), its convolution with the
    int8 kernel (``int8_conv``) with the epilogue ``acc * (act_scale *
    w_scale)``, the bias and a relu fused, in that order, then any other
    activation."""
    if w_t is None:
        w_t = conv_weight_t(qt.values, pad=True)
    taps = int(np.prod(layer.kernel_size))
    xs = quantize_act(x.contiguous(), act_scale, w_t.shape[1] // taps)
    ep = _epilogue(layer, qt, act_scale, params, mult, tickets)
    y = int8_conv(xs, w_t, layer.kernel_size, layer.subsample,
                  layer.dilation, _conv_pads(layer, xs.shape[1:-1]), **ep)
    return y if ep["relu"] else layer.activation(y)


def _check_target(layer):
    """Raise for a hooked layer whose int8 path would serve another
    function than its float one."""
    if isinstance(layer, ShareConvolution2D) and (layer.pad_h
                                                  or layer.pad_w):
        raise ValueError(
            f"calibrated int8 of {layer.name}: a ShareConvolution2D with "
            f"pad_h={layer.pad_h}, pad_w={layer.pad_w} is not served: the "
            "reference's _int8_conv pads by border_mode ('valid') and "
            "never applies the layer's explicit pads, so its int8 path "
            "computes another output shape than the float layer (a fault "
            "of the reference)")


class Int8Model:
    """Calibrated int8 inference wrapper around a KerasNet.

    ``quantize_model(net, calib_x)`` builds one; ``predict`` runs the
    hooked Dense and conv layers as int8 x int8 -> int32 with calibrated
    activation scales, everything else in float.  ``weights_t`` holds each
    hooked layer's kernel as the (Cout, K) int8 copy the ``int8_conv``
    kernel reads (each tap's channels zero-padded to a multiple of 16),
    ``scales_t`` its activation scale as an f32 scalar tensor on the
    kernel's device, ``mults_t`` the epilogue's per-channel f32
    ``act_scale * w_scale`` (the product the reference forms on every
    call), and ``tickets_t`` its own zeroed split-K tickets (so no two
    layers or models share one, whichever streams they run on), all made
    here once and kept as long as the model (a captured forward reads
    them by address); none is part of ``qparams``, whose tree stays the
    reference's.  One model's forwards run one at a time: two overlapping
    forwards of the same model on two streams would share its tickets.  The quantization divides by the scale
    tensor, not the Python float: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which rounds some quotients one
    ulp away from the reference's ``x / scale`` and so moves activations
    that sit at a rounding boundary by one int8 step.
    """

    def __init__(self, net, qparams, act_scales):
        self.net = net
        self.qparams = qparams
        self.act_scales = dict(act_scales)
        self.weights_t, self.scales_t, self.mults_t = {}, {}, {}
        self.tickets_t = {}
        for layer in self._targets():
            _check_target(layer)
            qt = self.qparams[layer.name]["kernel"]
            self.weights_t[layer.name] = conv_weight_t(qt.values, pad=True)
            scale = self.scales_t[layer.name] = torch.tensor(
                self.act_scales[layer.name], dtype=torch.float32,
                device=qt.values.device)
            self.mults_t[layer.name] = (
                scale * qt.scale.reshape(-1)).contiguous()
            self.tickets_t[layer.name] = new_tickets(qt.values.device)

    def _targets(self):
        """The target layers with an int8 kernel and an activation scale:
        the layers the hooks run."""
        return [l for l in _target_layers(self.net)
                if isinstance(self.qparams.get(l.name, {}).get("kernel"),
                              QuantizedTensor)
                and self.act_scales.get(l.name) is not None]

    def _assignments(self):
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import (
            Dense,
        )

        assignments = {}
        for layer in self._targets():
            kernel_fn = _int8_dense if isinstance(layer, Dense) \
                else _int8_conv

            def wrapped(p, inputs, *, _l=layer,
                        _qt=self.qparams[layer.name]["kernel"],
                        _s=self.scales_t[layer.name],
                        _w=self.weights_t[layer.name],
                        _m=self.mults_t[layer.name],
                        _k=self.tickets_t[layer.name], _fn=kernel_fn, **kw):
                return (_fn(_l, _qt, _s, p, inputs, _w, _m, _k),
                        kw.get("state"))

            assignments[layer] = wrapped
        return assignments

    def installed(self):
        """Context manager: the int8 apply hooks active (and exclusive, see
        HOOK_LOCK) for its duration."""
        return _hooked(self._assignments())

    def forward(self, x):
        """One forward of device tensor(s) ``x`` with the hooks installed."""
        with self.installed(), torch.inference_mode():
            return self.net.forward(self.qparams, x, state=self.net.state,
                                    training=False)[0]

    def predict(self, x, batch_size: int = 32):
        """Batched predict; the tail batch is padded with copies of its last
        record to ``batch_size``, so every forward has one shape."""
        outs = []
        n = np.shape(x)[0]
        for i in range(0, n, batch_size):
            xb = np.asarray(x[i:i + batch_size])
            pad = batch_size - xb.shape[0]
            if pad:
                xb = np.concatenate(
                    [xb, np.repeat(xb[-1:], pad, axis=0)], axis=0)
            out = self.forward(_as_input(xb, self.net.device))
            out = out.cpu().numpy()
            outs.append(out[:out.shape[0] - pad] if pad else out)
        return np.concatenate(outs, axis=0)


def quantize_model(net, calib_x, batch_size: int = 32,
                   min_size: int = 1024) -> Int8Model:
    """Weight quantization + activation calibration in one step.

    ``calib_x``: representative inputs, a single array (multi-input models
    are not calibratable, as in the reference).  Only the kernels of the
    layers that get int8 hooks (top-level Dense and conv layers with a
    calibration scale and a kernel of at least ``min_size`` elements) are
    quantized; every other weight stays float.  Raises ``ValueError`` for
    a hooked ``ShareConvolution2D`` with explicit pads (see
    :func:`_check_target`).
    """
    if isinstance(calib_x, (list, tuple)):
        raise ValueError(
            "quantize_model: multi-input calibration is not supported; "
            "pass a single input array")
    batches = [calib_x[i:i + batch_size]
               for i in range(0, np.shape(calib_x)[0], batch_size)]
    scales = calibrate_activations(net, batches)
    hooked = {l.name for l in _target_layers(net) if l.name in scales}
    qparams = {}
    for lname, group in net.params.items():
        if lname in hooked and isinstance(group, dict) \
                and "kernel" in group:
            g = dict(group)
            k = g["kernel"]
            if k.dim() >= 2 and k.numel() >= min_size:
                g["kernel"] = _quantize_array(k, axis=-1)
            qparams[lname] = g
        else:
            qparams[lname] = group
    return Int8Model(net, qparams, scales)
