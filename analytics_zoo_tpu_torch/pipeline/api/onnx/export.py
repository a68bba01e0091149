"""ONNX exporter: trained nets out to the interchange format.

Counterpart of ``analytics_zoo_tpu/pipeline/api/onnx/export.py`` (the
reference's ``NetSaver``, Net.scala:264+), with the same writer: the
port's wire codec (proto.py), no ``onnx`` package.  For the same weights
its bytes equal the JAX package's byte for byte.

Semantics: the exported graph follows ONNX conventions: NCHW activations
(the framework is NHWC, so conv kernels are transposed from HWIO to OIHW,
SAME padding becomes explicit ``pads``, and Dense kernels after a Flatten
are row-permuted to the CHW element order), inference mode (dropout
dropped, batch-norm frozen to its moving statistics).
``load_onnx(export_onnx(net))`` reproduces ``net``'s forward outputs on
transposed inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.pipeline.api.onnx.proto import (
    FLOAT,
    Graph,
    Model,
    Node,
    ValueInfo,
    encode_model,
)

# NamedActivation.name -> ONNX op (None = identity, drop the node)
_ACT_OPS = {
    None: None, "linear": None,
    "relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
    "softmax": "Softmax", "log_softmax": "LogSoftmax",
    "elu": "Elu", "selu": "Selu", "softplus": "Softplus",
    "softsign": "Softsign",
}


def _np(a):
    """A parameter or state leaf as a numpy array."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class _Exporter:
    def __init__(self, opset=13):
        self.graph = Graph(name="zoo_export")
        self.opset = opset
        self._n = 0

    def fresh(self, hint):
        self._n += 1
        return f"{hint}_{self._n}"

    def add(self, op, inputs, attrs=None, hint=None):
        out = self.fresh(hint or op.lower())
        self.graph.nodes.append(Node(
            op_type=op, name=out, inputs=list(inputs), outputs=[out],
            attrs=dict(attrs or {})))
        return out

    def init_tensor(self, name, arr):
        self.graph.initializers[name] = np.asarray(arr)
        return name


def _act_name(layer):
    act = getattr(layer, "activation", None)
    # NamedActivation carries .name; a custom callable has none and cannot
    # be exported (its python body is not representable as an ONNX op)
    name = act if act is None else getattr(act, "name", "<custom callable>")
    if name not in _ACT_OPS:
        raise ValueError(
            f"layer {layer.name}: activation {name!r} has no ONNX export")
    return name


def _emit_activation(ex, name, x, spatial=False):
    op = _ACT_OPS[name]
    if op is None:
        return x
    attrs = {}
    if op in ("Softmax", "LogSoftmax"):
        # framework softmax is over NHWC channels: that is axis 1 on a 4D
        # NCHW tensor, -1 elsewhere
        attrs = {"axis": 1 if spatial else -1}
    return ex.add(op, [x], attrs)


def _same_pads(spatial, kernel, strides, dilation=None):
    """Explicit ONNX pads replicating XLA 'SAME' (extra pad at the end):
    [begin_h, begin_w, end_h, end_w]."""
    begins, ends = [], []
    dilation = dilation or (1,) * len(kernel)
    for s, k, st, d in zip(spatial, kernel, strides, dilation):
        eff = (k - 1) * d + 1
        out = -(-s // st)
        total = max((out - 1) * st + eff - s, 0)
        begins.append(total // 2)
        ends.append(total - total // 2)
    return begins + ends


# Each emitter: (ex, layer, params, state, in_names, in_shapes, in_perms)
# -> (out_name, out_shape_nhwc_nobatch, flat_perm_or_None).
# in_shapes are semantic NHWC shapes without the batch dim; flat_perm maps
# ONNX (CHW-order) flat indices to this framework's (HWC-order) ones.


def _export_dense(ex, layer, params, state, ins, shapes, perms):
    if len(shapes[0]) == 3:
        # the graph tensor is NCHW but Dense applies to NHWC's last axis;
        # exporting would need a layout-breaking Transpose — require the
        # model to Flatten/GlobalAveragePool first (as real ones do)
        raise ValueError(
            f"layer {layer.name}: Dense directly on a spatial (H, W, C) "
            f"tensor has no ONNX export; add Flatten or a global pool "
            f"before it")
    kernel = _np(params["kernel"])  # (in, out)
    if perms[0] is not None:
        kernel = kernel[perms[0]]
    w = ex.init_tensor(ex.fresh(f"{layer.name}_w"), kernel)
    if len(shapes[0]) == 1:
        inputs = [ins[0], w]
        if layer.bias:
            inputs.append(ex.init_tensor(ex.fresh(f"{layer.name}_b"),
                                         _np(params["bias"])))
        out = ex.add("Gemm", inputs, hint=layer.name)
    else:
        # ND input: Gemm is rank-2-only per spec; MatMul broadcasts
        # leading dims (Dense applies to the last axis)
        out = ex.add("MatMul", [ins[0], w], hint=layer.name)
        if layer.bias:
            b = ex.init_tensor(ex.fresh(f"{layer.name}_b"),
                               _np(params["bias"]))
            out = ex.add("Add", [out, b])
    out = _emit_activation(ex, _act_name(layer), out)
    return out, tuple(shapes[0][:-1]) + (layer.output_dim,), None


def _export_conv2d(ex, layer, params, state, ins, shapes, perms):
    h, w_, _c = shapes[0]
    kernel = np.transpose(_np(params["kernel"]), (3, 2, 0, 1))
    wn = ex.init_tensor(ex.fresh(f"{layer.name}_w"), kernel)
    inputs = [ins[0], wn]
    if layer.bias:
        inputs.append(ex.init_tensor(ex.fresh(f"{layer.name}_b"),
                                     _np(params["bias"])))
    attrs = {"strides": list(layer.subsample),
             "dilations": list(layer.dilation)}
    if layer.border_mode == "same":
        attrs["pads"] = _same_pads((h, w_), layer.kernel_size,
                                   layer.subsample, layer.dilation)
    out = ex.add("Conv", inputs, attrs, hint=layer.name)
    out = _emit_activation(ex, _act_name(layer), out, spatial=True)
    out_shape = tuple(layer.compute_output_shape((None,) + shapes[0]))[1:]
    return out, out_shape, None


def _export_pool2d(ex, layer, params, state, ins, shapes, perms):
    op = "MaxPool" if layer.mode == "max" else "AveragePool"
    attrs = {"kernel_shape": list(layer.pool_size),
             "strides": list(layer.strides)}
    if layer.border_mode == "same":
        attrs["pads"] = _same_pads(shapes[0][:2], layer.pool_size,
                                   layer.strides)
        if op == "AveragePool":
            # our SAME average pool divides by the unpadded window count
            attrs["count_include_pad"] = 0
    out = ex.add(op, [ins[0]], attrs, hint=layer.name)
    out_shape = tuple(layer.compute_output_shape((None,) + shapes[0]))[1:]
    return out, out_shape, None


def _export_globalpool2d(ex, layer, params, state, ins, shapes, perms):
    op = "GlobalMaxPool" if layer.mode == "max" else "GlobalAveragePool"
    pooled = ex.add(op, [ins[0]], hint=layer.name)
    out = ex.add("Flatten", [pooled], {"axis": 1})
    return out, (shapes[0][-1],), None


def _export_bn(ex, layer, params, state, ins, shapes, perms):
    ch = shapes[0][-1]
    vecs = {
        "scale": _np(params.get("gamma", np.ones(ch, np.float32))),
        "bias": _np(params.get("beta", np.zeros(ch, np.float32))),
        "mean": _np(state["moving_mean"]),
        "var": _np(state["moving_var"]),
    }
    if perms[0] is not None:
        # BN after Flatten: the tensor is in ONNX CHW flat order, so the
        # per-feature vectors must be reordered to match; the element
        # order itself is unchanged, so the perm propagates
        vecs = {k: v[perms[0]] for k, v in vecs.items()}
    inputs = [ins[0]] + [
        ex.init_tensor(ex.fresh(f"{layer.name}_{k}"), v)
        for k, v in vecs.items()
    ]
    out = ex.add("BatchNormalization", inputs,
                 {"epsilon": layer.epsilon}, hint=layer.name)
    return out, shapes[0], perms[0]


def _export_flatten(ex, layer, params, state, ins, shapes, perms):
    out = ex.add("Flatten", [ins[0]], {"axis": 1}, hint=layer.name)
    shape = shapes[0]
    n = int(np.prod(shape))
    if len(shape) == 3:  # (H, W, C) -> ONNX flat order is CHW
        perm = np.arange(n).reshape(shape).transpose(2, 0, 1).ravel()
    else:  # already flat: keep whatever element order it arrived in
        perm = perms[0]
    return out, (n,), perm


def _export_dropout(ex, layer, params, state, ins, shapes, perms):
    # inference export: dropout is identity
    return ins[0], shapes[0], perms[0]


def _export_activation(ex, layer, params, state, ins, shapes, perms):
    out = _emit_activation(ex, _act_name(layer), ins[0],
                           spatial=len(shapes[0]) == 3)
    return out, shapes[0], perms[0]


_MERGE_OPS = {"sum": "Sum", "max": "Max", "ave": "Mean", "concat": "Concat"}


def _export_merge(ex, layer, params, state, ins, shapes, perms):
    op = _MERGE_OPS.get(layer.mode)
    if op is None:
        raise ValueError(
            f"layer {layer.name}: merge mode {layer.mode!r} has no ONNX "
            f"export (supported: {sorted(_MERGE_OPS)})")
    if op == "Concat":
        axis = layer.concat_axis
        ndim = len(shapes[0]) + 1  # + batch
        axis = axis % ndim
        if len(shapes[0]) == 3:  # NHWC axis -> NCHW axis
            axis = {0: 0, 1: 2, 2: 3, 3: 1}[axis]
        if any(p is not None for p in perms):
            if len(shapes[0]) != 1 or axis != 1:
                raise ValueError(
                    f"layer {layer.name}: concat of flattened (permuted) "
                    f"tensors only exports along the feature axis")
            # concatenated flat order: each segment keeps its own perm,
            # offset by the features preceding it
            parts, off = [], 0
            for p, s in zip(perms, shapes):
                n = int(np.prod(s))
                parts.append((np.arange(n) if p is None else p) + off)
                off += n
            out_perm = np.concatenate(parts)
        else:
            out_perm = None
        out = ex.add("Concat", ins, {"axis": axis}, hint=layer.name)
        new = list(shapes[0])
        cat_sem = (layer.concat_axis % ndim) - 1
        new[cat_sem] = sum(s[cat_sem] for s in shapes)
        return out, tuple(new), out_perm
    # elementwise modes: permuted inputs must share ONE element order
    out_perm = perms[0]
    for p in perms[1:]:
        same = (p is None and out_perm is None) or (
            p is not None and out_perm is not None
            and np.array_equal(p, out_perm))
        if not same:
            raise ValueError(
                f"layer {layer.name}: elementwise merge of tensors with "
                f"different flat element orders has no ONNX export")
    if op == "Mean":
        out = ex.add("Sum", ins, hint=layer.name)
        # Mean = Sum / n via a scalar initializer (Sum is opset-stable)
        scale = ex.init_tensor(ex.fresh(f"{layer.name}_n"),
                               np.asarray(float(len(ins)), np.float32))
        out = ex.add("Div", [out, scale])
        return out, shapes[0], out_perm
    out = ex.add(op, ins, hint=layer.name)
    return out, shapes[0], out_perm


def _emitters():
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

    return {
        L.Dense: _export_dense,
        L.Convolution2D: _export_conv2d,
        L.MaxPooling2D: _export_pool2d,
        L.AveragePooling2D: _export_pool2d,
        L.GlobalAveragePooling2D: _export_globalpool2d,
        L.GlobalMaxPooling2D: _export_globalpool2d,
        L.BatchNormalization: _export_bn,
        L.Flatten: _export_flatten,
        L.Dropout: _export_dropout,
        L.Activation: _export_activation,
        L.Merge: _export_merge,
    }


def _to_nchw(shape):
    """Semantic (no-batch) NHWC shape -> ONNX value-info shape w/ batch."""
    if len(shape) == 3:
        h, w, c = shape
        return (None, c, h, w)
    return (None,) + tuple(shape)


def export_onnx(net, path: str | None = None, opset: int = 13) -> bytes:
    """Serialize a trained KerasNet (Sequential or graph Model) or ZooModel
    to ONNX bytes; optionally also write them to ``path``.

    The exported graph takes NCHW inputs (transpose NHWC arrays with
    ``x.transpose(0, 3, 1, 2)`` before feeding an ONNX runtime) and runs in
    inference mode.  Raises ValueError naming the first layer whose type
    (or activation / merge mode) has no exporter.
    """
    if hasattr(net, "model") and not hasattr(net, "forward"):  # ZooModel
        net = net.model
    if net.params is None:
        net.build_params()
    params = net.params
    state = net.state if getattr(net, "state", None) else net.init_state()
    emitters = _emitters()
    ex = _Exporter(opset=opset)

    def emit(layer, ins, shapes, perms):
        fn = emitters.get(type(layer))
        if fn is None:
            raise ValueError(
                f"layer {layer.name} ({type(layer).__name__}) has no ONNX "
                f"exporter; supported: "
                f"{sorted(c.__name__ for c in emitters)}")
        return fn(ex, layer, params.get(layer.name, {}),
                  state.get(layer.name, {}), ins, shapes, perms)

    from analytics_zoo_tpu_torch.pipeline.api.keras.topology import (
        Model as GraphModel,
        Sequential,
    )

    if isinstance(net, Sequential):
        shape = net.get_input_shape()[1:]
        ex.graph.inputs.append(ValueInfo("input", _to_nchw(shape), FLOAT))
        name, perm = "input", None
        for layer in net.layers:
            name, shape, perm = emit(layer, [name], [shape], [perm])
        out_name, out_shape = name, shape  # `perm` holds the final order
    elif isinstance(net, GraphModel):
        info: dict[str, tuple] = {}  # variable name -> (onnx, shape, perm)
        for i, v in enumerate(net._graph.inputs):
            nm = f"input_{i}" if len(net._graph.inputs) > 1 else "input"
            ex.graph.inputs.append(
                ValueInfo(nm, _to_nchw(v.shape[1:]), FLOAT))
            info[v.name] = (nm, tuple(v.shape[1:]), None)
        for node in net._graph.nodes:
            if not node.inbound:  # Input node
                continue
            ins, shapes, perms = zip(*(info[v.name] for v in node.inbound))
            out = emit(node.layer, list(ins), list(shapes), list(perms))
            for v in node.outputs:
                info[v.name] = out
        outs = net._graph.outputs
        if len(outs) != 1:
            raise ValueError("multi-output export not supported")
        out_name, out_shape, perm = info[outs[0].name]
    else:
        raise TypeError(f"cannot export {type(net).__name__}")

    if perm is not None:
        # the model ends on a flattened tensor whose ONNX element order is
        # CHW: restore the framework's HWC order so consumers see the same
        # feature vector this framework produces
        inv = ex.init_tensor(ex.fresh("restore_order"),
                             np.argsort(perm).astype(np.int64))
        out_name = ex.add("Gather", [out_name, inv], {"axis": 1})

    ex.graph.outputs.append(
        ValueInfo(out_name, _to_nchw(out_shape), FLOAT))
    data = encode_model(Model(ir_version=8, opset=opset, graph=ex.graph))
    if path:
        with open(path, "wb") as f:
            f.write(data)
    return data
