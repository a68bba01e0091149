"""Caffe model loader: prototxt + caffemodel -> a layer the port runs.

Counterpart of ``analytics_zoo_tpu/models/caffe.py`` (the reference's
models/caffe/CaffeLoader.scala:63-671 with LayerConverter and
V1LayerConverter, which convert caffe NetParameter protos into a BigDL
graph with copied weights).

As the ONNX loader, the network is interpreted inside the step that runs
it (:class:`CaffeNet`), in caffe's NCHW layout, so ``F.conv2d`` and the
pools run on it with no layout copy.  The prototxt is parsed with a small
protobuf *text-format* parser and the caffemodel with the wire-format
reader of the port's :mod:`..pipeline.api.onnx.proto`: no caffe or
protobuf runtime.  Field numbers follow the public caffe.proto (frozen by
protobuf compatibility rules).  Each layer's blobs are trainable
parameters named ``"<layer>/blob<i>"``, the JAX package's names.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer
from analytics_zoo_tpu_torch.pipeline.api.onnx.mapper import (
    channel_window_sum,
)
from analytics_zoo_tpu_torch.pipeline.api.onnx.proto import (
    _iter_fields,
    _read_varint,
)


# ---------------------------------------------------------------------------
# prototxt (protobuf text format)
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""[A-Za-z_][A-Za-z0-9_]*|"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*'"""
    r"""|[-+]?[0-9.][0-9.eE+-]*|[{}:]""",
)


def _tokenize(text):
    # strip comments
    text = re.sub(r"#[^\n]*", "", text)
    return _TOKEN.findall(text)


def _parse_value(tok):
    if tok and tok[0] in "\"'":
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok  # enum identifier / bool


def _parse_message(tokens, pos):
    """Parse `field: value` / `field { ... }` pairs until '}' or EOF.
    Repeated fields accumulate into lists."""
    msg: dict = {}
    n = len(tokens)
    while pos < n and tokens[pos] != "}":
        key = tokens[pos]
        pos += 1
        if pos < n and tokens[pos] == ":":
            pos += 1
            val = _parse_value(tokens[pos])
            pos += 1
        elif pos < n and tokens[pos] == "{":
            val, pos = _parse_message(tokens, pos + 1)
            assert tokens[pos] == "}", "unbalanced braces in prototxt"
            pos += 1
        else:
            raise ValueError(f"prototxt parse error near {key!r}")
        if key in msg:
            if not isinstance(msg[key], list):
                msg[key] = [msg[key]]
            msg[key].append(val)
        else:
            msg[key] = val
    return msg, pos


def parse_prototxt(text: str) -> dict:
    tokens = _tokenize(text)
    msg, pos = _parse_message(tokens, 0)
    return msg


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# ---------------------------------------------------------------------------
# V1 (upgrade_proto-era) layer normalization — reference V1LayerConverter
# ---------------------------------------------------------------------------

# V1LayerParameter.LayerType enum (public caffe.proto, frozen): both the
# text-format enum identifiers and the binary enum ints map to the modern
# string type names the converters use (reference V1LayerConverter.scala:39
# implements the same legacy set; loss/data types map to the names the
# train-only-layer filter already drops).
_V1_LAYER_TYPES = {
    "NONE": (0, None),
    "ACCURACY": (1, "Accuracy"),
    "BNLL": (2, "BNLL"),
    "CONCAT": (3, "Concat"),
    "CONVOLUTION": (4, "Convolution"),
    "DATA": (5, "Data"),
    "DROPOUT": (6, "Dropout"),
    "EUCLIDEAN_LOSS": (7, "EuclideanLoss"),
    "FLATTEN": (8, "Flatten"),
    "HDF5_DATA": (9, "HDF5Data"),
    "HDF5_OUTPUT": (10, "HDF5Output"),
    "IM2COL": (11, "Im2col"),
    "IMAGE_DATA": (12, "ImageData"),
    "INFOGAIN_LOSS": (13, "InfogainLoss"),
    "INNER_PRODUCT": (14, "InnerProduct"),
    "LRN": (15, "LRN"),
    "MULTINOMIAL_LOGISTIC_LOSS": (16, "MultinomialLogisticLoss"),
    "POOLING": (17, "Pooling"),
    "RELU": (18, "ReLU"),
    "SIGMOID": (19, "Sigmoid"),
    "SOFTMAX": (20, "Softmax"),
    "SOFTMAX_LOSS": (21, "SoftmaxWithLoss"),
    "SPLIT": (22, "Split"),
    "TANH": (23, "TanH"),
    "WINDOW_DATA": (24, "WindowData"),
    "ELTWISE": (25, "Eltwise"),
    "POWER": (26, "Power"),
    "SIGMOID_CROSS_ENTROPY_LOSS": (27, "SigmoidCrossEntropyLoss"),
    "HINGE_LOSS": (28, "HingeLoss"),
    "MEMORY_DATA": (29, "MemoryData"),
    "ARGMAX": (30, "ArgMax"),
    "THRESHOLD": (31, "Threshold"),
    "DUMMY_DATA": (32, "DummyData"),
    "SLICE": (33, "Slice"),
    "MVN": (34, "MVN"),
    "ABSVAL": (35, "AbsVal"),
    "SILENCE": (36, "Silence"),
    "CONTRASTIVE_LOSS": (37, "ContrastiveLoss"),
    "EXP": (38, "Exp"),
    "DECONVOLUTION": (39, "Deconvolution"),
}
_V1_BY_NAME = {k: v[1] for k, v in _V1_LAYER_TYPES.items()}
_V1_BY_INT = {v[0]: v[1] for v in _V1_LAYER_TYPES.values()}


def normalize_v1_layer(ly: dict) -> dict:
    """Translate an upgrade_proto-era ``layers { type: CONVOLUTION }``
    entry (enum type — text identifier or binary int) into the modern
    string-typed form the converters consume.  Modern entries pass through
    untouched.  Reference: CaffeLoader.scala:63-75 selecting
    V1LayerConverter for V1 nets."""
    t = ly.get("type")
    new_t = None
    if isinstance(t, int):
        new_t = _V1_BY_INT.get(t)
        if new_t is None:
            raise NotImplementedError(f"unknown V1 layer type enum {t}")
    elif isinstance(t, str) and t in _V1_BY_NAME:
        new_t = _V1_BY_NAME[t]
    if new_t is None:
        return ly
    out = dict(ly)
    out["type"] = new_t
    return out


# ---------------------------------------------------------------------------
# caffemodel (binary NetParameter) — only blobs are needed; topology comes
# from the prototxt
# ---------------------------------------------------------------------------

def _decode_blob(buf) -> np.ndarray:
    import struct

    dims, data, legacy = [], [], {}
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 7:  # shape: BlobShape{ dim=1 }
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed
                        pos = 0
                        while pos < len(v2):
                            d, pos = _read_varint(v2, pos)
                            dims.append(d)
                    else:
                        dims.append(v2)
        elif fnum == 5:  # data: repeated float (packed)
            if wtype == 2:
                data.append(np.frombuffer(val, dtype=np.float32))
            else:
                data.append(np.asarray(
                    [struct.unpack("<f", struct.pack("<i", val))[0]],
                    dtype=np.float32,
                ))
        elif fnum in (1, 2, 3, 4):  # legacy num/channels/height/width
            legacy[fnum] = val
    arr = (np.concatenate(data) if data
           else np.zeros(0, dtype=np.float32))
    legacy_format = not dims and bool(legacy)
    if legacy_format:
        dims = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if dims and int(np.prod(dims)) == arr.size:
        arr = arr.reshape(dims)
    # squeeze ONLY the legacy num/channels/height/width (1,1,H,W) padding
    # on FC/bias blobs — a modern 4D blob with num_output=1 (shape
    # (1,C,kh,kw) via the `shape` field) must stay 4D
    if legacy_format and arr.ndim == 4 and arr.shape[0] == 1 \
            and arr.shape[1] == 1:
        arr = arr[0, 0]
    return arr


def parse_caffemodel(data: bytes) -> dict:
    """name -> [blob arrays] for every layer carrying weights.  Handles both
    `layer` (field 100, LayerParameter: name=1, blobs=7) and legacy
    `layers` (field 2, V1LayerParameter: name=4, blobs=6) messages
    (CaffeLoader supports both via LayerConverter/V1LayerConverter)."""
    out: dict = {}
    for fnum, _, val in _iter_fields(memoryview(data)):
        if fnum not in (100, 2):
            continue
        name_field = 1 if fnum == 100 else 4
        blob_field = 7 if fnum == 100 else 6
        name, blobs = "", []
        for f2, _, v2 in _iter_fields(val):
            if f2 == name_field and isinstance(v2, bytes):
                name = v2.decode("utf-8", "replace")
            elif f2 == blob_field:
                blobs.append(_decode_blob(v2))
        if name and blobs:
            out[name] = blobs
    return out




# ---------------------------------------------------------------------------
# layer execution
# ---------------------------------------------------------------------------

def _ntup(param, base, h_key, w_key, default):
    """caffe's kernel/stride/pad trio: either repeated `base` or explicit
    `_h`/`_w` values."""
    h = param.get(h_key)
    w = param.get(w_key)
    if h is not None or w is not None:
        return (int(h or default), int(w or default))
    v = _as_list(param.get(base))
    if not v:
        return (default, default)
    if len(v) == 1:
        return (int(v[0]), int(v[0]))
    return (int(v[0]), int(v[1]))


def _pad_hw(x, pads, value=0.0):
    """``x`` (N, C, H, W) padded by ``[(top, bottom), (left, right)]``."""
    (t, b), (left, r) = pads
    if not (t or b or left or r):
        return x
    return F.pad(x, [left, r, t, b], value=value)


def _window_sum(x, k, s):
    """Sums over (kh, kw) windows at stride ``s`` (``x`` already padded)."""
    return F.avg_pool2d(x, k, s, divisor_override=1)


class CaffeNet(Layer):
    """A caffe network as a layer (reference CaffeLoader.scala).

    Supported layer types mirror the reference's converter set:
    Input/Data, Convolution (grouped too), InnerProduct, Pooling
    (MAX/AVE, caffe ceil rounding), ReLU, PReLU, Sigmoid, TanH, ELU,
    AbsVal, Power, Exp, Log, LRN (across and within channels), BatchNorm,
    Scale, Bias, Concat, Eltwise, Softmax, Dropout (identity at
    inference), Flatten, Reshape, Split.  Weights loaded from the
    caffemodel become trainable params.
    """

    def __init__(self, net_def: dict, blobs: dict | None = None,
                 trainable=True, name=None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.net_def = net_def
        self.trainable = trainable
        raw_layers = _as_list(net_def.get("layer")) \
            or _as_list(net_def.get("layers"))
        # V1 (upgrade_proto-era) nets carry enum layer types: normalize
        # them to the modern string names first (V1LayerConverter's role)
        raw_layers = [normalize_v1_layer(ly) for ly in raw_layers]
        # drop train-only layers (phase TRAIN, loss/accuracy heads)
        self.layers = []
        for ly in raw_layers:
            t = str(ly.get("type", ""))
            include = ly.get("include", {})
            phase = include.get("phase") if isinstance(include, dict) \
                else None
            if phase == "TRAIN" or t in (
                "SoftmaxWithLoss", "Accuracy", "EuclideanLoss",
                "SigmoidCrossEntropyLoss", "HingeLoss", "Data",
                "ImageData", "HDF5Data",
                # V1-era train/data heads (V1LayerConverter drop set)
                "WindowData", "MemoryData", "DummyData", "HDF5Output",
                "MultinomialLogisticLoss", "InfogainLoss",
                "ContrastiveLoss", "Silence",
            ):
                continue
            self.layers.append(ly)
        self._blobs = blobs or {}
        self._handler_check()

        # network inputs: explicit `input:` fields or Input layers
        self.input_names = [str(v) for v in _as_list(net_def.get("input"))]
        self._input_shapes = {}
        shapes = _as_list(net_def.get("input_shape"))
        for iname, shp in zip(self.input_names, shapes):
            self._input_shapes[iname] = tuple(
                int(d) for d in _as_list(shp.get("dim"))
            )
        for ly in self.layers:
            if str(ly.get("type")) == "Input":
                top = str(ly["top"])
                self.input_names.append(top)
                shp = ly.get("input_param", {}).get("shape", {})
                if shp:
                    self._input_shapes[top] = tuple(
                        int(d) for d in _as_list(shp.get("dim"))
                    )
        if not self.input_names:
            raise ValueError("caffe net has no inputs (input: or Input)")
        if len(self.input_names) == 1:
            shp = self._input_shapes.get(self.input_names[0])
            if shp and self._input_shape is None:
                self._input_shape = tuple(shp[1:])

        # caffe has no explicit outputs; the conventional outputs are the
        # tops never consumed as bottoms (fixed by net_def: precomputed)
        consumed, produced = set(), []
        for ly in self.layers:
            consumed.update(str(b) for b in _as_list(ly.get("bottom")))
            for top in _as_list(ly.get("top")):
                produced.append(str(top))
        self.output_names = [t for t in dict.fromkeys(produced)
                             if t not in consumed] \
            or produced[-1:]

    _HANDLED = {
        "Input", "Convolution", "InnerProduct", "Pooling", "ReLU",
        "PReLU", "Sigmoid", "TanH", "ELU", "AbsVal", "Power", "Exp",
        "Log", "LRN", "BatchNorm", "Scale", "Bias", "Concat", "Eltwise",
        "Softmax", "Dropout", "Flatten", "Reshape", "Split",
    }

    def _handler_check(self):
        missing = sorted({
            str(ly.get("type")) for ly in self.layers
            if str(ly.get("type")) not in self._HANDLED
        })
        if missing:
            raise NotImplementedError(
                f"caffe layer types without converters: {missing} "
                f"(supported: {sorted(self._HANDLED)})"
            )

    # -- weights -----------------------------------------------------------
    def build(self, input_shape):
        from analytics_zoo_tpu_torch.pipeline.api.onnx import _Fixed

        for ly in self.layers:
            lname = str(ly.get("name", ""))
            for bi, arr in enumerate(self._blobs.get(lname, [])):
                self.add_weight(f"{lname}/blob{bi}", arr.shape,
                                _Fixed(arr), trainable=self.trainable)

    def _w(self, weights, ly, idx, default=None, required=False):
        lname = str(ly.get("name", ""))
        key = f"{lname}/blob{idx}"
        if key in weights:
            return weights[key]
        if required:
            raise ValueError(
                f"caffe layer {lname!r} ({ly.get('type')}) has no blob "
                f"{idx}: pass model_path=<.caffemodel> to load_caffe (the "
                "prototxt alone carries no weights)")
        return default

    # -- forward -----------------------------------------------------------
    def call(self, params, inputs, state=None, training=False, rng=None):
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        env = dict(zip(self.input_names, xs))
        weights = params if self.trainable else (state or {})

        for ly in self.layers:
            t = str(ly.get("type"))
            if t == "Input":
                continue
            bottoms = [env[str(b)] for b in _as_list(ly.get("bottom"))]
            tops = [str(v) for v in _as_list(ly.get("top"))]
            out = self._apply_layer(t, ly, bottoms, weights)
            if t == "Split":
                for top in tops:
                    env[top] = out
            else:
                env[tops[0]] = out

        result = [env[o] for o in self.output_names if o in env]
        result = result if len(result) > 1 else result[0]
        if self.stateful:
            return result, state
        return result

    def _apply_layer(self, t, ly, bottoms, weights):
        x = bottoms[0] if bottoms else None
        if t == "Convolution":
            p = ly.get("convolution_param", {})
            s = _ntup(p, "stride", "stride_h", "stride_w", 1)
            pad = _ntup(p, "pad", "pad_h", "pad_w", 0)
            dil = int(_as_list(p.get("dilation"))[0]) \
                if p.get("dilation") is not None else 1
            group = int(p.get("group", 1))
            w = self._w(weights, ly, 0, required=True)
            b = self._w(weights, ly, 1)
            if b is not None and p.get("bias_term", True) is False:
                b = None
            if b is not None:  # a legacy blob is (1, C)
                b = b.reshape(-1)
            return F.conv2d(x, w, b, stride=s, padding=pad,
                            dilation=(dil, dil), groups=group)
        if t == "InnerProduct":
            p = ly.get("inner_product_param", {})
            w = self._w(weights, ly, 0, required=True)  # (out, in)
            y = x.reshape(x.shape[0], -1) @ w.T
            b = self._w(weights, ly, 1)
            if b is not None and p.get("bias_term", True) is not False:
                y = y + b
            return y
        if t == "Pooling":
            return self._pool(ly, x)
        if t == "ReLU":
            slope = ly.get("relu_param", {}).get("negative_slope", 0.0)
            if slope:
                return torch.where(x >= 0, x, slope * x)
            return torch.relu(x)
        if t == "PReLU":
            a = self._w(weights, ly, 0, required=True)
            return torch.where(x >= 0, x, a.reshape(1, -1, 1, 1) * x)
        if t == "Sigmoid":
            return torch.sigmoid(x)
        if t == "TanH":
            return torch.tanh(x)
        if t == "ELU":
            alpha = ly.get("elu_param", {}).get("alpha", 1.0)
            return torch.where(x >= 0, x, alpha * torch.expm1(x))
        if t == "AbsVal":
            return torch.abs(x)
        if t == "Power":
            p = ly.get("power_param", {})
            return torch.pow(
                p.get("shift", 0.0) + p.get("scale", 1.0) * x,
                p.get("power", 1.0),
            )
        if t == "Exp":
            p = ly.get("exp_param", {})
            base = p.get("base", -1.0)
            y = p.get("scale", 1.0) * x + p.get("shift", 0.0)
            return torch.exp(y) if base == -1.0 else torch.pow(base, y)
        if t == "Log":
            p = ly.get("log_param", {})
            base = p.get("base", -1.0)
            y = p.get("scale", 1.0) * x + p.get("shift", 0.0)
            out = torch.log(y)
            return out if base == -1.0 else out / np.log(base)
        if t == "LRN":
            p = ly.get("lrn_param", {})
            size = int(p.get("local_size", 5))
            alpha = p.get("alpha", 1.0)
            beta = p.get("beta", 0.75)
            kk = p.get("k", 1.0)
            lo = (size - 1) // 2
            sq = torch.square(x)
            region = p.get("norm_region", "ACROSS_CHANNELS")
            if region in ("WITHIN_CHANNEL", 1):
                # caffe WITHIN_CHANNEL: spatial size x size window per
                # channel, the denominator normalized by the window AREA
                win = _window_sum(
                    _pad_hw(sq, [(lo, size - 1 - lo)] * 2), (size, size), 1)
                return x / torch.pow(kk + alpha / (size * size) * win, beta)
            win = channel_window_sum(sq, size)
            return x / torch.pow(kk + alpha / size * win, beta)
        if t == "BatchNorm":
            p = ly.get("batch_norm_param", {})
            eps = p.get("eps", 1e-5)
            mean = self._w(weights, ly, 0, required=True)
            var = self._w(weights, ly, 1, required=True)
            factor = self._w(weights, ly, 2)
            if factor is not None:
                f = factor.reshape(())
                scale = torch.where(f == 0, torch.zeros_like(f), 1.0 / f)
                mean = mean * scale
                var = var * scale
            shape = (1, -1, 1, 1)
            return (x - mean.reshape(shape)) \
                * torch.rsqrt(var.reshape(shape) + eps)
        if t == "Scale":
            p = ly.get("scale_param", {})
            gamma = self._w(weights, ly, 0, required=True)
            # per-channel affine over axis 1, broadcast over trailing dims
            shape = (1, -1) + (1,) * (x.dim() - 2)
            y = x * gamma.reshape(shape)
            beta = self._w(weights, ly, 1)
            if beta is not None and p.get("bias_term", False) \
                    is not False:
                y = y + beta.reshape(shape)
            return y
        if t == "Bias":
            b = self._w(weights, ly, 0)
            return x + (b.reshape(1, -1, 1, 1) if x.dim() == 4 else b)
        if t == "Concat":
            p = ly.get("concat_param", {})
            axis = int(p.get("axis", p.get("concat_dim", 1)))
            return torch.cat(bottoms, dim=axis)
        if t == "Eltwise":
            p = ly.get("eltwise_param", {})
            op = p.get("operation", "SUM")
            if op in ("PROD", 0):
                out = bottoms[0]
                for b in bottoms[1:]:
                    out = out * b
                return out
            if op in ("MAX", 2):
                out = bottoms[0]
                for b in bottoms[1:]:
                    out = torch.maximum(out, b)
                return out
            coeff = [float(c) for c in _as_list(p.get("coeff"))] \
                or [1.0] * len(bottoms)
            out = coeff[0] * bottoms[0]
            for c, b in zip(coeff[1:], bottoms[1:]):
                out = out + c * b
            return out
        if t == "Softmax":
            axis = int(ly.get("softmax_param", {}).get("axis", 1))
            return torch.softmax(x, dim=axis)
        if t == "Dropout":
            return x  # inference: identity (the reference drops these too)
        if t == "Flatten":
            return x.reshape(x.shape[0], -1)
        if t == "Reshape":
            shp = ly.get("reshape_param", {}).get("shape", {})
            dims = [int(d) for d in _as_list(shp.get("dim"))]
            out = [x.shape[i] if d == 0 else d
                   for i, d in enumerate(dims)]
            return torch.reshape(x, out)
        if t == "Split":
            return x
        raise NotImplementedError(t)  # pragma: no cover

    def _pool(self, ly, x):
        p = ly.get("pooling_param", {})
        if p.get("global_pooling") in (True, "true", 1):
            op = p.get("pool", "MAX")
            if op in ("MAX", 0):
                return torch.amax(x, dim=(2, 3), keepdim=True)
            return torch.mean(x, dim=(2, 3), keepdim=True)
        k = _ntup(p, "kernel_size", "kernel_h", "kernel_w", 1)
        s = _ntup(p, "stride", "stride_h", "stride_w", 1)
        pad = _ntup(p, "pad", "pad_h", "pad_w", 0)
        # caffe rounds pooling output UP, then drops a window that would
        # start entirely inside the padding
        extra = []
        for size, ki, st, pd in zip(x.shape[2:], k, s, pad):
            n = -(-(size + 2 * pd - ki) // st) + 1
            if pd and (n - 1) * st >= size + pd:
                n -= 1
            extra.append(max(0, (n - 1) * st + ki - (size + 2 * pd)))
        if p.get("pool", "MAX") in ("STOCHASTIC", 2):
            # stochastic pooling has no deterministic inference
            # equivalent; running it as AVE would be silently wrong
            raise NotImplementedError(
                f"caffe STOCHASTIC pooling (layer "
                f"{ly.get('name')!r}) is not supported")
        if p.get("pool", "MAX") in ("MAX", 0):
            # -inf padding: padded cells never win the max (caffe clips
            # MAX windows to the real image)
            full = [(pd, pd + ex) for pd, ex in zip(pad, extra)]
            return F.max_pool2d(_pad_hw(x, full, -float("inf")), k, s)
        # AVE: caffe sums real cells but divides by the window extent
        # clipped to the padded canvas [-pad, size+pad): pad cells count in
        # the denominator, the ceil extension does not
        xp = _pad_hw(x, [(pd, pd) for pd in pad])
        ext = [(0, ex) for ex in extra]
        y = _window_sum(_pad_hw(xp, ext), k, s)
        cnt = _window_sum(_pad_hw(torch.ones_like(xp), ext), k, s)
        return y / cnt

    @property
    def stateful(self):
        return not self.trainable

    def init_state(self):
        if self.trainable:
            return super().init_state()
        state = {}
        for ly in self.layers:
            lname = str(ly.get("name", ""))
            for bi, arr in enumerate(self._blobs.get(lname, [])):
                state[f"{lname}/blob{bi}"] = torch.from_numpy(
                    np.array(arr, np.float32))
        return state


def load_caffe(def_path, model_path=None, trainable=True) -> CaffeNet:
    """Reference ``Net.loadCaffe(defPath, modelPath)`` ->
    CaffeLoader.loadCaffe (CaffeLoader.scala:63)."""
    with open(def_path, "r", encoding="utf-8") as f:
        net_def = parse_prototxt(f.read())
    blobs = {}
    if model_path is not None:
        with open(model_path, "rb") as f:
            blobs = parse_caffemodel(f.read())
    return CaffeNet(net_def, blobs, trainable=trainable)
