"""KerasNet / Sequential / Model — the user-facing model API.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/topology.py``:
parameter materialization, the pure forward, weights in and out
(``save_weights``/``load_weights``, ``load_checkpoint`` from a training
checkpoint), whole-model save/load, training: ``compile``/``fit``/
``evaluate`` (with ``set_checkpoint`` and ``set_tensorboard``)
through :class:`~analytics_zoo_tpu_torch.pipeline.estimator.Estimator`,
gradient clipping and freezing layers, and ``predict``,
``predict_classes`` and ``summary``.  ``predict`` runs each batch through
one planned forward (``compile_step(..., label="predict_step")``, captured
into a CUDA graph per batch shape on the card), with the parameters and
state passed by reference and the casts to the context's compute dtype
inside the step, as in the reference; it is cached on the compute dtype
and dropped wherever the parameters are replaced.  Pooled serving goes
through :class:`analytics_zoo_tpu_torch.pipeline.inference.InferenceModel`.

A net's parameters are a tree of tensors on one device (``net.device``),
initialised on the CPU from a seeded ``torch.Generator`` and then moved,
so a seed gives the same weights on every device.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.engine import (
    cast_floats,
    get_zoo_context,
    resolve_device,
)
from analytics_zoo_tpu_torch.common.safe_pickle import safe_load, safe_loads
from analytics_zoo_tpu_torch.common.utils import (
    tree_leaves,
    tree_map,
    tree_structure,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    GraphFunction,
    InputLayer,
    Layer,
    Variable,
    _ContainerBase,
    canonicalize_names,
    fold_in,
    make_generator,
)


def _to_numpy(t):
    return t.detach().cpu().numpy()


def _normalize_names(names) -> tuple:
    """Accept both freeze("a", "b") and freeze(["a", "b"])."""
    if len(names) == 1 and isinstance(names[0], (list, tuple)):
        return tuple(names[0])
    return tuple(names)


def _to_device(tree, device):
    return tree_map(
        lambda a: (a if torch.is_tensor(a) else torch.from_numpy(
            np.array(a))).to(device), tree)


class KerasNet(_ContainerBase):
    """Base for containers."""

    def __init__(self, name=None):
        super().__init__(name=name)
        self.params: dict | None = None
        self.state: dict | None = None
        self.device: torch.device | None = None
        self._compiled = None     # set by compile()
        self._grad_clip = None    # ("l2norm", v) | ("const", lo, hi)
        self._estimator = None
        self._frozen: set = set()  # layer names excluded from training
        self._predict_fn = None   # (compute dtype, planned forward)
        self._tensorboard = None  # (log_dir, app_name)
        self._checkpoint = None   # (path, over_write)

    # ------------------------------------------------------------------
    # parameter materialization
    # ------------------------------------------------------------------
    def build_params(self, rng: torch.Generator | None = None,
                     force: bool = False, device=None, given=None):
        """Materialize params/state trees (idempotent) on ``device``
        (default: the context's device, ``cuda`` unless set otherwise).
        ``given``: a (params, state) pair of trees by layer name, on
        ``device`` already; the layers they hold take those tensors as
        they are and draw nothing, the others draw as without them."""
        if self.params is not None and not force:
            return self.params, self.state
        if force:
            self.params = self.state = None
        ctx = get_zoo_context() if rng is None or device is None else None
        rng = rng if rng is not None else make_generator(ctx.seed)
        self.device = resolve_device(device) if device is not None \
            else ctx.device
        given_params, given_state = given or (None, None)
        self.params = _to_device(self.init_params(rng, given_params),
                                 self.device)
        self.state = _to_device(self.init_state(given_state), self.device)
        self._predict_fn = None  # its captures read the old buffers
        return self.params, self.state

    def forward(self, params, inputs, state=None, training=False, rng=None):
        """Pure forward; containers implement via call()."""
        return self.call(params, inputs, state=state, training=training,
                         rng=rng)

    # ------------------------------------------------------------------
    # compile / fit / evaluate
    # ------------------------------------------------------------------
    def compile(self, optimizer, loss, metrics=None):
        """Configure training: an optimizer, a loss and metrics, each an
        instance or a name."""
        from analytics_zoo_tpu_torch.pipeline.api.keras.metrics import (
            get_metric,
        )
        from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
            get_loss,
        )
        from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
            get_optimizer,
        )

        self._compiled = dict(
            optimizer=get_optimizer(optimizer),
            loss=get_loss(loss),
            metrics=[get_metric(m) for m in (metrics or [])],
        )
        self._estimator = None
        return self

    def set_tensorboard(self, log_dir, app_name):
        """Write the fit's summaries under ``log_dir/app_name/{train,
        validation}`` (reference Topology.scala:183-202)."""
        self._tensorboard = (log_dir, app_name)
        self._estimator = None

    def set_checkpoint(self, path, over_write=True):
        """Checkpoint the fit into ``path`` and resume from it (reference
        Topology.scala:245-255)."""
        self._checkpoint = (path, over_write)
        self._estimator = None

    def set_gradient_clipping_by_l2_norm(self, clip_norm):
        self._grad_clip = ("l2norm", float(clip_norm))
        self._estimator = None

    def set_constant_gradient_clipping(self, min_value, max_value):
        self._grad_clip = ("const", float(min_value), float(max_value))
        self._estimator = None

    def clear_gradient_clipping(self):
        self._grad_clip = None
        self._estimator = None

    def _make_estimator(self):
        from analytics_zoo_tpu_torch.pipeline.estimator import Estimator

        if getattr(self, "_compiled", None) is None:
            raise RuntimeError(
                "model not compiled; call compile(optimizer, loss) first")
        return Estimator(self, optimizer=self._compiled["optimizer"],
                         loss=self._compiled["loss"],
                         metrics=self._compiled["metrics"],
                         grad_clip=getattr(self, "_grad_clip", None),
                         tensorboard=getattr(self, "_tensorboard", None),
                         checkpoint=getattr(self, "_checkpoint", None))

    def fit(self, x, y=None, batch_size=32, nb_epoch=10,
            validation_data=None, distributed=True, sample_weight=None,
            autotune=None, plan=None):
        """Train ``nb_epoch`` more epochs on (x, y); returns the model (the
        estimator's ``history`` and ``loss_log`` hold the losses).  ``plan``
        (a ``ShardingPlan`` or a name, default ``dp``) is the plan every
        step runs under: its ``kernel_rules`` pick each scope's kernel.
        ``autotune=True`` (or ``ZOO_AUTOTUNE=1``) tunes the prefetch
        workers, depth, read-ahead and the steps a dispatch online, with
        the same loss trajectory bit for bit (``Estimator.train``)."""
        from analytics_zoo_tpu_torch.feature.dataset import FeatureSet

        train_set = FeatureSet.of(x, y, sample_weight=sample_weight)
        val_set = (FeatureSet.of(*validation_data)
                   if validation_data is not None else None)
        if getattr(self, "_estimator", None) is None:
            self._estimator = self._make_estimator()
        self._estimator.train(train_set, batch_size=batch_size,
                              nb_epoch=nb_epoch, validation_set=val_set,
                              autotune=autotune, plan=plan)
        self._predict_fn = None  # the trained parameters are new buffers
        return self

    def evaluate(self, x, y=None, batch_size=32):
        """A dict of metric name -> value over (x, y), loss included."""
        from analytics_zoo_tpu_torch.feature.dataset import FeatureSet

        if getattr(self, "_estimator", None) is None:
            self._estimator = self._make_estimator()
        return self._estimator.evaluate(FeatureSet.of(x, y),
                                        batch_size=batch_size)

    def _predict_each(self, x, take, batch_size=32):
        """:meth:`predict`'s batches, each output given to ``take`` on the
        model's device while the replay's output buffers hold it (the next
        replay overwrites them: ``take`` returns a copy of what it keeps);
        returns the list of what ``take`` returned, batch by batch in order
        (the last batch padded), and the number of samples."""
        from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
        from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
            _tensor,
        )

        self.build_params()
        ctx = get_zoo_context()
        fs = FeatureSet.of(x)
        n = fs.num_samples
        cached = getattr(self, "_predict_fn", None)
        if cached is None or cached[0] is not ctx.compute_dtype:
            from analytics_zoo_tpu_torch.parallel.plan import (
                CaptureGroup,
                compile_step,
                step_options,
            )

            dtype = ctx.compute_dtype

            def _fwd(p, s, xb):
                # the state stays as stored (f32 running statistics)
                with torch.no_grad():
                    out, _ = self.forward(cast_floats(p, dtype),
                                          cast_floats(xb, dtype), state=s,
                                          training=False)
                return cast_floats(out, torch.float32)

            cached = (dtype, compile_step(
                _fwd, ref_argnums=(0, 1), group=CaptureGroup(),
                **step_options(self, "predict_step")))
            self._predict_fn = cached
        fwd = cached[1]
        outs = []
        for batch in fs.batches(batch_size, shuffle=False, drop_last=False,
                                pad_to_batch=1):
            xb = batch["x"]
            xb = ([_tensor(a, self.device) for a in xb]
                  if isinstance(xb, list) else _tensor(xb, self.device))
            with fwd.lock:  # the next replay overwrites the outputs
                out = fwd(self.params, self.state, xb)
                outs.append(take(out))
        return outs, n

    def predict(self, x, batch_size=32, distributed=True):
        """The outputs over ``x`` (an array or a list of arrays), batch by
        batch in order; a multi-output model gives a list.  Each batch runs
        through the planned forward under the ``predict_step`` label, in
        the context's compute dtype, with f32 outputs."""
        outs, n = self._predict_each(
            x, lambda out: ([_to_numpy(o) for o in out]
                            if isinstance(out, (list, tuple))
                            else _to_numpy(out)), batch_size)
        if isinstance(outs[0], list):  # multi-output graph
            return [np.concatenate([o[i] for o in outs], axis=0)[:n]
                    for i in range(len(outs[0]))]
        return np.concatenate(outs, axis=0)[:n]

    def predict_classes(self, x, batch_size=32, zero_based_label=True):
        """The argmax over the last axis of :meth:`predict`'s output (plus
        one unless ``zero_based_label``)."""
        probs = self.predict(x, batch_size)
        cls = np.argmax(probs, axis=-1)
        return cls if zero_based_label else cls + 1

    # ------------------------------------------------------------------
    # transfer learning: frozen layers get their gradients and optimizer
    # updates masked to zero in the train step
    # ------------------------------------------------------------------
    def freeze(self, *names) -> "KerasNet":
        """Mark the named layers (all layers if none given) non-trainable;
        takes effect on the next fit()."""
        names = _normalize_names(names)
        if not names:
            names = tuple(ly.name for ly in self.layers)
        self._validate_layer_names(names)
        self._frozen.update(names)
        self._estimator = None
        return self

    def unfreeze(self, *names) -> "KerasNet":
        names = _normalize_names(names)
        if not names:
            self._frozen.clear()
        else:
            self._validate_layer_names(names)
            self._frozen.difference_update(names)
        self._estimator = None
        return self

    @property
    def frozen_layers(self) -> list[str]:
        return sorted(getattr(self, "_frozen", ()))

    def _validate_layer_names(self, names):
        avail = {ly.name for ly in self.layers}
        unknown = [n for n in names if n not in avail]
        if unknown:
            raise ValueError(
                f"unknown layer(s) {unknown}; available: {sorted(avail)}")

    # ------------------------------------------------------------------
    # weights / persistence
    # ------------------------------------------------------------------
    def get_weights(self):
        self.build_params()
        return tree_map(_to_numpy, self.params)

    def set_weights(self, weights):
        self.build_params()
        if tree_structure(weights) != tree_structure(self.params):
            raise ValueError("weights do not match the model's parameter "
                             "tree")
        self.params = _to_device(weights, self.device)
        self._predict_fn = None  # its captures read the old buffers

    def save_weights(self, path, over_write=True):
        """The parameters and the model state as one ``.npz``: the leaves
        in order, and the trees' structure (dicts and lists, leaves
        numbered) as a pickle in ``treedef``."""
        self.build_params()
        if os.path.exists(path) and not over_write:
            raise IOError(f"{path} exists and over_write=False")
        flat = tree_leaves((self.params, self.state))
        numbered = iter(range(len(flat)))
        skeleton = tree_map(lambda _: next(numbered),
                            (self.params, self.state))
        np.savez(path, treedef=np.frombuffer(pickle.dumps(skeleton),
                                             dtype=np.uint8),
                 **{str(i): _to_numpy(a) for i, a in enumerate(flat)})

    def load_weights(self, path):
        """Parameters and state from :meth:`save_weights`'s file, onto the
        model's device (the context's when it has none)."""
        data = np.load(path if path.endswith(".npz") else path + ".npz",
                       allow_pickle=False)
        skeleton = safe_loads(data["treedef"].tobytes())
        self.device = self.device or get_zoo_context().device
        self.params, self.state = tree_map(
            lambda i: torch.from_numpy(np.array(data[str(i)])).to(
                self.device), skeleton)
        self._predict_fn = None  # its captures read the old buffers
        return self

    def load_checkpoint(self, path) -> "KerasNet":
        """Parameters and state from the ``LATEST`` training checkpoint in
        ``path`` (as ``set_checkpoint`` writes during fit, by this package
        or the JAX package), without training: the reference's
        evaluate-from-checkpoint flow."""
        from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
            _Checkpointer,
            _restore_,
        )

        blob = _Checkpointer(path).latest()
        if blob is None:
            raise FileNotFoundError(f"no checkpoint found under {path}")
        self.build_params()
        self.params = tree_map(torch.clone, self.params)
        self.state = tree_map(torch.clone, self.state)
        with torch.no_grad():
            _restore_(self.params, blob["params"])
            _restore_(self.state, blob["state"])
        self._predict_fn = None
        self._estimator = None
        return self

    def save(self, path, over_write=True):
        """Whole-model save: config + weights (as numpy) in one pickle."""
        if os.path.exists(path) and not over_write:
            raise IOError(f"{path} exists and over_write=False")
        weights = (tree_map(_to_numpy, (self.params, self.state))
                   if self.params is not None else None)
        # runtime state stays out of the file: the estimator and the
        # compiled optimizer/loss (which may hold schedule closures)
        keys = ("params", "state", "device", "_estimator", "_compiled",
                "_predict_fn")
        stashed = {k: getattr(self, k, None) for k in keys}
        for k in keys:
            setattr(self, k, None)
        try:
            with open(path, "wb") as f:
                pickle.dump({"net": self, "weights": weights}, f)
        finally:
            for k, v in stashed.items():
                setattr(self, k, v)

    @staticmethod
    def load(path, device=None) -> "KerasNet":
        """Load a model written by :meth:`save` onto ``device`` (default:
        the context's device).  Only this package's classes, numpy arrays
        and a few builtins are accepted from the file."""
        with open(path, "rb") as f:
            blob = safe_load(f)
        net = blob["net"]
        if not isinstance(net, KerasNet):
            raise ValueError(f"{path} does not contain a KerasNet")
        if blob["weights"] is not None:
            net.device = resolve_device(device) if device is not None \
                else get_zoo_context().device
            net.params, net.state = _to_device(blob["weights"], net.device)
        return net

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def layers(self) -> list[Layer]:
        raise NotImplementedError

    def summary(self, line_length: int = 100):
        """The layer table (name and type, output shape, parameter count)
        and the total, printed and returned, as the reference's."""
        lines = ["_" * line_length,
                 f"{'Layer (type)':<44}{'Output Shape':<28}{'Param #':<12}",
                 "=" * line_length]
        total = 0
        for layer in self.layers:
            if isinstance(layer, InputLayer):
                shape, count = layer._build_shape, 0
            else:
                try:
                    shape = layer.compute_output_shape(
                        (None,) + tuple(layer._build_shape or ()))
                except Exception:
                    shape = "?"
                count = layer.param_count() if layer.built else 0
            total += count
            name = f"{layer.name} ({type(layer).__name__})"
            lines.append(f"{name:<44}{str(shape):<28}{count:<12}")
        lines += ["=" * line_length, f"Total params: {total:,}",
                  "_" * line_length]
        text = "\n".join(lines)
        print(text)
        return text


class Sequential(KerasNet):
    """Linear stack of layers."""

    def __init__(self, name=None):
        super().__init__(name=name)
        self._layers: list[Layer] = []
        self._output_shape = None  # batch-less

    @property
    def layers(self):
        return self._layers

    def add(self, layer: Layer) -> "Sequential":
        """Append ``layer``.  After the weights exist (a built stack being
        extended with a new head), they are kept and only the new layer's
        parameters and state are initialised, from the child of the
        context's seed that a full initialisation gives its position; the
        cached ``predict_step`` captures and the estimator (its captures,
        its buffers and its optimizer state, which do not hold the new
        layer) are dropped."""
        if not self._layers:
            in_shape = layer._input_shape
            if in_shape is None and not layer.built:
                raise ValueError(
                    "first layer needs input_shape=..., as in the reference "
                    "Sequential API"
                )
        else:
            in_shape = self._output_shape
        layer.ensure_built(in_shape)
        out_full = layer.compute_output_shape((None,) + tuple(in_shape or ()))
        self._output_shape = tuple(out_full[1:])
        self._layers.append(layer)
        canonicalize_names(self._layers)
        if self.params is not None and not isinstance(layer, InputLayer):
            rng = fold_in(make_generator(get_zoo_context().seed),
                          len(self._layers) - 1)
            p = layer.init_params(rng)
            if p:
                self.params[layer.name] = _to_device(p, self.device)
            s = layer.init_state()
            if s:
                if self.state is None:
                    self.state = {}
                self.state[layer.name] = _to_device(s, self.device)
            self._estimator = None
        self._predict_fn = None  # a cached planned forward is stale now
        return self

    def build(self, input_shape):
        pass  # layers build incrementally in add()

    @property
    def stateful(self):
        return True

    def get_output_shape(self):
        return (None,) + tuple(self._output_shape or ())

    def get_input_shape(self):
        if not self._layers:
            return None
        return (None,) + tuple(self._layers[0]._build_shape or ())

    def init_params(self, rng, given=None):
        given = given or {}
        params = {}
        for i, layer in enumerate(self._layers):
            if isinstance(layer, InputLayer):
                continue
            p = given[layer.name] if layer.name in given \
                else layer.init_params(fold_in(rng, i))
            if p:
                params[layer.name] = p
        return params

    def init_state(self, given=None):
        given = given or {}
        state = {}
        for layer in self._layers:
            s = given[layer.name] if layer.name in given \
                else layer.init_state()
            if s:
                state[layer.name] = s
        return state

    def call(self, params, inputs, state=None, training=False, rng=None):
        state = state or {}
        new_state = dict(state)
        y = inputs
        for i, layer in enumerate(self._layers):
            lrng = fold_in(rng, i) if rng is not None else None
            y, s = layer.apply(
                params.get(layer.name, {}), y,
                state=new_state.get(layer.name),
                training=training, rng=lrng,
            )
            if s:
                new_state[layer.name] = s
        return y, new_state

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(self._output_shape)

    def ensure_built(self, input_shape):
        # Built incrementally; verify compatibility.
        self.built = True
        self._build_shape = input_shape
        return input_shape


class Model(KerasNet):
    """Graph model from symbolic inputs/outputs."""

    def __init__(self, input, output, name=None):
        super().__init__(name=name)
        inputs = input if isinstance(input, (list, tuple)) else [input]
        outputs = output if isinstance(output, (list, tuple)) else [output]
        for v in list(inputs) + list(outputs):
            if not isinstance(v, Variable):
                raise TypeError("Model(input, output) takes symbolic "
                                "Variables from Input(...)")
        self._graph = GraphFunction(inputs, outputs)
        self.built = True
        self._build_shape = [tuple(v.shape[1:]) for v in inputs]
        if len(self._build_shape) == 1:
            self._build_shape = self._build_shape[0]

    @property
    def layers(self):
        return self._graph.layers

    @property
    def stateful(self):
        return True

    def get_output_shape(self):
        shapes = [v.shape for v in self._graph.outputs]
        return shapes[0] if len(shapes) == 1 else shapes

    def get_input_shape(self):
        shapes = [v.shape for v in self._graph.inputs]
        return shapes[0] if len(shapes) == 1 else shapes

    def init_params(self, rng, given=None):
        return self._graph.init_params(rng, given)

    def init_state(self, given=None):
        return self._graph.init_state(given)

    def call(self, params, inputs, state=None, training=False, rng=None):
        return self._graph(params, inputs, state=state, training=training,
                           rng=rng)

    def compute_output_shape(self, input_shape):
        shapes = [v.shape for v in self._graph.outputs]
        return shapes[0] if len(shapes) == 1 else shapes


def merge(inputs, mode="sum", concat_axis=-1, name=None):
    """Functional merge of symbolic Variables (the reference's ``merge``)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.merge import Merge

    return Merge(mode=mode, concat_axis=concat_axis, name=name)(inputs)
