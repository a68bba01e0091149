"""TorchNet / TorchCriterion: PyTorch modules and losses inside a net.

Counterpart of ``analytics_zoo_tpu/pipeline/api/net/torch_net.py`` (the
reference's pipeline/api/net/TorchNet.scala:39-156 and
TorchCriterion.scala, TorchScript modules run through libtorch JNI as
BigDL modules).

The JAX package runs the module on the host through ``pure_callback``.
In the port the module is torch already: it runs on the net's device
inside the step, so a captured predict or train step replays it with
the rest of the graph.  Its parameters stay frozen and out of the
parameter tree, as in the reference (whose TorchNet gives BigDL's
all-reduce no gradWeight); the input gradient flows through it by torch
autograd, so a TorchNet can sit mid-graph.  :func:`import_state_dict`
copies a state dict's tensors into native layers instead.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer


class TorchNet(Layer):
    """A frozen torch ``nn.Module`` as a layer (reference
    TorchNet.scala:39-156).

    The module's parameters are captured at construction and are not
    trained (as in the reference); the input gradient is computed, so a
    TorchNet can sit mid-graph.  The module moves to the device of its
    input on the first call there.
    """

    def __init__(self, module, output_shape=None, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.module = module.eval()
        for p in self.module.parameters():
            p.requires_grad_(False)
        self._fixed_out_shape = (
            tuple(output_shape) if output_shape is not None else None
        )
        self._out_shapes: dict = {}  # per-input-shape cache

    # -- constructors matching the reference surface -----------------------
    @classmethod
    def from_pytorch(cls, module, input_shape=None, **kwargs):
        """Reference torch_net.py ``TorchNet.from_pytorch(module, ...)``."""
        return cls(module, input_shape=input_shape, **kwargs)

    @classmethod
    def load(cls, path, **kwargs):
        """Load a TorchScript archive saved with ``torch.jit.save``
        (reference TorchNet.scala loads TorchScript bytes)."""
        return cls(torch.jit.load(path, map_location="cpu"), **kwargs)

    def save(self, path):
        mod = self.module
        if not isinstance(mod, torch.jit.ScriptModule):
            mod = torch.jit.script(mod)
        torch.jit.save(mod, path)

    # -- shape inference ---------------------------------------------------
    def _infer_out_shape(self, input_shape):
        if self._fixed_out_shape is not None:
            return self._fixed_out_shape
        key = tuple(int(s) for s in input_shape)
        out = self._out_shapes.get(key)
        if out is None:  # shape-dependent graphs (e.g. fully-conv) get a
            #              fresh probe per input shape
            dev = next((p.device for p in self.module.parameters()),
                       torch.device("cpu"))
            with torch.no_grad():
                y = self.module(torch.zeros((1,) + key, device=dev))
            out = self._out_shapes[key] = tuple(y.shape[1:])
        return out

    def build(self, input_shape):
        self._infer_out_shape(input_shape)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self._infer_out_shape(input_shape[1:])

    # -- execution ---------------------------------------------------------
    def _on(self, device):
        """The module on ``device`` (moved there once, outside a
        capture: the first call on a device is an eager run)."""
        p = next(self.module.parameters(), None)
        if p is None:
            p = next(self.module.buffers(), None)
        if p is not None and p.device != device:
            self.module.to(device)
        return self.module

    def call(self, params, inputs, state=None, training=False, rng=None):
        return self._on(inputs.device)(inputs)


class TorchCriterion(Layer):
    """A torch loss as an objective (reference TorchCriterion.scala;
    python wrapper torch_criterion.py traces ``loss_fn(input, label)``).

    Callable as ``crit(y_true, y_pred)`` returning the scalar batch loss;
    non-reducing torch losses (``reduction='none'``) are mean-reduced, so
    it plugs into ``compile(loss=TorchCriterion.from_pytorch(...))``.
    """

    def __init__(self, loss_fn, name=None):
        super().__init__(name=name)
        self.loss_fn = loss_fn

    @classmethod
    def from_pytorch(cls, loss_fn, **kwargs):
        return cls(loss_fn, **kwargs)

    def __call__(self, y_true, y_pred):  # objective protocol
        val = self.loss_fn(y_pred, y_true)
        if val.dim() > 0:  # reduction='none' losses
            val = val.mean()
        return val.to(y_pred.dtype).reshape(())

    def mean(self, y_true, y_pred, sample_weight=None):
        """Objective protocol used by the Estimator's train step; torch
        criterions reduce to a scalar, so per-sample weighting cannot be
        applied: reject it loudly rather than ignore it."""
        if sample_weight is not None:
            raise NotImplementedError(
                "TorchCriterion reduces to a scalar inside torch; "
                "sample_weight is not supported: use a native objective "
                "or fold the weights into the torch loss itself"
            )
        return self.__call__(y_true, y_pred)


def import_state_dict(model, state_dict, mapping):
    """Copy torch ``state_dict`` tensors into a model's parameter tree.

    ``mapping``: list of ``(zoo_path, torch_key, transform)`` where
    ``zoo_path`` is a ``"layer/weight"`` key into the params dict and
    ``transform`` (optional) maps the numpy array (e.g. transpose
    OIHW->HWIO).  Returns the updated params.
    """
    params, _ = model.build_params()
    for entry in mapping:
        zoo_path, torch_key = entry[0], entry[1]
        transform = entry[2] if len(entry) > 2 else None
        arr = state_dict[torch_key].detach().cpu().numpy()
        if transform is not None:
            arr = transform(arr)
        node = params
        *parents, leaf = zoo_path.split("/")
        for p in parents:
            node = node[p]
        if tuple(node[leaf].shape) != tuple(np.shape(arr)):
            raise ValueError(
                f"{zoo_path}: shape {tuple(node[leaf].shape)} != torch "
                f"{torch_key} {np.shape(arr)}"
            )
        node[leaf] = torch.from_numpy(np.array(arr)).to(
            node[leaf].device, node[leaf].dtype)
    model.params = params
    model._predict_fn = None  # its captures read the old buffers
    return params
