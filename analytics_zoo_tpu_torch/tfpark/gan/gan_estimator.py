"""GANEstimator: alternating generator and discriminator phases.

Counterpart of ``analytics_zoo_tpu/tfpark/gan/gan_estimator.py`` (the
reference's pyzoo/zoo/tfpark/gan/gan_estimator.py:29-152).  The phase
algebra is the reference's: phase-step ``step`` updates the discriminator
when ``step % (d_steps + g_steps) < d_steps``, else the generator, and
only the chosen group's optimizer state advances, so each group's Adam
bias correction counts its own phases.  Where the JAX package picks the
phase with ``lax.cond`` inside one program, the port has one step per
phase, each captured into its own CUDA graph on the card, and picks on
the host.  Each step updates its group's parameters and optimizer state
in place (one fused Adam launch on the card).

The checkpoint (``model_dir/gan_model``) is the reference's pickle of
numpy trees (``gp``, ``dp``, ``gs``, ``ds``) and the step, read through
``safe_load``: either package reads the other's.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.engine import (
    StepRandomness,
    fold_in,
    get_zoo_context,
    make_generator,
)
from analytics_zoo_tpu_torch.common.safe_pickle import safe_load
from analytics_zoo_tpu_torch.common.utils import tree_leaves, tree_map
from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
from analytics_zoo_tpu_torch.parallel.plan import compile_step
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    _unflatten,
    apply_updates_,
    get_optimizer,
)
from analytics_zoo_tpu_torch.pipeline.api.keras.topology import Model


def _build_net(fn, *input_shapes):
    """Call a user's graph-building function on fresh Inputs -> Model."""
    ins = [Input(shape=s) for s in input_shapes]
    out = fn(*ins) if len(ins) > 1 else fn(ins[0])
    return Model(ins if len(ins) > 1 else ins[0], out)


def _numpy_tree(tree):
    return tree_map(lambda t: np.array(t.detach().cpu().numpy()), tree)


def _device_tree(tree, device):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def _loss_and_grads(loss_fn, params):
    """(loss, grads) of ``loss_fn(params)`` by autograd, the grads shaped
    as ``params``."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, grads)


class GANEstimator:
    """Alternating-phase GAN trainer.

    ``generator_fn`` / ``discriminator_fn`` build graphs over
    symbolic Variables; the losses are torch functions,
    ``generator_loss_fn(fake_logits)`` and
    ``discriminator_loss_fn(real_logits, fake_logits)``, the reference's
    TFGAN-style contract.
    """

    def __init__(self, generator_fn, discriminator_fn, generator_loss_fn,
                 discriminator_loss_fn, generator_optimizer,
                 discriminator_optimizer, generator_steps: int = 1,
                 discriminator_steps: int = 1,
                 model_dir: str | None = None):
        self._generator_fn = generator_fn
        self._discriminator_fn = discriminator_fn
        self._generator_loss_fn = generator_loss_fn
        self._discriminator_loss_fn = discriminator_loss_fn
        self._g_opt = get_optimizer(generator_optimizer)
        self._d_opt = get_optimizer(discriminator_optimizer)
        self._g_steps = int(generator_steps)
        self._d_steps = int(discriminator_steps)
        self.checkpoint_path = os.path.join(
            model_dir or tempfile.mkdtemp(), "gan_model")
        self.gen_net = None
        self.disc_net = None
        self._gp = self._dp = None
        self._gs = self._ds = None  # layer states
        self._g_opt_state = self._d_opt_state = None
        self.step = 0
        self._buffers = None  # the trees the phase steps update in place
        self._steps: dict = {}  # phase -> its planned step
        self._randomness = None

    # ------------------------------------------------------------------
    def _ensure_built(self, noise_shape, real_shape):
        root = make_generator(get_zoo_context().seed)
        if self.gen_net is None:
            self.gen_net = _build_net(self._generator_fn, noise_shape)
            self._gp, self._gs = self.gen_net.build_params(fold_in(root, 0))
        if self.disc_net is None:
            # generate() may have built only the generator; the
            # discriminator and optimizer states still need initializing
            self.disc_net = _build_net(self._discriminator_fn, real_shape)
            self._dp, self._ds = self.disc_net.build_params(fold_in(root, 1))
            self._g_opt_state = self._g_opt.init(self._gp)
            self._d_opt_state = self._d_opt.init(self._dp)

    def _own(self):
        """The trees the phase steps update in place: the last train's
        when the estimator still holds them, else copies (the moments laid
        out where the fused Adam kernel writes them); new buffers drop
        the steps captured on the old ones."""
        live = (self._gp, self._dp, self._g_opt_state, self._d_opt_state,
                self._gs, self._ds)
        if self._buffers is not None and all(
                a is b for a, b in zip(live, self._buffers)):
            return
        clone = lambda t: tree_map(torch.clone, t)  # noqa: E731
        self._gp, self._dp = clone(self._gp), clone(self._dp)
        self._gs, self._ds = clone(self._gs), clone(self._ds)
        self._g_opt_state = self._g_opt.in_layout(clone(self._g_opt_state))
        self._d_opt_state = self._d_opt.in_layout(clone(self._d_opt_state))
        self._buffers = (self._gp, self._dp, self._g_opt_state,
                         self._d_opt_state, self._gs, self._ds)
        self._steps = {}

    def _d_step(self, gp, dp, g_os, d_os, gs, ds, noise, real, keys):
        """The discriminator phase in place: (dp, d_os) take their new
        values; returns the loss."""
        gen, disc = self.gen_net, self.disc_net
        k_g, k_d = fold_in(keys[0], 0), fold_in(keys[0], 1)
        with torch.no_grad():
            fake, _ = gen.forward(gp, noise, state=gs, training=True,
                                  rng=k_g)

        def loss(dp_):
            real_out, _ = disc.forward(dp_, real, state=ds, training=True,
                                       rng=k_d)
            fake_out, _ = disc.forward(dp_, fake, state=ds, training=True,
                                       rng=k_d)
            return torch.mean(self._discriminator_loss_fn(real_out,
                                                          fake_out))

        value, grads = _loss_and_grads(loss, dp)
        with torch.no_grad():
            apply_updates_(dp, self._d_opt.update_(grads, d_os, dp))
        return value

    def _g_step(self, gp, dp, g_os, d_os, gs, ds, noise, real, keys):
        """The generator phase in place: (gp, g_os) take their new values;
        returns the loss."""
        gen, disc = self.gen_net, self.disc_net
        k_g, k_d = fold_in(keys[0], 0), fold_in(keys[0], 1)

        def loss(gp_):
            fake, _ = gen.forward(gp_, noise, state=gs, training=True,
                                  rng=k_g)
            fake_out, _ = disc.forward(dp, fake, state=ds, training=True,
                                       rng=k_d)
            return torch.mean(self._generator_loss_fn(fake_out))

        value, grads = _loss_and_grads(loss, gp)
        with torch.no_grad():
            apply_updates_(gp, self._g_opt.update_(grads, g_os, gp))
        return value

    def _step_for(self, phase: str):
        step = self._steps.get(phase)
        if step is None:
            fn = self._d_step if phase == "d" else self._g_step
            step = self._steps[phase] = compile_step(
                fn, label=f"gan_{phase}_step", donate_argnums=(0, 1, 2, 3))
        return step

    def is_d_phase(self, step: int) -> bool:
        """Whether phase-step ``step`` trains the discriminator."""
        return step % (self._g_steps + self._d_steps) < self._d_steps

    # ------------------------------------------------------------------
    def train(self, dataset, end_trigger=None, steps: int | None = None,
              batch_size: int = 32) -> "GANEstimator":
        """Train up to ``steps`` phase-steps in all (reference
        train(dataset, end_trigger), gan_estimator.py:65).  ``dataset``:
        a FeatureSet or (noise, real) arrays, the reference's two dataset
        tensors."""
        ctx = get_zoo_context()
        if isinstance(dataset, tuple):
            dataset = FeatureSet.of(list(dataset))
        if steps is None:
            steps = getattr(end_trigger, "max_iteration", None) or 100
        if dataset.num_samples < batch_size:
            raise ValueError(
                f"dataset has {dataset.num_samples} samples < batch_size "
                f"{batch_size}; shrink batch_size")
        batch0 = next(dataset.batches(batch_size, shuffle=False,
                                      drop_last=False))
        noise0, real0 = batch0["x"]
        self._ensure_built(tuple(noise0.shape[1:]), tuple(real0.shape[1:]))
        self._own()
        device = self.gen_net.device
        if self._randomness is None or \
                self._randomness.device != torch.device(device):
            self._randomness = StepRandomness(device, 1)
        self.losses = []
        it = None
        while self.step < steps:
            if it is None:
                it = dataset.batches(batch_size, shuffle=True,
                                     seed=ctx.seed, epoch=self.step)
            batch = next(it, None)
            if batch is None:
                it = None
                continue
            noise, real = (torch.from_numpy(np.asarray(a)).to(device)
                           for a in batch["x"])
            keys = self._randomness.keys(ctx.seed & 0x7FFFFFFF, self.step)
            phase = "d" if self.is_d_phase(self.step) else "g"
            loss = self._step_for(phase)(
                self._gp, self._dp, self._g_opt_state, self._d_opt_state,
                self._gs, self._ds, noise, real, keys)
            self.losses.append(loss.clone())
            self.step += 1
        self.losses = [float(v) for v in self.losses]
        self._save()
        return self

    # ------------------------------------------------------------------
    def generate(self, noise, batch_size: int = 256) -> np.ndarray:
        """Sample the generator (the reference exposes this by re-loading
        the generator variable scope from the checkpoint)."""
        if self.gen_net is None:
            self.gen_net = _build_net(
                self._generator_fn, tuple(np.asarray(noise).shape[1:]))
            self.gen_net.build_params()
            self._load()
        device = self.gen_net.device
        outs = []
        for lo in range(0, len(noise), batch_size):
            x = torch.from_numpy(np.asarray(noise[lo:lo + batch_size]))
            with torch.no_grad():
                out, _ = self.gen_net.forward(self._gp, x.to(device),
                                              state=self._gs,
                                              training=False)
            outs.append(out.cpu().numpy())
        return np.concatenate(outs)

    def _save(self):
        os.makedirs(os.path.dirname(self.checkpoint_path), exist_ok=True)
        blob = {
            "gp": _numpy_tree(self._gp),
            "dp": _numpy_tree(self._dp),
            "gs": _numpy_tree(self._gs),
            "ds": _numpy_tree(self._ds),
            "step": int(self.step),
        }
        with open(self.checkpoint_path, "wb") as f:
            pickle.dump(blob, f, protocol=4)

    def _load(self):
        with open(self.checkpoint_path, "rb") as f:
            blob = safe_load(f)
        device = self.gen_net.device
        self._gp, self._dp = (_device_tree(blob["gp"], device),
                              _device_tree(blob["dp"], device))
        self._gs, self._ds = (_device_tree(blob["gs"], device),
                              _device_tree(blob["ds"], device))
        self.step = int(blob["step"])
