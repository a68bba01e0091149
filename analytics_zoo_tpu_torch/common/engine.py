"""Engine context: device, seed, numerics policy and random generators.

Counterpart of ``analytics_zoo_tpu/common/engine.py``.  The reference's
context owns a device mesh; the port runs on one device, so the context
owns that device instead, and the dtype-policy tier of the reference's
env config (``ZOO_DTYPE_POLICY``, validated when the context is made).
The sharding planes come with the distribution slice.

Randomness: a ``torch.Generator`` stands in for a ``jax.random`` key.
:func:`fold_in` derives a child generator from its parent's seed alone
(the parent's state is not consumed), on the parent's device, as
``jax.random.fold_in`` derives a child key; :func:`step_generator` is the
training step's root, the counterpart of
``fold_in(PRNGKey(seed), step)``.  :func:`seed_pair` turns a generator
into the (seed0, seed1) pair the flash kernel's dropout hash takes, from
the seed alone, so the pair is the same on every device and reading it
never waits on the device.

A captured train step cannot take a new generator per step and site, nor
pass the flash seed pair as a launch argument: a CUDA graph would replay
step 1's masks.  :class:`StepRandomness` keeps the step's randomness as
state that outlives the step, as the reference derives it in-graph from
device scalars (estimator.py:1013-1024): one persistent generator per
dropout site and one flash seed pair per attention site, for each of the
K inner steps of a dispatch, registered with the graph and re-seeded on
the host before each replay with exactly the seed the :func:`fold_in`
tree gives that site.  Inside the step the model sees :class:`StepKey` objects
in place of generators: :func:`fold_in` derives them the same way, a
dropout site asks :func:`generator_of` for its generator and the flash
kernel ``normalize_seed`` for its seed pair, as a (2,) int32 tensor on
the device (the pair's 32-bit patterns) that the kernels read.  So the
masks are the eager step's, bit for bit.

``ZOO_STEPS_PER_DISPATCH`` (K, validated when the context is made: K < 1
raises, as the reference's ``ZooConfig``) is the number of train steps
one dispatch of ``fit`` runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.utils import tree_map
from analytics_zoo_tpu_torch.parallel.plan import resolve_dtype_rules

logger = logging.getLogger("analytics_zoo_tpu_torch")


@dataclasses.dataclass
class ZooContext:
    """Runtime context: the device plus engine-level knobs."""

    device: torch.device
    seed: int = 0
    # Forward math dtype (params-in-compute); None = full f32.
    compute_dtype: torch.dtype | None = None
    # ZOO_DTYPE_POLICY: a policy spec the estimator overlays on a plan that
    # has no dtype rules (None = no policy)
    dtype_policy: str | None = None
    # ZOO_STEPS_PER_DISPATCH: train steps one dispatch of fit runs (K >= 1)
    steps_per_dispatch: int = 1


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device.  Raises when the
    device is CUDA and no GPU is visible: nothing falls back to the CPU
    unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return dev


_U32 = 0xFFFFFFFF
_SEEDS = 1 << 63  # a generator's seed is taken modulo this


def make_generator(seed: int, device=None) -> torch.Generator:
    """A generator seeded with ``seed``, on ``device`` (default: CPU)."""
    gen = torch.Generator(device=torch.device(device or "cpu"))
    return gen.manual_seed(int(seed) % _SEEDS)


def _child_seed(seed: int, data: int) -> int:
    """The seed :func:`fold_in` gives the child ``data`` of ``seed``."""
    return (seed * 0x9E3779B1 + int(data) + 1) % _SEEDS


def fold_in(gen, data: int):
    """A child of ``gen`` determined by ``gen``'s seed and ``data`` alone
    (``gen``'s state is not consumed): a generator on ``gen``'s device, or
    for a :class:`StepKey` the key one level down its path."""
    seed = _child_seed(gen.initial_seed(), data)
    if isinstance(gen, StepKey):
        return StepKey(seed, gen.path + (int(data),), gen.slot, gen.keys)
    return make_generator(seed, gen.device)


def step_generator(seed: int, step: int, device=None) -> torch.Generator:
    """The root generator of training step ``step``: the counterpart of
    ``fold_in(PRNGKey(seed), step)`` in the reference's train step."""
    return fold_in(make_generator(seed, device), step)


def seed_pair(gen) -> tuple[int, int]:
    """(seed0, seed1) for the flash kernel's dropout hash: the low and high
    32 bits of ``gen``'s seed (a generator's or a :class:`StepKey`'s), as
    unsigned 32-bit values."""
    s = gen.initial_seed()
    return s & _U32, (s >> 32) & _U32


def _host_pairs(pairs, device) -> torch.Tensor:
    """Flash seed pairs (an (..., 2) nest of unsigned 32-bit values) as a
    host int32 tensor of their bit patterns, pinned when they go to a CUDA
    device (so the copy does not wait for the device; the host allocator
    keeps a pinned block until the copies that read it have run)."""
    host = torch.from_numpy(np.asarray(pairs, np.uint32).view(np.int32))
    return host.pin_memory() if device.type == "cuda" else host


def pair_tensor(pairs, device) -> torch.Tensor:
    """Flash seed pairs as an int32 tensor of their bit patterns on
    ``device``."""
    device = torch.device(device)
    return _host_pairs(pairs, device).to(device, non_blocking=True)


def generator_of(rng) -> torch.Generator:
    """The generator a dropout site draws from: ``rng`` itself, or the
    site's generator for a :class:`StepKey`."""
    return rng.generator() if isinstance(rng, StepKey) else rng


class StepKey:
    """A key inside one inner step (``slot``) of a train dispatch: the
    seed its generator would have and its :func:`fold_in` path from the
    step's root.  Its generators and flash seed pairs come from the
    dispatch's :class:`StepRandomness`."""

    __slots__ = ("seed", "path", "slot", "keys")

    def __init__(self, seed, path, slot, keys):
        self.seed, self.path, self.slot, self.keys = seed, path, slot, keys

    def initial_seed(self) -> int:
        return self.seed

    def generator(self) -> torch.Generator:
        """This site's generator, seeded with :attr:`seed`."""
        return self.keys.source.request(self, 0)

    def flash_seed(self) -> torch.Tensor:
        """This site's flash seed pair: a (2,) int32 tensor on the device."""
        return self.keys.source.request(self, 1)


class StepKeys:
    """The root keys of one dispatch: inner step ``i`` is global step
    ``step0 + i`` (the reference's scan), its root ``step_generator(seed,
    step0 + i)``.  ``run`` records, per inner step, the paths of the
    generator and seed-pair requests an eager run made, in order."""

    def __init__(self, source, seed, step0):
        self.source, self.seed, self.step0 = source, int(seed), int(step0)
        self.run = [([], []) for _ in range(source.k)]

    def __getitem__(self, i) -> StepKey:
        root = _child_seed(self.seed % _SEEDS, self.step0 + i)
        return StepKey(root, (), i, self)

    def sites(self) -> tuple:
        return tuple((tuple(g), tuple(p)) for g, p in self.run)


def _derive(root: int, path) -> int:
    for data in path:
        root = _child_seed(root, data)
    return root


class SiteState:
    """The persistent randomness of one captured step: one generator per
    recorded generator request and a (K, n, 2) int32 seed-pair buffer, for
    the ``sites`` (per inner step: generator paths, pair paths) of the
    eager run before the capture."""

    def __init__(self, sites, device, k):
        self.sites = sites
        self.gens = [[torch.Generator(device=device) for _ in g]
                     for g, _ in sites]
        self.pairs = torch.zeros((k, max(len(p) for _, p in sites), 2),
                                 dtype=torch.int32, device=device)

    def generators(self) -> list:
        return [g for gens in self.gens for g in gens]


class StepRandomness:
    """The per-step randomness of a K-step train dispatch on ``device``, as
    state a captured graph reads.

    An eager run (every run on the CPU, the first on the card) gives each
    request a fresh generator and pair tensor, as today's step does, and
    records the requests' paths in its :class:`StepKeys`.  Before a
    capture, :meth:`prepare_capture` gives the :class:`SiteState` of those
    sites (one per distinct set of sites: another batch shape can take
    another attention route), whose generators the graph registers;
    inside :meth:`capturing` the requests are served from it, in the
    recorded order.  Before each replay :meth:`reseed` seeds every
    generator and writes every pair of the capture's state, for the
    dispatch's seed and first step, by one copy from pinned memory."""

    def __init__(self, device, k: int = 1):
        self.device = torch.device(device)
        self.k = int(k)
        self._states: dict = {}  # sites -> SiteState
        self._serving = None     # during a capture: (state, cursors)

    def keys(self, seed: int, step0: int) -> StepKeys:
        return StepKeys(self, seed, step0)

    def request(self, key: StepKey, kind: int):
        """A generator (``kind`` 0) or a flash seed pair (1) for ``key``."""
        if self._serving is None:
            key.keys.run[key.slot][kind].append(key.path)
            if kind == 0:
                return make_generator(key.seed, self.device)
            return pair_tensor(seed_pair(key), self.device)
        state, cursor = self._serving
        i = cursor[key.slot][kind]
        sites = state.sites[key.slot][kind]
        if i >= len(sites) or sites[i] != key.path:
            raise RuntimeError(
                "the train step's random sites changed between its eager "
                f"run and its capture (inner step {key.slot}, request {i}: "
                f"{key.path} against {sites[i] if i < len(sites) else None})")
        cursor[key.slot][kind] += 1
        return state.gens[key.slot][i] if kind == 0 \
            else state.pairs[key.slot, i]

    def prepare_capture(self, keys: StepKeys) -> SiteState:
        """The persistent state for the sites ``keys``' eager run
        recorded."""
        sites = keys.sites()
        state = self._states.get(sites)
        if state is None:
            state = self._states[sites] = SiteState(sites, self.device,
                                                    self.k)
        return state

    @contextlib.contextmanager
    def capturing(self, state: SiteState):
        """Serve requests from ``state`` (inside a capture)."""
        cursor = [[0, 0] for _ in range(self.k)]
        self._serving = (state, cursor)
        try:
            yield
            for cur, (g, p) in zip(cursor, state.sites):
                if cur != [len(g), len(p)]:
                    raise RuntimeError(
                        "the train step's capture made fewer random "
                        "requests than its eager run")
        finally:
            self._serving = None

    def reseed(self, keys: StepKeys, state: SiteState) -> None:
        """Seed every generator and write every pair of ``state`` for
        ``keys``' seed and first step, as the eager run of those steps
        seeds them."""
        pairs = np.zeros(state.pairs.shape, np.uint32)
        for slot, ((gpaths, ppaths), gens) in enumerate(
                zip(state.sites, state.gens)):
            root = keys[slot].seed
            for gen, path in zip(gens, gpaths):
                gen.manual_seed(_derive(root, path))
            for i, path in enumerate(ppaths):
                s = _derive(root, path)
                pairs[slot, i] = (s & _U32, (s >> 32) & _U32)
        if pairs.size:
            state.pairs.copy_(_host_pairs(pairs, self.device),
                              non_blocking=True)


def cast_floats(tree, dtype):
    """Cast floating-point leaves of a tree to ``dtype`` (None = no-op);
    integer leaves (labels, token ids) pass through untouched."""
    if dtype is None:
        return tree
    return tree_map(
        lambda a: a.to(dtype) if torch.is_tensor(a)
        and a.is_floating_point() else a, tree)


def _resolve_compute_dtype(spec):
    """Resolve the compute dtype policy.

    Precedence: explicit arg > ZOO_COMPUTE_DTYPE env > full f32.  The
    reference defaults to bf16 only on the TPU and computes in f32
    elsewhere, which is what the port's parity tolerances assume.
    """
    if spec is None:
        spec = os.environ.get("ZOO_COMPUTE_DTYPE")
    if spec is None:
        return None
    if spec in (torch.bfloat16, torch.float16, torch.float32):
        return None if spec == torch.float32 else spec
    s = str(spec).lower()
    if s in ("float32", "f32", "fp32", "none", ""):
        return None
    if s in ("bfloat16", "bf16"):
        return torch.bfloat16
    if s in ("float16", "f16", "fp16"):
        return torch.float16
    raise ValueError(f"unknown compute_dtype {spec!r}")


def _resolve_steps_per_dispatch(value):
    """K: explicit arg > ``ZOO_STEPS_PER_DISPATCH`` > 1; anything but an
    integer >= 1 raises here, naming its source (the reference's
    ``ZooConfig`` contract: no silent clamping)."""
    if value is not None:
        src, raw = "steps_per_dispatch", value
    elif "ZOO_STEPS_PER_DISPATCH" in os.environ:
        src, raw = "ZOO_STEPS_PER_DISPATCH", os.environ[
            "ZOO_STEPS_PER_DISPATCH"]
    else:
        return 1
    try:
        k = int(str(raw))
    except (TypeError, ValueError):
        raise ValueError(f"{src} must be an integer >= 1, got {raw!r}") \
            from None
    if k < 1:
        raise ValueError(f"{src} must be >= 1, got {k}")
    return k


def _resolve_dtype_policy():
    """The dtype policy ``ZOO_DTYPE_POLICY`` names (None: none), validated
    here so a bad value fails at context init naming the variable.
    ``"auto"`` passes (the config oracle resolves it, as in the reference;
    the port's estimator refuses it until that is ported)."""
    spec = os.environ.get("ZOO_DTYPE_POLICY")
    if spec is None:
        return None
    if spec.strip().lower() != "auto":
        try:
            resolve_dtype_rules(spec)
        except ValueError as e:
            raise ValueError(f"ZOO_DTYPE_POLICY: {e}") from None
    return spec


_LOCK = threading.Lock()
_CONTEXT: ZooContext | None = None  # guarded-by: _LOCK


def init_zoo_context(*, seed: int | None = None, device=None,
                     compute_dtype=None,
                     steps_per_dispatch: int | None = None) -> ZooContext:
    """Initialise (or re-initialise) the global runtime context.

    ``device`` defaults to ``cuda`` and raises when no GPU is visible;
    tests pass ``device="cpu"``.  ``ZOO_DTYPE_POLICY`` and
    ``ZOO_STEPS_PER_DISPATCH`` (``steps_per_dispatch`` beats it) are read
    and validated here.  TF32 is switched off for matmuls and
    cuDNN: the reference computes in full f32 off-TPU, and the port's
    parity tolerances assume full f32.
    """
    global _CONTEXT
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = ZooContext(device=dev, seed=int(seed or 0),
                     compute_dtype=_resolve_compute_dtype(compute_dtype),
                     dtype_policy=_resolve_dtype_policy(),
                     steps_per_dispatch=_resolve_steps_per_dispatch(
                         steps_per_dispatch))
    with _LOCK:
        _CONTEXT = ctx
    logger.info("init_zoo_context: device %s, seed %d; TF32 off for "
                "matmul and cuDNN (full-f32 numerics)", dev, ctx.seed)
    return ctx


def get_zoo_context() -> ZooContext:
    """Current context, creating the default (``cuda``) one on demand."""
    with _LOCK:
        if _CONTEXT is not None:
            return _CONTEXT
    return init_zoo_context()
