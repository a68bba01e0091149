"""Engine context: device, seed, numerics policy and random generators.

Counterpart of ``analytics_zoo_tpu/common/engine.py``.  The reference's
context owns a device mesh; the port runs on one device, so the context
owns that device instead, and the resolved :class:`ZooConfig` (the
reference's conf tiers: explicit arguments, a conf dict or app name, env
vars, defaults; every knob validated when the context is made).  The
sharding planes come with the distribution slice.

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
import math
import os
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.utils import tree_map
from analytics_zoo_tpu_torch.parallel.plan import (
    DTYPE_ROLES,
    PLAN_NAMES,
    resolve_dtype_rules,
)

logger = logging.getLogger("analytics_zoo_tpu_torch")


DATA_AXIS = "data"
MODEL_AXIS = "model"


def _parse_bytes(raw, name: str) -> int:
    """Byte-count knob parser: plain int, or a K/M/G (binary) suffix —
    ``"512M"`` reads as 512 MiB.  Errors name the knob."""
    s = str(raw).strip()
    mult = 1
    if s and s[-1].upper() in "KMG":
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}[s[-1].upper()]
        s = s[:-1]
    try:
        val = int(float(s) * mult)
    except (ValueError, OverflowError):
        raise ValueError(
            f"{name} must be a byte count (integer, optionally with a "
            f"K/M/G suffix), got {raw!r}") from None
    if val < 1:
        raise ValueError(f"{name} must be >= 1 byte, got {raw!r}")
    return val


def _bool_parser(var):
    def parse(raw):
        s = str(raw).strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("", "0", "false", "no", "off"):
            return False
        # 'false'-alikes must never silently enable a feature
        raise ValueError(
            f"{var} must be a boolean "
            f"(1/0/true/false/yes/no/on/off), got {raw!r}")
    return parse


#: ZooConfig fields that ``serving.ClusterServingHelper`` reads when its
#: own overrides and yaml leave them unset (``serving_knob``)
SERVING_KNOBS = ("serving_batch_budget_ms", "fleet_lease_ms")


@dataclasses.dataclass
class ZooConfig:
    """Typed engine configuration: the reference's ``ZooConfig``
    (``analytics_zoo_tpu/common/engine.py:93-560``), every field and env
    var with its default and its eager validation (a bad value fails here,
    naming its env var or field).

    Precedence: explicit ``init_zoo_context`` arguments / conf dict >
    environment variables > dataclass defaults.

    What the port does with each knob:

    - honoured: ``seed``, ``compute_dtype`` (``ZOO_COMPUTE_DTYPE``),
      ``failure_retry_times`` (``ZOO_FAILURE_RETRY_TIMES``, default 5),
      ``profile_dir``/``profile_steps`` (``ZOO_PROFILE_DIR``/
      ``ZOO_PROFILE_STEPS``: one ``torch.profiler`` trace a fit),
      ``infeed_depth`` (``ZOO_INFEED_DEPTH``, default 2),
      ``steps_per_dispatch`` (``ZOO_STEPS_PER_DISPATCH``),
      ``compile_cache`` (``ZOO_COMPILE_CACHE``: the kernel libraries'
      directory), ``sharding_plan`` and ``shard_optimizer``
      (``ZOO_SHARDING_PLAN``/``ZOO_SHARD_OPTIMIZER``, through
      ``parallel.plan.resolve_plan``: the sharded names raise there,
      item 13), ``dtype_policy`` (``ZOO_DTYPE_POLICY``), ``use_pallas``
      (``ZOO_USE_PALLAS``, below), ``platform`` (``"cuda"``/``"gpu"`` or
      ``"cpu"``: the device when ``init_zoo_context`` is given none);
      ``ZOO_DTYPE_RESUME`` and ``ZOO_ASYNC_CHECKPOINT`` are read by the
      estimator's checkpointer, as in the reference;
    - the knobs of planes the port does not have yet are validated here
      with the reference's messages, and ``init_zoo_context`` raises
      ``NotImplementedError`` naming the plane's ROADMAP item for any of
      them away from its default (:data:`UNPORTED_KNOBS`): the prefetch
      and autotune planes (item 16), the serving fleet plane: its
      scaler, admission and model roster (17), the metrics plane's
      federation and SLO tier (18), the elastic runtime (21), and a mesh
      of more than one device or a DCN axis (13).
      ``serving_batch_budget_ms`` and ``fleet_lease_ms``
      (:data:`SERVING_KNOBS`) are honoured by
      ``serving.ClusterServingHelper``: a value given here (a field or a
      conf entry) is taken through :func:`serving_knob`, and their env
      vars the helper reads itself, as the reference's does;
      ``ZOO_METRICS_PORT`` and ``ZOO_FLIGHT_DIR`` by the metrics plane.

    ``use_pallas`` differs from the reference in its unset state: the
    reference's default (False) computes without its Pallas kernels,
    while the port's scopes take their CUDA kernels on the card with no
    rule at all (what the reference does under ``ZOO_USE_PALLAS=1``).  So
    unset resolves to ``None`` (the port's routing), ``True`` keeps it,
    and an explicit ``False`` (``ZOO_USE_PALLAS=0``) is the user's
    opt-out: the estimator overlays the ``"xla"`` kernel rule on a plan
    that has no kernel rules of its own.
    """

    app_name: str = "analytics-zoo-tpu"
    seed: int = 0
    mesh_shape: Mapping[str, int] | None = None
    mesh_axes: Sequence[str] = (DATA_AXIS, MODEL_AXIS)
    platform: str | None = None
    compute_dtype: object = None
    # None = "not explicitly set": resolved env > default in __post_init__
    failure_retry_times: int | None = None
    profile_dir: str | None = None
    profile_steps: int | None = None
    infeed_depth: int | None = None
    prefetch_workers: int | None = None
    prefetch_depth: int | None = None
    steps_per_dispatch: int | None = None
    compile_cache: str | None = None
    shard_optimizer: bool | None = None
    sharding_plan: str | None = None
    dtype_policy: str | None = None
    use_pallas: bool | None = None
    dcn_axis: str | None = None
    autotune: bool | None = None
    autotune_ram_budget: int | None = None
    autotune_interval: float | None = None
    autotune_max_workers: int | None = None
    serving_batch_budget_ms: float | None = None
    slo_p99_ms: float | None = None
    fleet_min_replicas: int | None = None
    fleet_max_replicas: int | None = None
    fleet_interval: float | None = None
    fleet_lease_ms: int | None = None
    admission: bool | None = None
    serving_models: str | None = None
    elastic: bool | None = None
    elastic_lease_ms: int | None = None
    elastic_min_workers: int | None = None
    elastic_grace_ms: int | None = None
    scrape_targets: str | None = None
    scrape_interval: float | None = None
    scrape_stale_after: float | None = None
    slo_objective: float | None = None
    slo_short_window: float | None = None
    slo_long_window: float | None = None
    slo_burn_threshold: float | None = None

    def __post_init__(self):
        env = os.environ
        # the serving knobs given as fields, before their env vars fill
        # them in (``serving_knob``); init_zoo_context carries this over
        # its dataclasses.replace copies
        self._given_serving = {n: getattr(self, n) for n in SERVING_KNOBS
                               if getattr(self, n) is not None}

        def resolve(value, env_key, default, cast=int):
            if value is not None:
                return value
            if env_key in env:
                return cast(env[env_key])
            return default

        def resolve_number(value, env_key, default, minimum, cast, kind):
            """Eager-validated knob: a bad value fails HERE naming its
            source (env var or field)."""
            if value is not None:
                src, raw = "ZooConfig " + env_key[4:].lower(), value
            elif env_key in env:
                src, raw = env_key, env[env_key]
            else:
                return default
            try:
                out = cast(str(raw))
            except (TypeError, ValueError):
                raise ValueError(
                    f"{src} must be {kind} >= {minimum}, "
                    f"got {raw!r}") from None
            if out < minimum:
                raise ValueError(f"{src} must be >= {minimum}, got {out}")
            return out

        def resolve_int(value, env_key, default, minimum):
            return resolve_number(value, env_key, default, minimum, int,
                                  "an integer")

        def resolve_float(value, env_key, default, minimum):
            return resolve_number(value, env_key, default, minimum, float,
                                  "a number")

        self.failure_retry_times = resolve(
            self.failure_retry_times, "ZOO_FAILURE_RETRY_TIMES", 5)
        self.profile_steps = resolve(
            self.profile_steps, "ZOO_PROFILE_STEPS", 5)
        self.infeed_depth = resolve(
            self.infeed_depth, "ZOO_INFEED_DEPTH", 2)
        self.prefetch_workers = resolve_int(
            self.prefetch_workers, "ZOO_PREFETCH_WORKERS", 0, minimum=0)
        self.prefetch_depth = resolve_int(
            self.prefetch_depth, "ZOO_PREFETCH_DEPTH", 4, minimum=1)
        self.steps_per_dispatch = resolve_int(
            self.steps_per_dispatch, "ZOO_STEPS_PER_DISPATCH", 1,
            minimum=1)
        self.shard_optimizer = bool(resolve(
            self.shard_optimizer, "ZOO_SHARD_OPTIMIZER", False))
        self.sharding_plan = resolve(
            self.sharding_plan, "ZOO_SHARDING_PLAN", None, cast=str)
        if self.sharding_plan is not None:
            self._check_plan_name()
        self.dtype_policy = resolve(
            self.dtype_policy, "ZOO_DTYPE_POLICY", None, cast=str)
        if self.dtype_policy is not None \
                and str(self.dtype_policy).strip().lower() != "auto":
            try:
                resolve_dtype_rules(self.dtype_policy)
            except ValueError as e:
                raise ValueError(f"ZOO_DTYPE_POLICY: {e}") from None
        self.dcn_axis = resolve(
            self.dcn_axis, "ZOO_DCN_AXIS", None, cast=str)
        if self.dcn_axis is not None and not str(self.dcn_axis).strip():
            raise ValueError("ZOO_DCN_AXIS must be a mesh axis name")
        # None when unset: the port's own kernel routing (class note)
        self.use_pallas = resolve(
            self.use_pallas, "ZOO_USE_PALLAS", None,
            cast=_bool_parser("ZOO_USE_PALLAS"))
        if self.use_pallas is not None:
            self.use_pallas = bool(self.use_pallas)
        self.autotune = bool(resolve(
            self.autotune, "ZOO_AUTOTUNE", False,
            cast=_bool_parser("ZOO_AUTOTUNE")))
        if self.autotune_ram_budget is None:
            raw = env.get("ZOO_AUTOTUNE_RAM_BUDGET")
            if raw:
                self.autotune_ram_budget = _parse_bytes(
                    raw, "ZOO_AUTOTUNE_RAM_BUDGET")
        elif self.autotune_ram_budget < 1:
            raise ValueError(
                f"ZooConfig autotune_ram_budget must be >= 1 byte, "
                f"got {self.autotune_ram_budget}")
        self.autotune_interval = resolve(
            self.autotune_interval, "ZOO_AUTOTUNE_INTERVAL", 0.25,
            cast=float)
        if self.autotune_interval <= 0:
            raise ValueError(
                f"ZOO_AUTOTUNE_INTERVAL must be > 0, "
                f"got {self.autotune_interval}")
        self.autotune_max_workers = resolve_int(
            self.autotune_max_workers, "ZOO_AUTOTUNE_MAX_WORKERS", None,
            minimum=1)
        self.serving_batch_budget_ms = resolve_float(
            self.serving_batch_budget_ms, "ZOO_SERVING_BATCH_BUDGET_MS",
            25.0, minimum=0.0)
        self.slo_p99_ms = resolve_float(
            self.slo_p99_ms, "ZOO_SLO_P99_MS", 500.0, minimum=1.0)
        self.fleet_min_replicas = resolve_int(
            self.fleet_min_replicas, "ZOO_FLEET_MIN_REPLICAS", 1,
            minimum=1)
        self.fleet_max_replicas = resolve_int(
            self.fleet_max_replicas, "ZOO_FLEET_MAX_REPLICAS", 4,
            minimum=1)
        if self.fleet_max_replicas < self.fleet_min_replicas:
            raise ValueError(
                f"ZOO_FLEET_MAX_REPLICAS ({self.fleet_max_replicas}) must "
                f"be >= ZOO_FLEET_MIN_REPLICAS "
                f"({self.fleet_min_replicas})")
        self.fleet_interval = resolve_float(
            self.fleet_interval, "ZOO_FLEET_INTERVAL", 1.0, minimum=0.01)
        self.fleet_lease_ms = resolve_int(
            self.fleet_lease_ms, "ZOO_FLEET_LEASE_MS", 10_000,
            minimum=100)
        self.admission = bool(resolve(
            self.admission, "ZOO_ADMISSION", False,
            cast=_bool_parser("ZOO_ADMISSION")))
        self.serving_models = resolve(
            self.serving_models, "ZOO_SERVING_MODELS", None, cast=str)
        self.elastic = bool(resolve(
            self.elastic, "ZOO_ELASTIC", False,
            cast=_bool_parser("ZOO_ELASTIC")))
        self.elastic_lease_ms = resolve_int(
            self.elastic_lease_ms, "ZOO_ELASTIC_LEASE_MS", 3_000,
            minimum=100)
        self.elastic_min_workers = resolve_int(
            self.elastic_min_workers, "ZOO_ELASTIC_MIN_WORKERS", 1,
            minimum=1)
        self.elastic_grace_ms = resolve_int(
            self.elastic_grace_ms, "ZOO_ELASTIC_GRACE_MS", 5_000,
            minimum=0)
        self.scrape_targets = resolve(
            self.scrape_targets, "ZOO_SCRAPE_TARGETS", None, cast=str)
        self.scrape_interval = resolve_float(
            self.scrape_interval, "ZOO_SCRAPE_INTERVAL", 1.0,
            minimum=0.05)
        self.scrape_stale_after = resolve_float(
            self.scrape_stale_after, "ZOO_SCRAPE_STALE_AFTER", 10.0,
            minimum=0.05)
        self.slo_objective = resolve_float(
            self.slo_objective, "ZOO_SLO_OBJECTIVE", 0.99, minimum=0.0)
        if not 0.0 < self.slo_objective < 1.0:
            raise ValueError(
                f"ZOO_SLO_OBJECTIVE must be in (0, 1) — the fraction "
                f"of good events promised — got {self.slo_objective}")
        self.slo_short_window = resolve_float(
            self.slo_short_window, "ZOO_SLO_SHORT_WINDOW", 30.0,
            minimum=0.1)
        self.slo_long_window = resolve_float(
            self.slo_long_window, "ZOO_SLO_LONG_WINDOW", 300.0,
            minimum=0.1)
        if self.slo_long_window <= self.slo_short_window:
            raise ValueError(
                f"ZOO_SLO_LONG_WINDOW ({self.slo_long_window}) must be "
                f"> ZOO_SLO_SHORT_WINDOW ({self.slo_short_window}) — "
                f"multi-window burn-rate alerting needs a slow window "
                f"to confirm the fast one")
        self.slo_burn_threshold = resolve_float(
            self.slo_burn_threshold, "ZOO_SLO_BURN_THRESHOLD", 1.0,
            minimum=0.0)
        if self.slo_burn_threshold <= 0:
            raise ValueError(
                f"ZOO_SLO_BURN_THRESHOLD must be > 0, "
                f"got {self.slo_burn_threshold}")
        if self.profile_dir is None:
            self.profile_dir = env.get("ZOO_PROFILE_DIR") or None
        if self.compile_cache is None:
            self.compile_cache = env.get("ZOO_COMPILE_CACHE") or None

    def _check_plan_name(self):
        """``ZOO_SHARDING_PLAN`` validated eagerly, as in the reference:
        suffixes strip in ``resolve_plan``'s order (``+kernels``, a dtype
        role, ``+overlap``)."""
        valid = tuple(PLAN_NAMES) + ("auto",)
        name = str(self.sharding_plan).strip().lower()
        if name.endswith("+kernels"):
            name = name[:-len("+kernels")]
        for role in DTYPE_ROLES:
            if name.endswith("+" + role):
                name = name[:-len("+" + role)]
                break
        base = name[:-len("+overlap")] \
            if name.endswith("+overlap") else name
        overlappable = ("zero1", "zero2", "zero3", "fsdp")
        if not (name in valid or (name.endswith("+overlap")
                                  and base in overlappable)):
            raise ValueError(
                f"ZOO_SHARDING_PLAN must be one of "
                f"{', '.join(valid)} (zero1/zero2/zero3/fsdp also "
                f"accept a '+overlap' suffix, and any plan a "
                f"trailing dtype-role suffix like '+bf16'); "
                f"got {self.sharding_plan!r}")


#: knobs of planes the port does not have yet: field -> (the value that
#: leaves the plane off, its ROADMAP queue 1 item).  ``init_zoo_context``
#: raises for any other value.
UNPORTED_KNOBS = {
    "prefetch_workers": (0, 16), "prefetch_depth": (4, 16),
    "autotune": (False, 16), "autotune_ram_budget": (None, 16),
    "autotune_interval": (0.25, 16), "autotune_max_workers": (None, 16),
    "slo_p99_ms": (500.0, 17),
    "fleet_min_replicas": (1, 17), "fleet_max_replicas": (4, 17),
    "fleet_interval": (1.0, 17),
    "admission": (False, 17), "serving_models": (None, 17),
    "scrape_targets": (None, 18), "scrape_interval": (1.0, 18),
    "scrape_stale_after": (10.0, 18), "slo_objective": (0.99, 18),
    "slo_short_window": (30.0, 18), "slo_long_window": (300.0, 18),
    "slo_burn_threshold": (1.0, 18),
    "elastic": (False, 21), "elastic_lease_ms": (3_000, 21),
    "elastic_min_workers": (1, 21), "elastic_grace_ms": (5_000, 21),
    "dcn_axis": (None, 13),
}

#: env vars outside ``ZooConfig`` that turn on an unported plane (none
#: left: ``ZOO_METRICS_PORT`` and ``ZOO_FLIGHT_DIR`` are read by the
#: ported metrics plane, ``metrics.http`` and ``metrics.flight``)
UNPORTED_ENV: dict[str, int] = {}

_ITEMS = {13: "the multi-device mesh and sharded plans",
          16: "the prefetch and autotune planes",
          17: "the serving fleet plane (fleet controller, SLO scaler, "
              "model router and admission)",
          18: "the metrics plane's federation and SLO tier (scrape "
              "targets, SLO engine, time series)",
          21: "the elastic training runtime"}


def _unported(item: int, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} turns on {_ITEMS[item]}, which the port does not have "
        f"yet (ROADMAP queue 1 item {item}); unset it")


def _refuse_unported(cfg: ZooConfig) -> None:
    """Raise for a knob of an unported plane set away from its default,
    naming its ROADMAP item: none is silently ignored."""
    for name, (off, item) in UNPORTED_KNOBS.items():
        if getattr(cfg, name) != off:
            raise _unported(item, f"ZooConfig {name}="
                            f"{getattr(cfg, name)!r}")
    for var, item in UNPORTED_ENV.items():
        if os.environ.get(var):
            raise _unported(item, var)
    shape = dict(cfg.mesh_shape or {})
    if math.prod(int(v) for v in shape.values()) > 1:
        raise _unported(13, f"ZooConfig mesh_shape={shape!r}")


@dataclasses.dataclass
class ZooContext:
    """Runtime context: the device plus engine-level knobs (``config``:
    the resolved :class:`ZooConfig`; the other fields are read from it)."""

    device: torch.device
    seed: int = 0
    # Forward math dtype (params-in-compute); None = full f32.
    compute_dtype: torch.dtype | None = None
    # ZOO_DTYPE_POLICY: a policy spec the estimator overlays on a plan that
    # has no dtype rules (None = no policy)
    dtype_policy: str | None = None
    # ZOO_STEPS_PER_DISPATCH: train steps one dispatch of fit runs (K >= 1)
    steps_per_dispatch: int = 1
    config: ZooConfig = dataclasses.field(default_factory=ZooConfig)


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


_LOCK = threading.Lock()
_CONTEXT: ZooContext | None = None  # guarded-by: _LOCK


def _device_of(device, platform):
    """The device: ``device`` > ``ZooConfig.platform`` (``"gpu"`` is
    ``cuda``) > ``cuda``."""
    if device is not None or platform is None:
        return resolve_device(device)
    name = str(platform).strip().lower()
    if name in ("gpu", "cuda"):
        return resolve_device("cuda")
    if name == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"ZooConfig platform must be 'cuda', 'gpu' or 'cpu' "
                     f"in the port, got {platform!r}")


def init_zoo_context(conf=None, *, seed: int | None = None, device=None,
                     compute_dtype=None,
                     steps_per_dispatch: int | None = None,
                     mesh_shape=None, mesh_axes=None,
                     platform: str | None = None, dcn_shape=None,
                     slice_groups=None) -> ZooContext:
    """Initialise (or re-initialise) the global runtime context.

    ``conf`` is a :class:`ZooConfig`, a dict of its fields or an app name
    (the reference's ``init_zoo_context(conf, ...)``): a dict with a key
    that is no field raises the reference's "unknown conf keys"
    ``ValueError``, and the caller's config is never mutated.  A keyword
    given here beats the conf's value, which beats the environment.
    Every env knob is resolved and validated when the config is made, and
    a knob of a plane the port does not have yet raises
    ``NotImplementedError`` naming its ROADMAP item (``ZooConfig``'s
    note); so do ``dcn_shape``/``slice_groups`` (item 13).

    ``device`` defaults to ``cuda`` and raises when no GPU is visible;
    tests pass ``device="cpu"``.  TF32 is switched off for matmuls and
    cuDNN: the reference computes in full f32 off-TPU, and the port's
    parity tolerances assume full f32.  cuDNN runs deterministic
    algorithms only (and no benchmarking): its default weight-gradient
    algorithms add atomically, so two eager ResNet-50 steps from one state
    differ, and a captured step could not be its eager step bit for bit.
    """
    global _CONTEXT
    if isinstance(conf, ZooConfig):
        cfg = dataclasses.replace(conf)  # never mutate the caller's config
        cfg._given_serving = dict(conf._given_serving)
    else:
        if isinstance(conf, str):
            conf = {"app_name": conf}
        conf = dict(conf or {})
        known = {f.name for f in dataclasses.fields(ZooConfig)}
        unknown = set(conf) - known
        if unknown:
            raise ValueError(
                f"unknown conf keys {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        cfg = ZooConfig(**conf)
    # None is "not given": an explicit keyword always wins
    if seed is not None:
        cfg.seed = int(seed)
    if mesh_shape is not None:
        cfg.mesh_shape = mesh_shape
    if mesh_axes is not None:
        cfg.mesh_axes = tuple(mesh_axes)
    if platform is not None:
        cfg.platform = platform
    if compute_dtype is not None:
        cfg.compute_dtype = compute_dtype
    if steps_per_dispatch is not None:
        given, cfg = cfg._given_serving, dataclasses.replace(
            cfg, steps_per_dispatch=steps_per_dispatch)
        cfg._given_serving = given
    if dcn_shape or slice_groups is not None:
        raise _unported(13, "dcn_shape/slice_groups")
    _refuse_unported(cfg)
    dev = _device_of(device, cfg.platform)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if cfg.compile_cache:
        from analytics_zoo_tpu_torch.common.compile_cache import (
            maybe_enable_persistent_cache,
        )
        maybe_enable_persistent_cache(cfg.compile_cache)
    ctx = ZooContext(device=dev, seed=int(cfg.seed or 0),
                     compute_dtype=_resolve_compute_dtype(cfg.compute_dtype),
                     dtype_policy=cfg.dtype_policy,
                     steps_per_dispatch=int(cfg.steps_per_dispatch),
                     config=cfg)
    with _LOCK:
        _CONTEXT = ctx
    logger.info("init_zoo_context: device %s, seed %d; TF32 off for "
                "matmul and cuDNN (full-f32 numerics), cuDNN deterministic",
                dev, ctx.seed)
    if cfg.use_pallas is False:
        logger.info("ZOO_USE_PALLAS=0: every kernel scope takes its plain "
                    "PyTorch path (the user's opt-out)")
    return ctx


def serving_knob(name: str):
    """The value the current context's ``ZooConfig`` was given for one of
    :data:`SERVING_KNOBS` (as a field or a conf entry, not through its
    env var), or None: no context yet, or the knob was not given.
    ``serving.ClusterServingHelper`` takes it over the env var and the
    default, and creates no context to ask."""
    with _LOCK:
        ctx = _CONTEXT
    return None if ctx is None else ctx.config._given_serving.get(name)


def get_zoo_context() -> ZooContext:
    """Current context, creating the default (``cuda``) one on demand."""
    with _LOCK:
        if _CONTEXT is not None:
            return _CONTEXT
    return init_zoo_context()
