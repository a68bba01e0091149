"""Plans: the kernel and precision planes on one device.

Counterpart of the single-device half of
``analytics_zoo_tpu/parallel/plan.py``, with the reference's names,
validation and error text.  A :class:`ShardingPlan` carries two ordered
rule tables:

- ``dtype_rules`` (the precision plane): ``(regex, role)`` pairs over the
  ``/``-joined leaf paths of a parameter tree
  (:func:`~analytics_zoo_tpu_torch.parallel.partition.leaf_path_name`),
  the role one of :data:`DTYPE_ROLES`.  :func:`int8_serving` marks every
  matmul-sized weight ``"int8"`` for
  ``pipeline/inference/quantize.quantize_params_for_plan``.
- ``kernel_rules`` (the kernel plane): ``(regex, kernel)`` pairs over
  logical op scopes (``"attention"``, ``"optimizer.adam"``,
  ``"loss.softmax_xent"``, ``"serving.int8_matmul"``), the kernel one of
  :data:`KERNEL_NAMES`.  Consumers ask :func:`resolve_kernel` while a plan
  is active: ``"xla"`` is the explicit opt-out (the scope takes its plain
  PyTorch path, on the card too), a kernel name routes the scope to its
  CUDA kernel, and no match (``None``) leaves the consumer's own routing in
  charge.  The port's own routing takes every training kernel on the card,
  as the JAX package does under ``ZOO_USE_PALLAS=1``; ``quantized_matmul``
  takes the int8 kernel only when a rule names it, as there.

A plan becomes active the way it does in the reference: the step function
runs under :func:`compile_step`.  Eager PyTorch has nothing to compile, so
:class:`PlannedStep` only enters the plan around each call; the timed
compile choke point waits for ROADMAP queue 1 item 12.  The sharded plans
(zero1/2/3, fsdp, ``+overlap``) and the param/opt/grad/remat tables wait
for the distribution slice (queue 1 item 13); their names raise
``NotImplementedError``.  The ``ZOO_SHARDING_PLAN``/``ZOO_DTYPE_POLICY``/
``ZOO_USE_PALLAS`` env tier waits for ``ZooConfig`` (queue 1 item 2).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading

from analytics_zoo_tpu_torch.parallel.partition import (
    leaf_path_name,
    tree_map_with_path,
)

__all__ = [
    "ShardingPlan", "data_parallel", "with_dtype", "with_dtype_policy",
    "mixed_precision", "int8_serving", "resolve_dtype_rules",
    "DTYPE_ROLES", "DTYPE_POLICY_NAMES", "COMPUTE_ROLES", "with_kernels",
    "resolve_kernel", "KERNEL_NAMES", "DEFAULT_KERNEL_RULES",
    "resolve_plan", "compile_step", "PlannedStep", "PLAN_NAMES",
]

#: names :func:`resolve_plan` knows (only the single-device ``dp`` family
#: is ported; the others raise ``NotImplementedError``)
PLAN_NAMES = ("dp", "data_parallel", "none", "fsdp", "zero1", "zero2",
              "zero3")
_SHARDED_NAMES = ("fsdp", "zero1", "zero2", "zero3")

#: dtype ROLES a plan's ``dtype_rules`` may map a path to: ``"f32"`` =
#: master precision (the default for unmatched leaves); ``"bf16"`` /
#: ``"f16"`` = a low-precision compute copy in training; ``"int8"`` =
#: weight-only quantized serving copy.
DTYPE_ROLES = ("f32", "bf16", "f16", "int8")

#: roles that change the compute dtype of a training step (the reference
#: trains an ``"int8"`` leaf in bf16); the port trains in f32 only
COMPUTE_ROLES = ("bf16", "f16", "int8")

#: canned policy names :func:`resolve_dtype_rules` accepts (besides a
#: ``<regex>=<role>,...`` rule string)
DTYPE_POLICY_NAMES = ("f32", "bf16_mixed", "int8_serving")

#: kernel names a plan's ``kernel_rules`` may map a scope to; ``"xla"`` is
#: the explicit opt-out (the scope's plain PyTorch path)
KERNEL_NAMES = ("xla", "flash", "fused_adam", "fused_softmax_xent",
                "int8_matmul")

#: the full kernel table :func:`with_kernels` applies by default
DEFAULT_KERNEL_RULES = (
    (r"^attention$", "flash"),
    (r"^optimizer\.adam$", "fused_adam"),
    (r"^loss\.softmax_xent$", "fused_softmax_xent"),
    (r"^serving\.int8_matmul$", "int8_matmul"),
)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """A named pair of rule tables: ``dtype_rules`` (the precision plane)
    and ``kernel_rules`` (the kernel plane), validated at construction."""

    name: str
    description: str = ""
    dtype_rules: tuple = ()
    kernel_rules: tuple = ()

    def __post_init__(self):
        dtyped = []
        for pat, role in self.dtype_rules:
            if role is not None and role not in DTYPE_ROLES:
                raise ValueError(
                    f"dtype rule {pat!r}: role must be one of "
                    f"{DTYPE_ROLES} (or None to keep the stored dtype), "
                    f"got {role!r}")
            dtyped.append((str(pat), role))
        object.__setattr__(self, "dtype_rules", tuple(dtyped))
        kerneled = []
        for pat, kernel in self.kernel_rules:
            if kernel is not None and kernel not in KERNEL_NAMES:
                raise ValueError(
                    f"kernel rule {pat!r}: kernel must be one of "
                    f"{KERNEL_NAMES} (or None to defer to later rules), "
                    f"got {kernel!r}")
            kerneled.append((str(pat), kernel))
        object.__setattr__(self, "kernel_rules", tuple(kerneled))

    def cache_key(self) -> tuple:
        """Hashable identity: two plans with the same rules run the same
        program."""
        return (self.name, self.dtype_rules, self.kernel_rules)

    # -- precision plane ----------------------------------------------
    def dtype_policy_str(self) -> str:
        """Canonical ``<regex>=<role>,...`` rendering of ``dtype_rules``
        (empty string = no policy); round-trips through
        :func:`resolve_dtype_rules`."""
        return ",".join(
            f"{pat}={role if role is not None else 'keep'}"
            for pat, role in self.dtype_rules)

    def dtype_roles(self, tree) -> dict:
        """Leaf path -> matched dtype role, for every non-scalar leaf a rule
        hits (first ``re.search`` wins).  Unmatched leaves are absent: they
        keep master precision."""
        out = {}

        def visit(path, leaf):
            shape = tuple(getattr(leaf, "shape", ()))
            if not shape or math.prod(shape) == 1:
                return leaf
            name = leaf_path_name(path)
            for pat, role in self.dtype_rules:
                if re.search(pat, name):
                    if role is not None:
                        out[name] = role
                    break
            return leaf

        tree_map_with_path(visit, tree)
        return out

    # -- kernel plane --------------------------------------------------
    def kernel_policy_str(self) -> str:
        """Canonical ``<regex>=<kernel>,...`` rendering of
        ``kernel_rules`` (empty string = no table)."""
        return ",".join(
            f"{pat}={kernel if kernel is not None else 'defer'}"
            for pat, kernel in self.kernel_rules)

    def kernel_for(self, scope: str, default: str | None = None):
        """Kernel name for a logical op scope: the first ``kernel_rules``
        ``re.search`` match with a kernel wins; ``"xla"`` is the explicit
        opt-out, no match returns ``default``."""
        for pat, kernel in self.kernel_rules:
            if re.search(pat, scope):
                if kernel is not None:
                    return kernel
        return default


# ---------------------------------------------------------------------------
# The active plan: entered by compile_step around each call, innermost last.
# One stack per thread, so concurrent callers (serving threads) never see
# each other's plans.
# ---------------------------------------------------------------------------

_LOCAL = threading.local()


def _plans() -> list:
    stack = getattr(_LOCAL, "plans", None)
    if stack is None:
        stack = _LOCAL.plans = []
    return stack


@contextlib.contextmanager
def _active_plan(plan: ShardingPlan):
    stack = _plans()
    stack.append(plan)
    try:
        yield plan
    finally:
        stack.pop()


def resolve_kernel(scope: str, default: str | None = None) -> str | None:
    """Kernel pick for a logical op scope under the active plan: first
    ``kernel_rules`` match on the innermost active plan that has one.
    ``"xla"`` is an explicit pick (the consumer takes its plain PyTorch
    path); no active plan or no match returns ``default`` (``None`` = the
    consumer's own routing applies).  Consumers: ``ops/attention.py``
    (``"attention"``), ``optimizers.Adam`` (``"optimizer.adam"``),
    ``objectives.py`` (``"loss.softmax_xent"``),
    ``pipeline/inference/quantize.py`` (``"serving.int8_matmul"``)."""
    for plan in reversed(_plans()):
        kernel = plan.kernel_for(scope)
        if kernel is not None:
            return kernel
    return default


# ---------------------------------------------------------------------------
# Plans and their suffixes.
# ---------------------------------------------------------------------------


def data_parallel() -> ShardingPlan:
    """The single-device plan (replicated parameters, batch over data)."""
    return ShardingPlan(
        name="dp",
        description="replicated params/opt state, batch over data")


def with_dtype(plan: ShardingPlan, role: str = "bf16",
               pattern: str = r".*") -> ShardingPlan:
    """A copy of ``plan`` with a dtype rule appended and the role in the
    name: ``with_dtype(data_parallel(), "bf16")`` -> ``"dp+bf16"``."""
    if role not in DTYPE_ROLES:
        raise ValueError(
            f"dtype role must be one of {DTYPE_ROLES}, got {role!r}")
    return dataclasses.replace(
        plan,
        name=f"{plan.name}+{role}",
        dtype_rules=plan.dtype_rules + ((str(pattern), role),))


def with_kernels(plan: ShardingPlan | str | None = None,
                 rules=DEFAULT_KERNEL_RULES) -> ShardingPlan:
    """A copy of ``plan`` with a ``kernel_rules`` table appended and
    ``+kernels`` suffixed to the name (once).  The default rules route every
    scope the port has a kernel for (:data:`DEFAULT_KERNEL_RULES`); pass a
    table to pick per scope (``(("serving.int8_matmul", "xla"),)`` keeps
    the dequantize route)."""
    plan = resolve_plan(plan)
    frozen = ShardingPlan(name="_kernel_probe",
                          kernel_rules=tuple(rules)).kernel_rules
    name = plan.name if plan.name.endswith("+kernels") \
        else f"{plan.name}+kernels"
    return dataclasses.replace(
        plan, name=name, kernel_rules=plan.kernel_rules + frozen)


def mixed_precision(plan: ShardingPlan | str | None = None) -> ShardingPlan:
    """The canned bf16 mixed-precision policy over a base plan (``dp+bf16``).
    The port's training loop refuses it for now (ROADMAP queue 1 item 22)
    rather than train in f32 under its name."""
    return with_dtype(resolve_plan(plan), "bf16")


def int8_serving(plan: ShardingPlan | str | None = None) -> ShardingPlan:
    """The weight-only int8 serving policy: every matmul-sized weight
    carries the ``"int8"`` role, and ``quantize_params_for_plan`` quantizes
    exactly those leaves."""
    return with_dtype(resolve_plan(plan), "int8")


def resolve_dtype_rules(value) -> tuple:
    """``dtype_rules`` from a policy spec: ``None``/``""``/``"f32"`` -> no
    rules, ``"bf16_mixed"`` -> catch-all bf16, ``"int8_serving"`` ->
    catch-all int8, a ``<regex>=<role>,...`` rule string -> that table
    (role ``keep``/``none`` pins a path to its stored dtype), or a rule
    sequence (validated).  ``"auto"`` is rejected, as in the reference."""
    if value is None:
        return ()
    if isinstance(value, (tuple, list)):
        return ShardingPlan(name="_dtype_probe",
                            dtype_rules=tuple(value)).dtype_rules
    name = str(value).strip()
    low = name.lower()
    if low in ("", "f32", "none"):
        return ()
    if low == "bf16_mixed":
        return ((r".*", "bf16"),)
    if low == "int8_serving":
        return ((r".*", "int8"),)
    if low == "auto":
        raise ValueError(
            'dtype policy "auto" is resolved by the config oracle, which '
            "is not ported yet (ROADMAP queue 1 item 19); pass a concrete "
            "policy here")
    rules = []
    for part in name.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"dtype policy rule {part!r} must be '<regex>=<role>' "
                f"with role in {DTYPE_ROLES} (or a policy name from "
                f"{DTYPE_POLICY_NAMES})")
        pat, role = part.rsplit("=", 1)
        role = role.strip().lower()
        if role in ("keep", "none"):
            role = None
        elif role not in DTYPE_ROLES:
            raise ValueError(
                f"dtype policy rule {part!r}: role must be one of "
                f"{DTYPE_ROLES} (or 'keep'), got {role!r}")
        rules.append((pat.strip(), role))
    return tuple(rules)


def with_dtype_policy(plan: ShardingPlan, policy) -> ShardingPlan:
    """Apply a dtype policy spec (anything :func:`resolve_dtype_rules`
    accepts) to ``plan``: no-op for ``None``/``"f32"``; otherwise the rules
    are appended and the first concrete role suffixes the name."""
    rules = resolve_dtype_rules(policy)
    if not rules:
        return plan
    roles = [role for _, role in rules if role is not None]
    name = f"{plan.name}+{roles[0]}" if roles else plan.name
    return dataclasses.replace(
        plan, name=name, dtype_rules=plan.dtype_rules + rules)


def resolve_plan(value=None) -> ShardingPlan:
    """A plan argument: a :class:`ShardingPlan` passes through, ``None`` is
    :func:`data_parallel`, and a name maps to its plan.  Suffixes strip in
    the reverse of construction order: ``+kernels``, then a dtype role,
    then ``+overlap`` (``"dp+int8+kernels"``)."""
    if isinstance(value, ShardingPlan):
        return value
    if value is None:
        return data_parallel()
    name = str(value).strip().lower()
    if name == "auto":
        raise ValueError(
            'plan="auto" is resolved by the config oracle, which is not '
            "ported yet (ROADMAP queue 1 item 19); pass a concrete plan or "
            "name here")
    kernels = False
    if name.endswith("+kernels"):
        kernels = True
        name = name[: -len("+kernels")]
    dtype_role = None
    for role in DTYPE_ROLES:
        if name.endswith("+" + role):
            dtype_role = role
            name = name[: -len(role) - 1]
            break
    overlap = False
    if name.endswith("+overlap"):
        overlap = True
        name = name[: -len("+overlap")]
    if name in _SHARDED_NAMES:
        raise NotImplementedError(
            f"sharding plan {value!r} is not ported yet: the sharded plans "
            "(zero1/zero2/zero3/fsdp, +overlap) wait for the distribution "
            "slice (ROADMAP queue 1 item 13); the port runs on one device "
            "under 'dp'")
    if name not in ("dp", "data_parallel", "none", ""):
        raise ValueError(
            f"unknown sharding plan {value!r}; valid names: "
            f"{', '.join(PLAN_NAMES)}, optionally suffixed +overlap, "
            f"a dtype role and/or +kernels (e.g. 'fsdp+overlap', "
            f"'zero1+bf16', 'dp+kernels')")
    if overlap:
        raise ValueError(
            "dp has no collectives to overlap; bucket_bytes applies "
            "to zero1/zero2/zero3/fsdp")
    plan = data_parallel()
    if dtype_role not in (None, "f32"):
        plan = with_dtype(plan, dtype_role)
    return with_kernels(plan) if kernels else plan


class PlannedStep:
    """A step function bound to a plan: each call runs under it, so
    :func:`resolve_kernel` inside sees the plan's rule tables."""

    def __init__(self, fn, label: str, plan: ShardingPlan):
        self.fn = fn
        self.label = label
        self.plan = plan

    def __call__(self, *args, **kwargs):
        with _active_plan(self.plan):
            return self.fn(*args, **kwargs)


def compile_step(step_fn, plan: ShardingPlan | str | None = None, *,
                 label: str | None = None) -> PlannedStep:
    """``step_fn`` under ``plan`` (resolved by :func:`resolve_plan`), as a
    callable; ``label`` names the program (default ``<plan.name>_step``)."""
    plan = resolve_plan(plan)
    return PlannedStep(step_fn, label or f"{plan.name}_step", plan)
