"""Plans: the kernel and precision planes on one device.

Counterpart of the single-device half of
``analytics_zoo_tpu/parallel/plan.py``, with the reference's names,
validation and error text.  A :class:`ShardingPlan` carries two ordered
rule tables:

- ``dtype_rules`` (the precision plane): ``(regex, role)`` pairs over the
  ``/``-joined leaf paths of a parameter tree
  (:func:`~analytics_zoo_tpu_torch.parallel.partition.leaf_path_name`),
  the role one of :data:`DTYPE_ROLES`.  In training,
  :meth:`ShardingPlan.cast_params_for_compute` makes the step's compute
  copy of the f32 masters (``bf16``/``f16``, and bf16 for an ``int8``
  leaf) and :meth:`ShardingPlan.compute_cast_dtype` is what the batch
  casts to; :func:`int8_serving` marks every matmul-sized weight
  ``"int8"`` for ``pipeline/inference/quantize.quantize_params_for_plan``.
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
runs under :func:`compile_step`, the compile plane's choke point: on the
card :class:`PlannedStep` captures the step into a CUDA graph per input
signature and replays it, timed and counted by
``common.compile_cache``.  The sharded plans
(zero1/2/3, fsdp, ``+overlap``) and the param/opt/grad/remat tables wait
for the distribution slice (queue 1 item 13); their names raise
``NotImplementedError``.  ``ZOO_DTYPE_POLICY`` is read by
``common.engine.init_zoo_context`` and overlaid by the estimator; the
``ZOO_SHARDING_PLAN``/``ZOO_USE_PALLAS`` env tier waits for ``ZooConfig``
(queue 1 item 2).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading

import torch

from analytics_zoo_tpu_torch.common.utils import tree_map, tree_map_many
from analytics_zoo_tpu_torch.parallel.partition import (
    leaf_path_name,
    match_rule_values,
    tree_map_with_path,
)

__all__ = [
    "ShardingPlan", "data_parallel", "with_dtype", "with_dtype_policy",
    "mixed_precision", "int8_serving", "resolve_dtype_rules",
    "DTYPE_ROLES", "DTYPE_POLICY_NAMES", "with_kernels",
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

#: the compute dtype each role casts a floating leaf to inside the train
#: and eval steps (``None``: the stored dtype; ``None`` as a role is a
#: ``keep`` rule).  An ``"int8"`` leaf trains in bf16: int8 is a
#: weight-only serving transform, not a training number format.
_ROLE_COMPUTE_DTYPES = {"f32": None, None: None, "bf16": torch.bfloat16,
                        "f16": torch.float16, "int8": torch.bfloat16}

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
        keep master precision, as do leaves a ``keep`` rule pins."""
        out = {}

        def visit(path, role):
            if role is not None:
                out[leaf_path_name(path)] = role

        tree_map_with_path(visit, match_rule_values(self.dtype_rules, tree))
        return out

    def compute_cast_dtype(self):
        """The first low-precision compute dtype this plan's rules declare
        (``torch.bfloat16`` / ``torch.float16``), or ``None`` for a pure
        f32 plan: what the batch's floating inputs cast to, so the
        matmuls run in the compute dtype."""
        for _, role in self.dtype_rules:
            dtype = _ROLE_COMPUTE_DTYPES.get(role)
            if dtype is not None:
                return dtype
        return None

    def compute_dtypes(self, params):
        """Each leaf's compute dtype under the dtype rules, as a tree of
        ``params``' structure (``None``: the leaf stays as stored).  It
        depends on the tree's structure alone, so a loop works it out once
        and casts every step with :func:`cast_to_compute`."""
        roles = match_rule_values(self.dtype_rules, params, default="f32")
        return tree_map(_ROLE_COMPUTE_DTYPES.get, roles)

    def cast_params_for_compute(self, params):
        """A compute copy of ``params``: each floating leaf whose role has
        a compute dtype (``bf16``, ``f16``, ``int8`` -> bf16) cast to it,
        every other leaf (f32 or ``keep`` roles, scalars, integers) as it
        is.  ``params`` stays the f32 master the optimizer updates; cast
        where autograd records it, the cast's backward returns f32
        gradients to the masters."""
        if not self.dtype_rules:
            return params
        return cast_to_compute(params, self.compute_dtypes(params))

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


def cast_to_compute(params, dtypes):
    """``params`` with each floating tensor leaf cast to its entry of
    ``dtypes`` (a tree from :meth:`ShardingPlan.compute_dtypes`; ``None``
    leaves it as it is)."""
    def cast(leaf, dtype):
        if dtype is None or not torch.is_tensor(leaf) \
                or not leaf.is_floating_point():
            return leaf
        return leaf.to(dtype)

    return tree_map_many(cast, params, dtypes)


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
    """The canned bf16 mixed-precision policy over a base plan
    (``dp+bf16``): bf16 compute copies of the f32 masters, made on use
    inside the step, with f32 gradients and f32 optimizer state."""
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


def _leaves(tree, out: list) -> list:
    """The leaves of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    """``tree``'s structure (named tuples kept) with leaves from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    if isinstance(tree, tuple):
        vals = [_rebuild(v, it) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return next(it)


_BY_VALUE = (bool, int, float, str, type(None), torch.dtype, torch.device)


def _sig(tree):
    """The signature of a nest: its structure, each tensor's shape, dtype
    and device, a step's random keys by the randomness they draw from,
    python scalars (and dtypes, devices) by value: a graph bakes them as
    constants, so another value is another program.  Any other leaf keys
    on its type, as in the reference."""
    from analytics_zoo_tpu_torch.common.engine import StepKeys

    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _sig(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_sig(v) for v in tree)
    if torch.is_tensor(tree):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, StepKeys):
        return ("keys", id(tree.source))
    if isinstance(tree, _BY_VALUE):
        return (type(tree), tree)
    return (type(tree),)


def _same_buffer(a, b) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride())


class _Capture:
    """One signature's CUDA graph: its static inputs (the leaves of the
    arguments it was captured on), its outputs, the kernel counters its
    capture moved, and the randomness state (``common.engine.SiteState``)
    of each random-key input, which it reseeds before a replay."""

    def __init__(self, graph, static, outputs, counts, states):
        self.graph, self.static = graph, static
        self.outputs, self.counts = outputs, counts
        self.states = states  # static position -> SiteState

    def replay(self, call):
        """Copy ``call``'s tensors into the static inputs (a tensor that is
        its static input already stays), reseed the random keys, replay,
        and count the capture's kernel launches once more."""
        from analytics_zoo_tpu_torch.common.engine import StepKeys
        from analytics_zoo_tpu_torch.ops.cuda import add_counters

        for i, (new, static) in enumerate(zip(_leaves(call, []),
                                              self.static)):
            if torch.is_tensor(static):
                if not _same_buffer(new, static):
                    static.copy_(new)
            elif isinstance(static, StepKeys):
                new.source.reseed(new, self.states[i])
        self.graph.replay()
        add_counters(self.counts)
        return self.outputs


class PlannedStep:
    """A step function bound to a plan, through the compile plane's choke
    point (the reference's ``PlannedStep``, parallel/plan.py:1190-1300).

    Each call runs under the plan, so :func:`resolve_kernel` inside sees
    its rule tables.  Calls are cached by input signature (:func:`_sig`;
    at most ``_MAX_EXES``, the oldest evicted).  The first call for a
    signature is a miss, timed under ``label`` by
    ``common.compile_cache.timed_compile``; later ones are hits.

    On the card (a CUDA tensor among the inputs, ``capture`` on) the first
    call runs the function eagerly on a side stream (the capture's
    warm-up: cuBLAS, the kernel libraries, the sites of the step's
    randomness), then captures it into a ``torch.cuda.CUDAGraph`` on that
    stream, and returns the eager run's result.  Its static inputs are the
    arguments of that call: a donated argument (``donate_argnums``, which
    the function updates in place, as the reference's donated buffers) as
    it is, any other tensor as a copy.  A later call copies each tensor
    argument into its static input, unless it is that buffer already,
    reseeds the step's random keys (``common.engine.StepKeys``: their
    generators are registered with the graph), replays, and returns the
    capture's outputs, which the next replay overwrites.  A replay runs no
    Python, so the kernel counters' moves during the capture are put back
    and added again on every replay.  A capture that fails raises: nothing
    runs the step eagerly on the card instead.  On the CPU, or with
    ``capture`` off (the eval step), every call runs eagerly.
    """

    _MAX_EXES = 32  # signature churn bound; the oldest is evicted

    def __init__(self, fn, label: str, plan: ShardingPlan,
                 donate_argnums=(), capture: bool = True):
        self.fn = fn
        self.label = label
        self.plan = plan
        self.donate_argnums = tuple(donate_argnums)
        self.capture = capture
        self._exes: dict = {}  # signature -> _Capture, or None (eager)

    def __call__(self, *args, **kwargs):
        from analytics_zoo_tpu_torch.common.compile_cache import (
            record,
            timed_compile,
        )

        call = (args, kwargs)
        key = _sig(call)
        if key in self._exes:
            record(self.label, hit=True)
            exe = self._exes[key]
            if exe is not None:
                return exe.replay(call)
            with _active_plan(self.plan):
                return self.fn(*args, **kwargs)
        cuda = self.capture and any(
            torch.is_tensor(t) and t.device.type == "cuda"
            for t in _leaves(call, []))
        if cuda:
            exe, out = timed_compile(lambda: self._capture(call), self.label)
        else:
            exe = None
            with _active_plan(self.plan):
                out = timed_compile(lambda: self.fn(*args, **kwargs),
                                    self.label)
        while len(self._exes) >= self._MAX_EXES:
            self._exes.pop(next(iter(self._exes)))
        self._exes[key] = exe
        return out

    def _capture(self, call):
        """The eager run and the capture of a new signature (``call`` is
        (args, kwargs)): (its :class:`_Capture`, the eager run's result)."""
        from analytics_zoo_tpu_torch.common.engine import StepKeys
        from analytics_zoo_tpu_torch.ops.cuda import (
            add_counters,
            counter_delta,
            counter_snapshot,
        )

        args, kwargs = call
        static = []
        for i, arg in enumerate(list(args) + list(kwargs.values())):
            for leaf in _leaves(arg, []):
                copy = torch.is_tensor(leaf) and i not in self.donate_argnums
                static.append(leaf.clone() if copy else leaf)
        static_args, static_kwargs = _rebuild(call, iter(static))
        device = next(t.device for t in static
                      if torch.is_tensor(t) and t.device.type == "cuda")
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side), _active_plan(self.plan):
            eager = self.fn(*static_args, **static_kwargs)
        graph = torch.cuda.CUDAGraph()
        states = {i: k.source.prepare_capture(k)
                  for i, k in enumerate(static) if isinstance(k, StepKeys)}
        for state in states.values():
            for gen in state.generators():
                graph.register_generator_state(gen)
        before = counter_snapshot()
        with contextlib.ExitStack() as stack:
            for i, state in states.items():
                stack.enter_context(static[i].source.capturing(state))
            stack.enter_context(_active_plan(self.plan))
            stack.enter_context(torch.cuda.graph(graph, stream=side))
            outputs = self.fn(*static_args, **static_kwargs)
        counts = counter_delta(before, counter_snapshot())
        add_counters(counts, -1)  # the capture launched nothing
        main.wait_stream(side)
        return _Capture(graph, static, outputs, counts, states), eager


def compile_step(step_fn, plan: ShardingPlan | str | None = None, *,
                 label: str | None = None, donate_argnums=(),
                 capture: bool = True) -> PlannedStep:
    """``step_fn`` under ``plan`` (resolved by :func:`resolve_plan`)
    through the compile plane's choke point, as a callable
    (:class:`PlannedStep`): captured into a CUDA graph on the card unless
    ``capture`` is off.  ``label`` names the program (default
    ``<plan.name>_step``); ``donate_argnums`` are the arguments the step
    updates in place."""
    plan = resolve_plan(plan)
    return PlannedStep(step_fn, label or f"{plan.name}_step", plan,
                       donate_argnums=donate_argnums, capture=capture)
