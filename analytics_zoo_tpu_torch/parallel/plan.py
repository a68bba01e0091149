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
``common.compile_cache``: the train step (its parameters donated), the
eval step, ``KerasNet.predict`` and ``InferenceModel``'s bucket forwards
(their parameters and state passed by reference; the steps of one
:class:`CaptureGroup` replay one at a time and share a memory pool).
The sharded plans (zero1/2/3, fsdp, ``+overlap``) and the
param/opt/grad/remat tables wait for the distribution slice (queue 1
item 13); their names raise ``NotImplementedError``.  Without a
``remat_rules`` table, :func:`resolve_remat` returns the layer's own
``remat=`` flag, and :func:`apply_remat` is the one remat site.
The env tier comes from ``common.engine.ZooConfig``: ``resolve_plan(None,
config)`` takes ``ZOO_SHARDING_PLAN`` (or ``ZOO_SHARD_OPTIMIZER``'s zero1),
with the same names, suffixes and raises as an explicit name;
``ZOO_DTYPE_POLICY`` is overlaid by the estimator, and an explicit
``ZOO_USE_PALLAS=0`` by :func:`kernels_off` (the user's opt-out: every
scope takes its plain PyTorch path).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import re
import threading

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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
    "resolve_plan", "compile_step", "PlannedStep", "CaptureGroup",
    "PLAN_NAMES", "kernels_off", "REMAT_POLICIES", "apply_remat",
    "resolve_remat", "checkpoint_name", "KERNEL_SCOPES",
    "record_dtype_gauges", "record_kernel_gauges",
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
# Rematerialisation: the one checkpoint site.
# ---------------------------------------------------------------------------

#: the remat policies :func:`apply_remat` takes (besides None)
REMAT_POLICIES = ("full", "dots", "attn")

_NAMING = threading.local()  # the names checkpoint_name marks, per thread


@torch.library.custom_op("zoo_torch::checkpoint_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_named.register_fake
def _named_fake(x, name):
    return torch.empty_like(x)


_named.register_autograd(lambda ctx, grad: (grad, None))


def checkpoint_name(x, name: str):
    """``x`` tagged ``name`` for :func:`apply_remat`'s ``"attn"`` policy
    (``jax.ad_checkpoint.checkpoint_name``): inside such a region, a copy
    the policy keeps for the backward; anywhere else ``x`` itself."""
    if name in getattr(_NAMING, "names", ()):
        return _named(x, name)
    return x


@contextlib.contextmanager
def _region(plans, names):
    """Run a remat region with ``plans`` as the active plans and ``names``
    marked: its recompute runs on the autograd engine's thread, which
    must see the forward's kernel routing."""
    stack = _plans()
    saved, saved_names = stack[:], getattr(_NAMING, "names", ())
    stack[:] = plans
    _NAMING.names = names
    try:
        yield
    finally:
        stack[:] = saved
        _NAMING.names = saved_names


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    # jax's dots_with_no_batch_dims_saveable: 2-D products (a 3-D @ 2-D
    # matmul reaches here as mm), not the batched einsums
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _save_attn(ctx, op, *args, **kwargs):
    if op is torch.ops.zoo_torch.checkpoint_name.default \
            and args[1] == "attn_context":
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SAVE = {"dots": _save_dots, "attn": _save_attn}


def resolve_remat(path: str, default: str | None = None) -> str | None:
    """The remat policy of a logical scope (a layer name): the plans'
    ``remat_rules`` wait for item 13, so it is the layer's own flag,
    ``default``."""
    del path
    return default


def apply_remat(fn, policy: str | None, *, static_argnums=()):
    """``fn`` rematerialised under a named policy: the one remat site.

    ``None`` returns ``fn``; ``"full"`` recomputes the whole region in the
    backward (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` keeps
    the outputs of 2-D matrix products and recomputes the rest, and
    ``"attn"`` keeps only the tensors tagged ``checkpoint_name(...,
    "attn_context")`` (selective checkpointing); any other name raises the
    reference's ``ValueError``.  Non-tensor arguments pass through as they
    are, so ``static_argnums`` has nothing to do.

    The recompute must draw the forward's dropout masks.  The port's
    dropout draws from explicit generators derived from the step's key by
    ``fold_in`` (in a captured step, from ``StepRandomness``), never from
    the default generators, so ``preserve_rng_state`` is off: a recompute
    asks for the same key again and gets a generator seeded alike (eagerly
    a fresh one; in a capture its own registered generator, reseeded with
    the same seed before each replay), and the flash kernel the same seed
    pair.  The active plans are re-entered in the recompute, which runs
    on the autograd engine's thread."""
    del static_argnums
    if policy in (None, "", "none"):
        return fn
    if policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}; expected one of "
            f"{REMAT_POLICIES} or a jax.checkpoint_policies attribute name")
    names = ("attn_context",) if policy == "attn" else ()
    kw = {}
    if policy in _SAVE:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _SAVE[policy])

    def remat(*args):
        plans = tuple(_plans())

        def region(*a):
            with _region(plans, names):
                return fn(*a)

        return checkpoint(region, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return remat


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


def kernels_off(plan: ShardingPlan) -> ShardingPlan:
    """``plan`` with every scope on its plain PyTorch path (the ``"xla"``
    rule), unless it has kernel rules of its own (explicit beats the
    environment): the env tier of an explicit ``ZOO_USE_PALLAS=0``."""
    if plan.kernel_rules:
        return plan
    return dataclasses.replace(plan, kernel_rules=((r".*", "xla"),))


def resolve_plan(value=None, config=None) -> ShardingPlan:
    """A plan argument: a :class:`ShardingPlan` passes through, and a name
    maps to its plan.  ``None`` defers to ``config``'s env tier (a
    ``common.engine.ZooConfig``: ``sharding_plan``, then the legacy
    ``shard_optimizer`` flag as ``"zero1"``), then :func:`data_parallel`.
    Suffixes strip in the reverse of construction order: ``+kernels``,
    then a dtype role, then ``+overlap`` (``"dp+int8+kernels"``)."""
    if isinstance(value, ShardingPlan):
        return value
    if value is None and config is not None:
        value = config.sharding_plan or (
            "zero1" if config.shard_optimizer else None)
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


def _sig(tree, ref: bool = False):
    """The signature of a nest: its structure, each tensor's shape, dtype
    and device, a step's random keys by the randomness they draw from,
    python scalars (and dtypes, devices) by value: a graph bakes them as
    constants, so another value is another program.  Any other leaf keys
    on its type, as in the reference.  In an argument passed by reference
    (``ref``) a tensor keys on its identity and its address, and any other
    leaf that is not a value (a ``QuantizedTensor``) on its identity: the
    capture reads those buffers where they are, so other buffers are
    another capture (and the capture holds the objects, so their
    identities are not reused while it lives)."""
    from analytics_zoo_tpu_torch.common.engine import StepKeys

    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _sig(v, ref)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_sig(v, ref) for v in tree)
    if torch.is_tensor(tree):
        if ref:
            return ("ref", id(tree), tree.data_ptr())
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, StepKeys):
        return ("keys", id(tree.source))
    if isinstance(tree, _BY_VALUE):
        return (type(tree), tree)
    return ("ref", id(tree)) if ref else (type(tree),)


def _same_buffer(a, b) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride())


def _static_leaves(args, kwargs, donate_argnums, ref_argnums) -> list:
    """The static inputs a capture of ``(args, kwargs)`` reads, as one list
    of leaves per argument: a donated or by-reference argument's tensors
    as they are, every other tensor as a copy (made outside inference
    mode, so that a later replay can copy into it), any other leaf as it
    is."""
    keep = set(donate_argnums) | set(ref_argnums)
    with torch.inference_mode(False):
        return [[leaf.clone() if torch.is_tensor(leaf) and i not in keep
                 else leaf for leaf in _leaves(arg, [])]
                for i, arg in enumerate(list(args) + list(kwargs.values()))]


#: held by every capture in the process, whatever its group: entering a
#: capture synchronizes the device (``torch.cuda.graph``), and a device-wide
#: synchronize while another thread's capture is underway is refused and
#: ends that capture.  Replays of other groups go on during a capture.
_CAPTURE_LOCK = threading.RLock()


class CaptureGroup:
    """Captures that run one at a time: one lock, which a caller holds from
    the copy into a capture's static inputs until it has read the outputs
    (the next replay overwrites them), and one CUDA graph memory pool for
    all of them, captured on one side stream (the caching allocator hands
    a freed block only to allocations on the stream it was freed on).
    Sharing the pool is safe because of the lock: a replay may reuse
    memory another capture's replay used for its intermediates, or for
    outputs that its caller has read."""

    def __init__(self):
        self.lock = threading.RLock()
        self._pool = self._stream = None  # guarded-by: lock

    def pool(self):
        """The pool's handle, made on the group's first capture."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def stream(self, device):
        """The side stream the group's captures run on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream


class _Capture:
    """One signature's CUDA graph: its static inputs (the leaves of the
    arguments it was captured on, a list for each argument), the arguments
    it reads by reference, its outputs, the kernel counters its capture
    moved, and the randomness state (``common.engine.SiteState``) of each
    random-key input, which it reseeds before a replay."""

    def __init__(self, graph, static, refs, outputs, counts, states):
        self.graph, self.static, self.refs = graph, static, refs
        self.outputs, self.counts = outputs, counts
        self.states = states  # (argument, leaf) -> SiteState

    def replay(self, call):
        """Copy ``call``'s tensors into the static inputs (a tensor that is
        its static input already stays; the by-reference arguments are
        theirs, as the signature says), reseed the random keys, replay, and
        count the capture's kernel launches once more."""
        from analytics_zoo_tpu_torch.common.engine import StepKeys
        from analytics_zoo_tpu_torch.ops.cuda import add_counters

        args, kwargs = call
        for i, arg in enumerate(list(args) + list(kwargs.values())):
            if i in self.refs:
                continue
            for j, (new, static) in enumerate(zip(_leaves(arg, []),
                                                  self.static[i])):
                if torch.is_tensor(static):
                    if not _same_buffer(new, static):
                        static.copy_(new)
                elif isinstance(static, StepKeys):
                    new.source.reseed(new, self.states[i, j])
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
    the function updates in place, as the reference's donated buffers) or
    one passed by reference (``ref_argnums``: parameters and model state,
    which the graph reads where they are; other buffers are another
    signature) as it is, any other tensor as a copy.  A later call copies
    each tensor argument into its static input, unless it is that buffer
    already, reseeds the step's random keys (``common.engine.StepKeys``:
    their generators are registered with the graph), replays, and returns
    the capture's outputs.  A replay runs no Python, so the kernel
    counters' moves during the capture are put back and added again on
    every replay.  A capture that fails raises: nothing runs the step
    eagerly on the card instead.  On the CPU, or with ``capture`` off,
    every call runs eagerly.

    The next replay overwrites the outputs, so the steps of one
    :class:`CaptureGroup` (``group``; by default one of the step's own)
    run one at a time and share its memory pool: each call holds the
    group's lock (``lock``), and so do the capture of a new signature
    (two callers that miss on one signature capture it once) and the
    eviction of an old one.  A caller that shares the step with other
    threads holds ``lock`` itself until it has read the outputs.
    """

    _MAX_EXES = 32  # signature churn bound; the oldest is evicted

    def __init__(self, fn, label: str, plan: ShardingPlan,
                 donate_argnums=(), ref_argnums=(), capture: bool = True,
                 group: CaptureGroup | None = None):
        self.fn = fn
        self.label = label
        self.plan = plan
        self.donate_argnums = tuple(donate_argnums)
        self.ref_argnums = tuple(ref_argnums)
        self.capture = capture
        self.group = group or CaptureGroup()
        self._exes: dict = {}  # guarded-by: lock -- signature -> _Capture
        # or None (eager)

    @property
    def lock(self):
        """The lock of the step's capture group (re-entrant)."""
        return self.group.lock

    def _key(self, args, kwargs):
        return (tuple(_sig(a, i in self.ref_argnums)
                      for i, a in enumerate(args)), _sig(kwargs))

    def __call__(self, *args, **kwargs):
        from analytics_zoo_tpu_torch.common.compile_cache import (
            record,
            timed_compile,
        )

        call = (args, kwargs)
        key = self._key(args, kwargs)
        with self.lock:
            hit = key in self._exes
            if hit:
                record(self.label, hit=True)
                exe = self._exes[key]
                if exe is not None:
                    return exe.replay(call)
            elif self.capture and any(
                    torch.is_tensor(t) and t.device.type == "cuda"
                    for t in _leaves(call, [])):
                with _CAPTURE_LOCK:  # one capture at a time in the process
                    exe, out = timed_compile(lambda: self._capture(call),
                                             self.label)
                self._remember(key, exe)
                return out
        # eager: the CPU, or capture off
        with _active_plan(self.plan):
            if hit:
                return self.fn(*args, **kwargs)
            out = timed_compile(lambda: self.fn(*args, **kwargs),
                                self.label)
        with self.lock:
            self._remember(key, None)
        return out

    def _remember(self, key, exe) -> None:
        while key not in self._exes and len(self._exes) >= self._MAX_EXES:
            self._exes.pop(next(iter(self._exes)))
        self._exes[key] = exe

    def static_inputs(self, *args, **kwargs):
        """The (args, kwargs) the capture of this call's signature reads
        (the copied arguments' static buffers, by-reference and donated
        ones as they are), or None where there is no capture (the CPU,
        ``capture`` off, or no call of the signature yet).  A caller may
        write the next call's inputs straight into them, holding
        ``lock`` until it has read that call's outputs."""
        with self.lock:
            exe = self._exes.get(self._key(args, kwargs))
        if exe is None:
            return None
        return _rebuild((args, kwargs),
                        iter([leaf for arg in exe.static for leaf in arg]))

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
        static = _static_leaves(args, kwargs, self.donate_argnums,
                                self.ref_argnums)
        leaves = [leaf for arg in static for leaf in arg]
        static_args, static_kwargs = _rebuild(call, iter(leaves))
        device = next(t.device for t in leaves
                      if torch.is_tensor(t) and t.device.type == "cuda")
        main = torch.cuda.current_stream(device)
        side = self.group.stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side), _active_plan(self.plan):
            eager = self.fn(*static_args, **static_kwargs)
        graph = torch.cuda.CUDAGraph()
        states = {(i, j): k.source.prepare_capture(k)
                  for i, arg in enumerate(static)
                  for j, k in enumerate(arg) if isinstance(k, StepKeys)}
        for state in states.values():
            for gen in state.generators():
                graph.register_generator_state(gen)
        before = counter_snapshot()
        with contextlib.ExitStack() as stack:
            # a graph the garbage collector frees during a capture (one in
            # a reference cycle, as a step's own captures are) ends the
            # capture: collect first, and not again until it is over
            gc.collect()
            if gc.isenabled():
                gc.disable()
                stack.callback(gc.enable)
            for (i, j), state in states.items():
                stack.enter_context(static[i][j].source.capturing(state))
            stack.enter_context(_active_plan(self.plan))
            # thread_local: the fit's infeed thread (pinned staging) and
            # checkpoint writer (its own stream's copies) run on during a
            # capture; only this thread's calls are checked
            stack.enter_context(torch.cuda.graph(
                graph, pool=self.group.pool(), stream=side,
                capture_error_mode="thread_local"))
            outputs = self.fn(*static_args, **static_kwargs)
        counts = counter_delta(before, counter_snapshot())
        add_counters(counts, -1)  # the capture launched nothing
        main.wait_stream(side)
        return _Capture(graph, static, set(self.ref_argnums), outputs,
                        counts, states), eager


def host_bound(model) -> bool:
    """Whether ``model`` holds a layer that runs on the host (one with
    ``host_round_trip``, as ``TFNet``), nested containers included: a
    host round trip cannot sit inside a CUDA graph."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer

    seen = set()

    def visit(layer) -> bool:
        if id(layer) in seen:
            return False
        seen.add(id(layer))
        if getattr(layer, "host_round_trip", False):
            return True
        inner = getattr(layer, "layers", None) or ()
        return any(visit(ly) for ly in inner if isinstance(ly, Layer))

    return visit(model)


def step_options(model, label: str) -> dict:
    """``compile_step``'s ``label`` and ``capture`` for a step of
    ``model``: a host-bound model's steps run uncaptured, under the label
    with ``_host`` appended, so ``compile_stats`` says so."""
    if host_bound(model):
        return {"label": f"{label}_host", "capture": False}
    return {"label": label}


def compile_step(step_fn, plan: ShardingPlan | str | None = None, *,
                 label: str | None = None, donate_argnums=(),
                 ref_argnums=(), capture: bool = True,
                 group: CaptureGroup | None = None) -> PlannedStep:
    """``step_fn`` under ``plan`` (resolved by :func:`resolve_plan`)
    through the compile plane's choke point, as a callable
    (:class:`PlannedStep`): captured into a CUDA graph on the card unless
    ``capture`` is off.  ``label`` names the program (default
    ``<plan.name>_step``); ``donate_argnums`` are the arguments the step
    updates in place, ``ref_argnums`` those it reads in place (never
    copied), and ``group`` the :class:`CaptureGroup` whose lock and pool
    the step's captures share."""
    plan = resolve_plan(plan)
    return PlannedStep(step_fn, label or f"{plan.name}_step", plan,
                       donate_argnums=donate_argnums,
                       ref_argnums=ref_argnums, capture=capture, group=group)


# ---------------------------------------------------------------------------
# The planes' gauges (the reference's ``zoo_dtype_*`` and ``zoo_kernel_*``)
# ---------------------------------------------------------------------------

#: the logical op scopes the kernel plane routes (consumers listed in
#: :func:`resolve_kernel`) — what :func:`record_kernel_gauges` resolves a
#: plan's table against
KERNEL_SCOPES = ("attention", "optimizer.adam", "loss.softmax_xent",
                 "serving.int8_matmul")

_ROLE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "int8": 1}


def record_dtype_gauges(label: str, plan: ShardingPlan, params) -> dict:
    """Publish the ``zoo_dtype_*`` gauge family for one plan label — the
    precision plane's observable: per-role leaf counts and COMPUTE bytes
    (what the role's compute dtype makes the leaf weigh in the step —
    bf16 halves, int8 quarters; role ``f32`` counts every unmatched/kept
    leaf at its stored size).  Returns ``{"roles": {role: {"leaves",
    "compute_bytes"}}, "master_bytes", "compute_bytes"}``; the
    reference's families, help strings and labels."""
    from analytics_zoo_tpu_torch.metrics import get_registry

    roles = plan.dtype_roles(params)
    per_role: dict = {}
    master_bytes = compute_bytes = 0

    def visit(path, leaf):
        nonlocal master_bytes, compute_bytes
        if not torch.is_tensor(leaf):
            return leaf
        role = roles.get(leaf_path_name(path), "f32")
        size = leaf.numel()
        stored = size * leaf.element_size()
        comp = size * _ROLE_BYTES.get(role, 4) if role != "f32" else stored
        slot = per_role.setdefault(role, {"leaves": 0, "compute_bytes": 0})
        slot["leaves"] += 1
        slot["compute_bytes"] += comp
        master_bytes += stored
        compute_bytes += comp
        return leaf

    tree_map_with_path(visit, params)
    reg = get_registry()
    for role, slot in per_role.items():
        lab = ("label", "role")
        reg.gauge("zoo_dtype_leaves",
                  "param leaves per dtype role under a plan's "
                  "dtype_rules", lab).labels(
            label=label, role=role).set(slot["leaves"])
        reg.gauge("zoo_dtype_compute_bytes",
                  "compute-copy bytes per dtype role (master stays f32)",
                  lab).labels(
            label=label, role=role).set(slot["compute_bytes"])
    reg.gauge("zoo_dtype_bytes_ratio",
              "compute-copy bytes / master bytes for a plan label",
              ("label",)).labels(label=label).set(
        compute_bytes / master_bytes if master_bytes else 1.0)
    return {"roles": per_role, "master_bytes": int(master_bytes),
            "compute_bytes": int(compute_bytes)}


def record_kernel_gauges(label: str, plan: ShardingPlan) -> dict:
    """Publish the ``zoo_kernel_*`` selection/routing gauges for one plan
    label — the kernel plane's observable (the twin of
    :func:`record_dtype_gauges`): ``zoo_kernel_selections{label, scope,
    kernel}`` is what the plan's ``kernel_rules`` resolve to per known
    scope (kernel ``"xla"`` included — a declined kernel is a decision,
    not an absence), and ``zoo_kernel_invocations{kernel, backend}``
    re-exports ``ops.cuda.kernel_invocation_counts()``: backend
    ``kernel`` counts the CUDA kernel's launches, ``plain`` its plain
    PyTorch version's calls (the reference's ``pallas``/``fallback``
    pair).  Returns ``{"selections": {scope: kernel}, "invocations":
    {...}}``."""
    from analytics_zoo_tpu_torch.metrics import get_registry
    from analytics_zoo_tpu_torch.ops.cuda import kernel_invocation_counts

    reg = get_registry()
    selections = {}
    for scope in KERNEL_SCOPES:
        kernel = plan.kernel_for(scope)
        if kernel is None:
            continue
        selections[scope] = kernel
        reg.gauge("zoo_kernel_selections",
                  "kernel a plan's kernel_rules resolve for an op scope "
                  "(1 = selected; 'xla' is the explicit fallback pick)",
                  ("label", "scope", "kernel")).labels(
            label=label, scope=scope, kernel=kernel).set(1)
    invocations = kernel_invocation_counts()
    for kernel, counts in invocations.items():
        for backend, n in counts.items():
            reg.gauge("zoo_kernel_invocations",
                      "per-kernel routing counter: launches of the CUDA "
                      "kernel vs calls of its plain PyTorch version",
                      ("kernel", "backend")).labels(
                kernel=kernel, backend=backend).set(n)
    return {"selections": selections, "invocations": invocations}
