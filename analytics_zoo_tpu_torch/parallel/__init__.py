"""Plans: the kernel and precision planes (single device)."""

from analytics_zoo_tpu_torch.parallel.plan import (  # noqa: F401
    DEFAULT_KERNEL_RULES,
    DTYPE_POLICY_NAMES,
    DTYPE_ROLES,
    KERNEL_NAMES,
    ShardingPlan,
    compile_step,
    data_parallel,
    int8_serving,
    mixed_precision,
    resolve_dtype_rules,
    resolve_kernel,
    resolve_plan,
    with_dtype,
    with_dtype_policy,
    with_kernels,
)
