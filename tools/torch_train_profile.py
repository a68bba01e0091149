#!/usr/bin/env python3
"""Where the time of one training step goes, on one CUDA GPU.

    python3 tools/torch_train_profile.py [--model bert|resnet50]
        [--steps 3] [--heads 12] [--plan PLAN] [--trace DIR]

``--model bert`` (the default) runs the PyTorch port's BERT fine-tuning as
``chip_smoke.py`` does (BERT-base at full width, Dense(2) logits head,
hidden and attention dropout 0.1, ``Adam(2e-5)``,
``sparse_categorical_crossentropy_from_logits``, batch 8 x 512);
``--model resnet50`` its ResNet-50 training (``ResNet.image_net(50)``,
224x224x3, 1000 classes, the recipe's ``imagenet_optimizer(batch_size=64)``,
``sparse_categorical_crossentropy``, batch 64).  Random weights and data
come from a seed.  Each runs twice: the captured step ``fit`` replays (one
CUDA graph a step), and the eager step (``Estimator.train_step`` called
step by step, the uncaptured yardstick).  Each warms up one step (``fit``'s
eager step and capture), then times ``--steps`` steps on the host clock,
then traces ``--steps`` more with ``torch.profiler`` (CPU and CUDA
activity).  ``--cudnn-nondeterministic`` lets cuDNN take its default
algorithms, which ``init_zoo_context`` rules out, to show what
determinism costs.  ``--heads 4`` gives BERT the same width with head
dim 192, as
``chip_smoke.py`` fine-tunes it; ``--plan`` trains under a plan (a name
such as ``dp+bf16``, or ``mixed_precision``: bf16 compute copies of the
f32 masters).  Prints the card's name and power limit, and for each of
the two: the host-clock time per step without the profiler (and under
it, which runs slower), the device time per step by kernel group (BERT:
the port's kernels by name, cuBLAS matrix products, copies and casts,
everything else; ResNet-50: the convolutions (with the Dense head's
product), pooling, SGD's multi-tensor passes, copies and casts (the
weights' layout copies among them), and BatchNorm, ReLU and the rest of
the elementwise work and reductions), the operators that launch the most device time (eager
only: a graph replay launches its kernels under no operator), the
device's busy and idle shares of the unprofiled step; then both as one
JSON line last.  ``--trace DIR`` also writes the Chrome traces there.
Needs one GPU (and nvcc for BERT's kernels); imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 20261016
SEQ, BATCH = 512, 8
BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                 seq_len=SEQ, intermediate_size=3072, type_vocab=2,
                 hidden_p_drop=0.1, attn_p_drop=0.1)
# kernel-name fragments -> group; the first match wins
GROUPS = (
    ("flash_attention_fwd", ("flash_fwd_",)),
    ("flash_attention_bwd", ("zoo_flash_bwd",)),
    ("fused_adam", ("adam_multi_kernel",)),
    ("softmax_xent", ("xent_fwd_kernel", "xent_bwd_kernel")),
    ("matmul (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "Kernel2",
                         "splitKreduce", "nvjet")),
    # dtype casts and layout copies (the bf16 plan's per-leaf casts)
    ("copies and casts", ("direct_copy_kernel",)),
    # copies between the host and the device, and fills
    ("host-device copies", ("Memcpy", "Memset")),
)


# the groups of a conv net's step or request (ResNet-50)
# (cuDNN runs some convolutions, 1x1 ones among them, as kernels named
# like cuBLAS's GEMMs, and its bf16 engines as cutlass kernels: by name
# they cannot be told from the one Dense layer's products, a few
# microseconds a step, so those share the group)
CONV_GROUPS = (
    ("convolutions (cuDNN; the Dense head's product)",
     ("fprop", "dgrad", "wgrad", "conv", "implicit", "xmma", "cutlass",
      "cudnn", "gemm", "gemv", "nvjet", "splitKreduce", "Kernel2")),
    ("pooling", ("pool",)),
    ("SGD (multi-tensor)", ("multi_tensor_apply",)),
    ("copies and casts", ("direct_copy_kernel", "copy_kernel")),
    ("host-device copies", ("Memcpy", "Memset")),
)
# the groups of a calibrated int8 conv net's request: the int8 layers'
# two kernels first (a tree whose int8 layers quantize in torch shows that
# work under copies and casts, the int8 cast, and the last group)
INT8_GROUPS = (
    ("int8_conv", ("int8_conv_kernel",)),
    ("quantize_act", ("quantize_act_kernel",)),
) + CONV_GROUPS
OTHER = {GROUPS: "other (elementwise, reductions, copies)",
         CONV_GROUPS: "BatchNorm, ReLU and other elementwise and reductions",
         INT8_GROUPS: "BatchNorm, ReLU and other elementwise and reductions "
                      "(an older tree's quantize and rescale passes among "
                      "them)"}


TOP_OPS = 12  # operators listed by the device time they launch


def group_of(name: str, kernel_groups=GROUPS) -> str:
    for group, frags in kernel_groups:
        if any(f in name for f in frags):
            return group
    return OTHER[kernel_groups]


def measure(run, steps: int, trace: str | None,
            kernel_groups=GROUPS) -> dict:
    """``run()`` (``steps`` training steps, ending in a device sync) timed
    on the host clock, then traced: the step's host and device time, the
    device time by kernel group and by launching operator, the idle
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    if trace:
        prof.export_chrome_trace(trace)
    groups: dict[str, float] = {}
    launches: dict[str, int] = {}
    for ev in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if ev.device_type != DeviceType.CUDA:
            continue
        g = group_of(ev.key, kernel_groups)
        groups[g] = groups.get(g, 0.0) + ev.self_device_time_total / 1e3 \
            / steps
        launches[g] = launches.get(g, 0) + ev.count
    launches = {g: n // steps for g, n in launches.items()}
    # the same device time by the operator that launched it (self time)
    ops = sorted(((ev.key, ev.self_device_time_total / 1e3 / steps,
                   ev.count // steps)
                  for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CPU
                  and ev.self_device_time_total > 0),
                 key=lambda t: -t[1])[:TOP_OPS]
    busy = sum(groups.values())
    return {"step_ms": wall_ms, "profiled_step_ms": profiled_ms,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "groups_ms": groups, "launches": launches,
            "ops_ms": {name: ms for name, ms, _ in ops},
            "ops_calls": {name: n for name, _, n in ops}}


def report(kind: str, plan: str, r: dict, card: str) -> None:
    print(f"{kind} step under plan {plan}: {r['step_ms']:.2f} ms on the "
          f"host clock ({r['profiled_step_ms']:.2f} under the profiler; "
          f"{card}); device busy {r['device_busy_ms']:.2f} ms "
          f"({1 - r['idle_share']:.1%}), idle {r['idle_share']:.1%}",
          flush=True)
    for g, ms in sorted(r["groups_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {ms:.3f} ms per step ({ms / r['step_ms']:.1%} of the "
              f"step), {r['launches'][g]} launches", flush=True)
    if r["ops_ms"]:
        print("  by operator:", flush=True)
    for name, ms in r["ops_ms"].items():
        print(f"    {name}: {ms:.3f} ms per step, {r['ops_calls'][name]} "
              f"calls", flush=True)


def bert_training(args):
    """The BERT-base classifier compiled as ``chip_smoke.py`` fine-tunes
    it, and ``--steps`` batches: (net, x, y, batch size)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    ins = [Input((SEQ,)) for _ in range(4)]
    _, pooled = BERT(**dict(BERT_BASE, n_head=args.heads))(ins)
    net = Model(ins, Dense(2)(pooled))
    net.build_params()
    net.compile(optimizer=Adam(2e-5),
                loss="sparse_categorical_crossentropy_from_logits")
    gen = np.random.default_rng(SEED)
    n = BATCH * args.steps
    lengths = gen.integers(64, SEQ + 1, n)
    pos = np.arange(SEQ)[None, :]
    mask = (pos < lengths[:, None]).astype(np.float32)
    ids = (gen.integers(1, BERT_BASE["vocab"], (n, SEQ)) * mask).astype(
        np.int32)
    x = [ids, np.zeros((n, SEQ), np.int32),
         np.tile(pos.astype(np.int32), (n, 1)), mask]
    return net, x, gen.integers(0, 2, n).astype(np.int32), BATCH


def resnet_training(args):
    """ResNet-50 compiled with the recipe, as ``chip_smoke.py`` trains it,
    and ``--steps`` batches of 64: (net, x, y, batch size)."""
    from chip_smoke import RESNET_BATCH, RESNET_CLASSES, RESNET_SHAPE

    from analytics_zoo_tpu_torch.models import ResNet

    net = ResNet.image_net(50, classes=RESNET_CLASSES,
                           input_shape=RESNET_SHAPE)
    net.build_params()
    net.compile(optimizer=ResNet.imagenet_optimizer(
        batch_size=RESNET_BATCH, steps_per_epoch=args.steps),
        loss="sparse_categorical_crossentropy")
    gen = np.random.default_rng(SEED)
    n = RESNET_BATCH * args.steps
    x = gen.standard_normal((n,) + RESNET_SHAPE, dtype=np.float32)
    return (net, x, gen.integers(0, RESNET_CLASSES, n).astype(np.int32),
            RESNET_BATCH)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("bert", "resnet50"), default="bert")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--heads", type=int, default=BERT_BASE["n_head"])
    ap.add_argument("--plan", default=None)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--cudnn-nondeterministic", action="store_true",
                    help="let cuDNN pick its default algorithms, which "
                    "init_zoo_context rules out (the cost of determinism)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: no CUDA GPU is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import step_generator
    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.parallel import compile_step, mixed_precision
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    init_zoo_context(seed=SEED, device="cuda")
    torch.backends.cudnn.deterministic = not args.cudnn_nondeterministic
    plan = mixed_precision() if args.plan == "mixed_precision" else args.plan
    build, groups = ((resnet_training, CONV_GROUPS)
                     if args.model == "resnet50" else (bert_training, GROUPS))
    net, x, y, batch = build(args)
    first = ([a[:batch] for a in x] if isinstance(x, list) else x[:batch])
    # the step fit replays: its first dispatch is the eager step and the
    # capture
    net.fit(first, y[:batch], batch_size=batch, nb_epoch=1, plan=plan)
    torch.cuda.synchronize()

    def captured():
        net.fit(x, y, batch_size=batch, nb_epoch=1, plan=plan)
        torch.cuda.synchronize()

    # the eager step on the same model, batches and plan
    est = net._make_estimator()
    eplan = est._resolve_plan(plan)
    step = compile_step(est.train_step, eplan, capture=False)
    state = {"p": tree_map(torch.clone, net.params), "s": net.state}
    state["o"] = est.optimizer.init(state["p"])
    casts = est.compute_casts(eplan, state["p"])
    batches = list(FeatureSet.of(x, y).batches(
        batch, shuffle=True, seed=SEED, epoch=1, drop_last=True))

    def eager():
        for i, b in enumerate(batches):
            state["p"], state["o"], state["s"], _ = step(
                state["p"], state["o"], state["s"],
                step_generator(SEED, i, net.device),
                _to_device(b, net.device), casts)
        torch.cuda.synchronize()

    eager()  # warm-up
    trace = {}
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        trace = {k: os.path.join(args.trace,
                                 f"train_step_{args.model}_{k}.json")
                 for k in ("captured", "eager")}
    name = net._estimator._plan_record["name"]
    out = {}
    for kind, run in (("captured", captured), ("eager", eager)):
        out[kind] = measure(run, args.steps, trace.get(kind), groups)
        report(kind, name, out[kind], card)
    print(json.dumps({"card": card, "model": args.model, "batch": batch,
                      "steps": args.steps, "heads": args.heads,
                      "plan": name, "cudnn_deterministic":
                      torch.backends.cudnn.deterministic, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
