#!/usr/bin/env python3
"""Where the time of one BERT-base fine-tuning step goes, on one CUDA GPU.

    python3 tools/torch_train_profile.py [--steps 3] [--heads 12]
                                         [--plan PLAN] [--trace DIR]

Runs the PyTorch port's training slice as ``chip_smoke.py`` does (BERT-base
at full width, Dense(2) logits head, hidden and attention dropout 0.1,
``Adam(2e-5)``, ``sparse_categorical_crossentropy_from_logits``, batch
8 x 512, random weights and data from a seed), twice: the captured step
``fit`` replays (one CUDA graph a step), and the eager step
(``Estimator.train_step`` called step by step, the uncaptured yardstick).
Each warms up one step (``fit``'s eager step and capture), then times
``--steps`` steps on the host clock, then traces ``--steps`` more with
``torch.profiler`` (CPU and CUDA activity).
``--heads 4`` gives the same width with head dim 192, as ``chip_smoke.py``
fine-tunes it; ``--plan`` trains under a plan (a name such as ``dp+bf16``,
or ``mixed_precision``: bf16 compute copies of the f32 masters).
Prints the card's name and power limit, and for each of the two: the
host-clock time per step without the profiler (and under it, which runs
slower), the device time per step by kernel group (the port's kernels by
name, cuBLAS matrix products, copies and casts, everything else), the
operators that launch the most device time (eager only: a graph replay
launches its kernels under no operator), the device's busy and idle
shares of the unprofiled step; then both as one JSON line last.
``--trace DIR`` also writes the Chrome traces there.  Needs one GPU and
nvcc; imports nothing of the JAX package.
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
)


TOP_OPS = 12  # operators listed by the device time they launch


def group_of(name: str) -> str:
    for group, frags in GROUPS:
        if any(f in name for f in frags):
            return group
    return "other (elementwise, reductions, copies)"


def measure(run, steps: int, trace: str | None) -> dict:
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
        g = group_of(ev.key)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--heads", type=int, default=BERT_BASE["n_head"])
    ap.add_argument("--plan", default=None)
    ap.add_argument("--trace", default=None)
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
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    init_zoo_context(seed=SEED, device="cuda")
    plan = mixed_precision() if args.plan == "mixed_precision" else args.plan
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
    y = gen.integers(0, 2, n).astype(np.int32)
    # the step fit replays: its first dispatch is the eager step and the
    # capture
    net.fit([a[:BATCH] for a in x], y[:BATCH], batch_size=BATCH, nb_epoch=1,
            plan=plan)
    torch.cuda.synchronize()

    def captured():
        net.fit(x, y, batch_size=BATCH, nb_epoch=1, plan=plan)
        torch.cuda.synchronize()

    # the eager step on the same model, batches and plan
    est = net._make_estimator()
    eplan = est._resolve_plan(plan)
    step = compile_step(est.train_step, eplan, capture=False)
    state = {"p": tree_map(torch.clone, net.params), "s": net.state}
    state["o"] = est.optimizer.init(state["p"])
    casts = est.compute_casts(eplan, state["p"])
    batches = list(FeatureSet.of(x, y).batches(
        BATCH, shuffle=True, seed=SEED, epoch=1, drop_last=True))

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
        trace = {k: os.path.join(args.trace, f"train_step_{k}.json")
                 for k in ("captured", "eager")}
    name = net._estimator._plan_record["name"]
    out = {}
    for kind, run in (("captured", captured), ("eager", eager)):
        out[kind] = measure(run, args.steps, trace.get(kind))
        report(kind, name, out[kind], card)
    print(json.dumps({"card": card, "steps": args.steps, "heads": args.heads,
                      "plan": name, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
