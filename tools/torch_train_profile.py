#!/usr/bin/env python3
"""Where the time of one BERT-base fine-tuning step goes, on one CUDA GPU.

    python3 tools/torch_train_profile.py [--steps 3] [--trace DIR]

Runs the PyTorch port's training slice as ``chip_smoke.py`` does (BERT-base
at full width, Dense(2) logits head, hidden and attention dropout 0.1,
``Adam(2e-5)``, ``sparse_categorical_crossentropy_from_logits``, batch
8 x 512, random weights and data from a seed), warms up one step, then
traces ``--steps`` steps with ``torch.profiler`` (CPU and CUDA activity).
Prints the card's name and power limit, the host-clock time per step, the
device time per step by kernel group (the port's kernels by name, cuBLAS
matrix products, everything else), the device's busy and idle shares of
the step, and the same as one JSON line last.  ``--trace DIR`` also writes
the Chrome trace there.  Needs one GPU and nvcc; imports nothing of the
JAX package.
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
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("flash_attention_bwd", ("dq_kernel", "dkv_kernel")),
    ("fused_adam", ("adam_kernel",)),
    ("softmax_xent", ("xent_fwd_kernel", "xent_bwd_kernel")),
    ("matmul (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "Kernel2",
                         "splitKreduce")),
)


def group_of(name: str) -> str:
    for group, frags in GROUPS:
        if any(f in name for f in frags):
            return group
    return "other (elementwise, reductions, copies)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: no CUDA GPU is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    init_zoo_context(seed=SEED, device="cuda")
    ins = [Input((SEQ,)) for _ in range(4)]
    _, pooled = BERT(**BERT_BASE)(ins)
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
    net.fit([a[:BATCH] for a in x], y[:BATCH], batch_size=BATCH, nb_epoch=1)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(x, y, batch_size=BATCH, nb_epoch=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "train_step.json"))

    groups: dict[str, float] = {}
    launches: dict[str, int] = {}
    for ev in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        g = group_of(ev.key)
        groups[g] = groups.get(g, 0.0) + dev_us / 1e3 / args.steps
        launches[g] = launches.get(g, 0) + ev.count
    launches = {g: n // args.steps for g, n in launches.items()}
    busy = sum(groups.values())
    print(f"step: {wall_ms:.2f} ms on the host clock ({card}); device busy "
          f"{busy:.2f} ms ({busy / wall_ms:.1%}), idle "
          f"{1 - busy / wall_ms:.1%}", flush=True)
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {ms:.3f} ms per step ({ms / wall_ms:.1%} of the "
              f"step), {launches[g]} launches", flush=True)
    print(json.dumps({"card": card, "steps": args.steps,
                      "step_ms": wall_ms, "device_busy_ms": busy,
                      "idle_share": 1 - busy / wall_ms,
                      "groups_ms": groups, "launches": launches}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
