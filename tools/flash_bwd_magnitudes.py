#!/usr/bin/env python3
"""How large the flash-attention backward's dO and dS are in a 16-bit
BERT-base fine-tuning step.

    python3 tools/flash_bwd_magnitudes.py [--plan dp+f16] [--blocks 12]
                                          [--batch 8] [--device cuda]

Runs one ``fit`` step of the BERT-base classifier of ``chip_smoke.py``
(Dense(2) logits, hidden and attention dropout 0.1, ``Adam(2e-5)``,
sequence 512, random weights and data from a seed) under ``--plan`` and
records every flash-attention backward of the step: its dO, and its dS =
p (t dO.v - D) computed in f32 by the plain version's own tile math
(``_tile_grads``) on the same inputs.  Prints, per layer (the backward runs
from the last block to the first), the largest |dO|, the median nonzero
|dO|, and of dS the largest value and the median of the rows' largest
values, by query row (the dq kernel's own rows) and by key (the dk/dv
kernel's), and the share of nonzero dS below f16's smallest normal value
(2^-14) and below half its smallest subnormal (2^-25, which rounds to
zero); then one JSON line last.  This says whether dS needs a scale before
it is rounded to f16.  ``--device cpu`` runs the same step with the plain
versions (use ``--blocks 2 --batch 2`` there).  Imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 20261016


def stats(q, k, v, g, out, m, l, causal, scale, bias, dropout_p, seed,
          q_seg=None, kv_seg=None):
    """dO and dS magnitudes of one backward call (f32 numbers)."""
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    b, h, lq, _ = q.shape
    lk = k.shape[2]
    gf = g.float()
    dsum = (gf * out.float()).sum(dim=-1)
    live = fa._live(lq, lk, causal, q_seg, kv_seg, q.device)
    ds = fa._tile_grads(
        q.float(), gf, k.float(), v.float(), m, l.clamp_min(1e-20), dsum,
        live, scale, None if bias is None else bias.float(),
        fa._keep_scale(seed, dropout_p, b, h, lq, 0, lk, q.device))[0].abs()
    nz = ds[ds > 0]
    go = gf.abs()
    row_q = ds.amax(dim=-1)
    row_k = ds.amax(dim=-2)

    def med(x):
        x = x[x > 0]
        return x.median().item() if x.numel() else 0.0

    return {"dO_max": go.max().item(), "dO_median": med(go),
            "dS_max": ds.max().item(),
            "dS_row_max_median_q": med(row_q),
            "dS_row_max_median_k": med(row_k),
            "dS_below_f16_normal": (nz < 2.0 ** -14).float().mean().item()
            if nz.numel() else 0.0,
            "dS_flushed_in_f16": (nz < 2.0 ** -25).float().mean().item()
            if nz.numel() else 0.0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", default="dp+f16")
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa
    from analytics_zoo_tpu_torch.parallel.plan import resolve_plan
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("flash_bwd_magnitudes: no CUDA GPU is visible")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0], flush=True)
    init_zoo_context(seed=SEED, device=args.device)
    net = cs.bert_classifier(args.blocks, cs.DROPOUT, cs.DROPOUT)
    net.build_params()
    net.compile(optimizer=Adam(2e-5),
                loss="sparse_categorical_crossentropy_from_logits")
    x, y = cs.train_data(args.batch, np.random.default_rng(SEED + 4))
    rows = []
    name = "_flash_bwd_cuda" if args.device == "cuda" else \
        "attention_bwd_reference"
    launch = getattr(fa, name)

    def record(*a, **kw):
        rows.append(stats(*a[:12], q_seg=kw.get("q_seg"),
                          kv_seg=kw.get("kv_seg")))
        return launch(*a, **kw)

    setattr(fa, name, record)
    try:
        net.fit(x, y, batch_size=args.batch, nb_epoch=1,
                plan=resolve_plan(args.plan))
    finally:
        setattr(fa, name, launch)
    for i, r in enumerate(rows):
        print(f"layer {args.blocks - 1 - i}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in r.items()), flush=True)
    print(json.dumps({"plan": args.plan, "blocks": args.blocks,
                      "batch": args.batch, "device": args.device,
                      "layers": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
