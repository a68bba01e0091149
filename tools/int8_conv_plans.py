#!/usr/bin/env python3
"""Every tile and split-K plan of the ``int8_conv`` kernel at ResNet-50's
conv shapes, timed on one CUDA GPU, beside the plan the wrapper picks.

    python3 tools/int8_conv_plans.py [--batches 32 1] [--reps 10]

For each distinct conv of ResNet-50 (and its fc) at each batch, random
int8 operands (channels padded to 16) from a seed, the fused-epilogue
call the calibrated layer makes is timed from one CUDA graph of
``--reps`` calls under each plan (N tile 64 or 128; K split 1 to
16 ways, each of at least one K tile; at most TICKETS output tiles when
split), forced through the wrapper's plan cache.  Prints, per shape,
every plan's time, the fastest, and the wrapper's own pick with its
time; then the pass (each shape times its count in the net) under the
fastest plans and under the wrapper's; the card's name and power limit
first and everything as one JSON line last.  Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def candidates(m: int, k: int, cout: int, ic8) -> list:
    """Every (bn, split, per) the kernel takes for (m, k, cout)."""
    nk = -(-k // ic8.BK)
    out = []
    for bn in (64, 128):
        tiles = -(-m // ic8.BM) * -(-cout // bn)
        seen = set()
        for want in (1, 2, 3, 4, 6, 8, 12, 16):
            per = -(-nk // min(want, nk))
            split = -(-nk // per)
            if split in seen or (split > 1 and tiles > ic8.TICKETS):
                continue
            seen.add(split)
            out.append((bn, split, per))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", nargs="+", type=int, default=[32, 1])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "int8_plans_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import int8_conv as ic8

    if not torch.cuda.is_available():
        raise SystemExit("int8_conv_plans: no CUDA GPU is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = np.random.default_rng(cs.SEED + 72)
    result = {"card": card, "batches": {}}
    for batch in args.batches:
        rows, best_pass, pick_pass = [], 0.0, 0.0
        for label, n, spatial, cin, cout, ks, st, dil, pads, count in \
                cs.resnet50_int8_shapes(batch):
            cp = ic8.padded_channels(cin)
            x = torch.from_numpy(gen.integers(
                -127, 128, (n,) + spatial + (cin,), dtype=np.int8))
            w = torch.from_numpy(gen.integers(-127, 128, ks + (cin, cout),
                                              dtype=np.int8))
            xd = F.pad(x, (0, cp - cin)).to(dev)
            wd = ic8.conv_weight_t(w, pad=True).to(dev)
            md = torch.rand(cout, device=dev) * 1e-4
            tk = ic8.new_tickets(dev)
            args_ = (ks, st, dil, pads)
            out = ic8.int8_conv(xd, wd, *args_)
            m, k = out.numel() // cout, wd.shape[1]
            taps = int(np.prod(ks))
            pick = ic8.plan(m, k, cout, taps)
            want = out.cpu()
            times = {}
            for p in sorted(set(candidates(m, k, cout, ic8)) | {pick}):
                ic8.PLANS[(m, k, cout, taps)] = p
                got = ic8.int8_conv(xd, wd, *args_, tickets=tk)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"{label}: plan {p} disagrees")
                times[p] = cs.graph_ms(
                    lambda: ic8.int8_conv(xd, wd, *args_, mult=md,
                                          tickets=tk),
                    args.reps)
            ic8.PLANS[(m, k, cout, taps)] = pick
            best = min(times, key=times.get)
            best_pass += times[best] * count
            pick_pass += times[pick] * count
            rows.append({"shape": label, "count": count, "m": m, "k": k,
                         "n": cout, "best": list(best),
                         "best_ms": times[best], "pick": list(pick),
                         "pick_ms": times[pick],
                         "times": {"%d/%d/%d" % p: t
                                   for p, t in times.items()}})
            print(f"{label} (M {m}, K {k}, Cout {cout}): best {best} "
                  f"{times[best]:.4f} ms, pick {pick} {times[pick]:.4f} ms; "
                  + ", ".join(f"{p[0]}/{p[1]}: {t:.4f}"
                              for p, t in sorted(times.items())),
                  flush=True)
        print(f"pass at {batch} image(s): fastest plans {best_pass:.3f} ms, "
              f"the wrapper's picks {pick_pass:.3f} ms ({card})", flush=True)
        result["batches"][batch] = {"best_ms": best_pass,
                                    "pick_ms": pick_pass, "shapes": rows}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
