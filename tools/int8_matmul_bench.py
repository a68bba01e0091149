#!/usr/bin/env python3
"""Time the port's int8 matmul kernel at BERT-base's six Dense shapes and
over one pass of its 50 Dense kernels, on one CUDA GPU.

    python3 tools/int8_matmul_bench.py [--tag NAME] [--reps 20]

For one 8 x 512 micro-batch of BERT-base (QKV, proj, fc and out at 4096
rows, pooler and head at 8), and at K 4096 and 8192, with f32 and with
bf16 x and random int8 weights and scales from a seed: the relative L2
error against the plain version in f32, the kernel's time through its
Python wrapper (CUDA events over calls issued one by one) and from a
CUDA-graph replay of the same calls; then one pass of the 50 calls in the
serving order (12 blocks of QKV, proj, fc, out, then pooler and head), on
the device (CUDA events over 10 passes) and on the host clock.  Prints the
card's name and power limit, a line per shape, and one JSON line last.
To compare two checkouts, run it from each in turn on the same card.
Needs one GPU and nvcc; imports nothing of the JAX package.
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
SHAPES = (("qkv", 4096, 768, 2304), ("proj", 4096, 768, 768),
          ("fc", 4096, 768, 3072), ("out", 4096, 3072, 768),
          ("pooler", 8, 768, 768), ("head", 8, 768, 2),
          ("k4096", 512, 4096, 768), ("k8192", 256, 8192, 512))
PASS = ("qkv", "proj", "fc", "out") * 12 + ("pooler", "head")


def cuda_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as im8

    if not torch.cuda.is_available():
        raise SystemExit("int8_matmul_bench: no CUDA GPU is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED)
    data = {}
    for label, m, k, n in SHAPES:
        x = torch.from_numpy(gen.normal(size=(m, k)).astype(np.float32))
        w = torch.from_numpy(gen.integers(-127, 128, size=(k, n)).astype(
            np.int8))
        s = torch.from_numpy(gen.uniform(0.005, 0.02, size=n).astype(
            np.float32))
        data[label] = (x.to(dev), w.to(dev), s.to(dev))
    result = {"tag": args.tag, "card": card, "shapes": {}, "pass": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        xs = {lb: (x.to(dtype), w, s) for lb, (x, w, s) in data.items()}
        for label, m, k, n in SHAPES:
            x, w, s = xs[label]
            got = im8.int8_matmul(x, w, s).float()
            want = im8._reference(x.float(), w, s)

            def call():
                return im8.int8_matmul(x, w, s)

            row = {"rel_l2": ((got - want).norm() / want.norm()).item(),
                   "ms": cuda_ms(call, args.reps),
                   "graph_ms": graph_ms(call, args.reps)}
            result["shapes"][f"{label}/{name}"] = row
            print(f"{args.tag} {label} ({m}, {k}, {n}) {name}: relative L2 "
                  f"{row['rel_l2']:.3e}, {row['ms']:.4f} ms through the "
                  f"wrapper, {row['graph_ms']:.4f} ms graph", flush=True)

        def one_pass():
            return [im8.int8_matmul(*xs[lb]) for lb in PASS]

        device = cuda_ms(one_pass, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        result["pass"][name] = {"device_ms": device, "host_ms": host}
        print(f"{args.tag} pass of {len(PASS)} {name}: {device:.3f} ms on "
              f"the device, {host:.3f} ms on the host clock", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
