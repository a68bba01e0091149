#!/usr/bin/env python3
"""Time variants of the flash-attention backward's source side by side, on
one CUDA GPU.

    python3 tools/flash_bwd_variants.py VARIANTS [--rounds 2]

VARIANTS is a file holding one Python literal: a dict from a variant's
name to either a list of (old, new) text edits applied to
``csrc/flash_attention_bwd.cu`` or the path of a whole source file to use
instead.  Each variant is copied with the other sources under
``build/variants/<name>/`` (a directory git ignores), built with nvcc and
the flags of ``ops/cuda/build.py`` (all at once), and loaded in place of
the backward's library, so the wrapper and everything around it stay the
same.  For each variant: ptxas's registers and spills of each 16-bit
kernel function, then at BERT-base's training shape (B=8, L=512, the
padding bias of chip_smoke.py, dropout 0.1 at head dim 64 and none at
128) in bf16 and f16 at head dims 64 (12 heads) and 128 (6 heads): the
error relative to each output's largest gradient, the time through the
wrapper (CUDA events over calls issued one by one) and from a CUDA-graph
replay, and, from a ``torch.profiler`` trace, the time of each of the two
kernels; SDPA's backward beside them.  Rounds alternate the variants'
order.  Prints the card's name and power limit first.  Needs one GPU and
nvcc; imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "analytics_zoo_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants")
SEED = 20261016
# (head dim, heads, dtype name, dropout)
CASES = ((64, 12, "bfloat16", 0.1), (64, 12, "float16", 0.1),
         (128, 6, "bfloat16", 0.0), (128, 6, "float16", 0.0))


def build_all(variants):
    """Build every variant's library in parallel; returns {name: path}."""
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops.cuda import build

    procs = {}
    for name, edits in variants.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        path = os.path.join(d, "flash_attention_bwd.cu")
        if isinstance(edits, str):
            text = open(os.path.join(ROOT, edits)).read()
        else:
            text = open(path).read()
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"variant {name}: edit not found: "
                                     f"{old[:60]!r}")
                text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        for fn, regs, spilled in cs.ptxas_report(log):
            if "bwd16_kernel" in fn:
                print(f"ptxas {name} {fn}: {regs} registers, {spilled} "
                      f"bytes spilled", flush=True)
        libs[name] = lib
    return libs


def kernel_times(fn, reps=10):
    """(is the dk/dv kernel, device time per call) of each backward kernel,
    from a trace; the kernel's KV flag is its third template argument."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.key.split("<", 1)[1].split(">")[0].split(", ")[2] == "true",
             e.device_time_total / reps / 1e3)
            for e in prof.key_averages() if "zoo_flash_bwd" in e.key]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops.cuda import build
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    cs.card()
    variants = ast.literal_eval(open(args.variants).read())
    paths = build_all(variants)
    build.build(["flash_attention_fwd"])
    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED)
    cases = []
    for d, h, dtype, drop in CASES:
        dt = getattr(torch, dtype)
        q, k, v = (t.to(dt) for t in cs.attention_inputs(8, h, 512, 512, d,
                                                         gen, dev))
        g = torch.from_numpy(gen.normal(size=(8, h, 512, d)).astype(
            np.float32)).to(dev, dt)
        bias = torch.from_numpy(cs.padding_bias(8, 512, gen)).to(dev)
        scale, seed = 1.0 / np.sqrt(d), (0x2545F491, 0x9E3779B9)
        out, m, l = fa._flash_cuda(q, k, v, False, scale, bias, drop,
                                   seed if drop else None, stats=True)
        bwd_args = (q, k, v, g, out, m, l, False, scale, bias, drop,
                    seed if drop else None)
        want = fa.attention_bwd_reference(*(x.float() for x in bwd_args[:5]),
                                          *bwd_args[5:])
        cases.append((f"{dtype}_d{d}", bwd_args, want,
                      cs.sdpa_backward(q, k, v, g, bias, scale)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        fn = lib.zoo_flash_attention_bwd
        fn.argtypes = fa._ARGTYPES["flash_attention_bwd"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    for rnd in range(args.rounds):
        order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for name in order:
            fa._LIBS["flash_attention_bwd"] = libs[name]
            for label, bwd_args, want, _ in cases:
                got = fa._flash_bwd_cuda(*bwd_args)
                torch.cuda.synchronize()
                top = max(cs.top_err(x, w) for x, w in zip(got[:3], want[:3]))

                def call(a=bwd_args):
                    return fa._flash_bwd_cuda(*a)

                ks = kernel_times(call)
                print(f"round {rnd} {name} {label}: {cs.cuda_ms(call):.4f} ms"
                      f" through the wrapper, {cs.graph_ms(call):.4f} graph;"
                      f" kernels " + ", ".join(
                          f"{'dk/dv' if kv else 'dq'} {t:.4f}"
                          for kv, t in ks)
                      + f"; relative to the largest gradient {top:.2e}",
                      flush=True)
        print(f"round {rnd} sdpa: " + "; ".join(
            f"{label} {cs.cuda_ms(sd):.4f} / graph {cs.graph_ms(sd):.4f}"
            for label, _, _, sd in cases), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
