#!/usr/bin/env python3
"""Time the port's two training-step kernels that dominate its kernel time,
the flash-attention backward and fused Adam, on one CUDA GPU.

    python3 tools/training_kernels_bench.py [--tag NAME] [--reps 20]

The flash-attention backward at BERT-base's training shape (B=8, H=12,
L=512, D=64, f32, the padding bias of chip_smoke.py with a fully masked
last record, dropout 0.1 from the hash), and beside it at head dim 128 (6
heads) in f32 and at D=64 and 128 in bf16 and in f16: the error of dq, dk
and dv against the plain version on the same inputs, relative to each
output's largest gradient, and the time through the Python wrapper (CUDA events over calls
issued one by one), from a CUDA-graph replay of the same calls and, for
the backward's own kernels alone, from a ``torch.profiler`` trace, with
SDPA's backward (the memory-efficient attention backward op SDPA runs
here, without dropout) timed the same two ways, and the bound of the
kernel's tensor-core route.  Then fused
Adam's ``fused_update`` over the BERT-base classifier's 153 parameter
leaves (the call a training step makes), eager and graph, beside
``torch.optim.Adam(fused=True)``.  Prints the card's name and power limit,
a line per case, and one JSON line last.  To compare two checkouts, run it
from each in turn on the same card.  Needs one GPU and nvcc; imports
nothing of the JAX package.
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
BLOCK = [(768, 2304), (2304,), (768, 768), (768,), (768,), (768,),
         (768, 3072), (3072,), (3072, 768), (768,), (768,), (768,)]
BERT_BASE_LEAVES = BLOCK * 12 + [(30522, 768), (512, 768), (2, 768), (768,),
                                 (768,), (768, 768), (768,), (768, 2), (2,)]
# (label, heads, head dim, dtype name)
BWD_CASES = (("f32_d64", 12, 64, "float32"), ("f32_d128", 6, 128, "float32"),
             ("bf16_d64", 12, 64, "bfloat16"),
             ("bf16_d128", 6, 128, "bfloat16"),
             ("f16_d64", 12, 64, "float16"), ("f16_d128", 6, 128, "float16"))
# published H100 SXM peaks (dense): HBM bytes/s, FLOP/s per input type
# (bf16 and f16 alike)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 494.7e12, "bfloat16": 989e12}


def bound(nbytes, flops, f32):
    """The backward's bound on its tensor-core route: each input read and
    each output written once at the HBM rate, or the five products at the
    tensor cores' rate (f32 as three tf32 products a value, with the f32
    CUDA-core figure beside it; bf16 and f16 at their common 16-bit
    rate)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    row = {}
    if f32:
        row["bound_cuda_core_ms"] = max(t_bytes,
                                        flops / PEAK_FLOPS["float32"] * 1e3)
        t_ops = 3 * flops / PEAK_FLOPS["tfloat32"] * 1e3
    else:
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


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


def kernel_ms(fn, reps):
    """Mean device time of the backward's own kernels (names in the
    ``zoo_flash_bwd`` namespace) per call of ``fn``, from a
    ``torch.profiler`` trace of ``reps`` calls: the kernels without the
    wrapper's PyTorch operations (D = rowsum(dO * O), the outputs, the bias
    gradient's sum)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "zoo_flash_bwd" in e.key) / reps / 1e3


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


def sdpa_backward(q, k, v, g, bias, scale):
    """One PyTorch call for SDPA's backward on these inputs: the backward op
    of the memory-efficient attention kernel (SDPA's choice for f32 with a
    float mask), fed its own forward's outputs; no dropout.  Unlike
    ``torch.autograd.grad``, a CUDA graph can capture it."""
    import torch

    q, k, v = (t.detach().contiguous() for t in (q, k, v))
    mask = bias.to(q.dtype).expand(q.shape[0], q.shape[1], q.shape[2],
                                   k.shape[2])
    out, lse, seed, offset = \
        torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, mask, True, 0.0, False, scale=scale)
    g = g.to(q.dtype).contiguous()

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            g, q, k, v, mask, out, lse, seed, offset, 0.0,
            [True, True, True, False], False, scale=scale)

    return call


def bwd_case(heads, d, dtype, reps, dev):
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    gen = np.random.default_rng(SEED)
    b, l = 8, 512

    def heads_of():
        x = torch.from_numpy(gen.normal(size=(b, l, 3 * heads * d)).astype(
            np.float32)).to(dev)
        return [t.reshape(b, l, heads, d).transpose(1, 2).to(dtype)
                for t in torch.chunk(x, 3, dim=-1)]

    q, k, v = heads_of()
    g = torch.from_numpy(gen.normal(size=(b, heads, l, d)).astype(
        np.float32)).to(dev, dtype)
    lengths = gen.integers(64, l + 1, b)
    keep = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    keep[-1] = 0.0
    bias = torch.from_numpy(((1.0 - keep) * np.finfo(np.float32).min)
                            [:, None, None, :]).to(dev)
    scale, seed = 1.0 / np.sqrt(d), (0x2545F491, 0x9E3779B9)
    out, m, lsum = fa._flash_cuda(q, k, v, False, scale, bias, 0.1, seed,
                                  stats=True)
    args = (q, k, v, g, out, m, lsum, False, scale, bias, 0.1, seed)
    got = fa._flash_bwd_cuda(*args)
    want = fa.attention_bwd_reference(*args)
    torch.cuda.synchronize()
    err = max(((x.float() - y.float()).abs().max()
               / y.float().abs().max()).item()
              for x, y in zip(got[:3], want[:3]))
    masked = max(x[-1].float().abs().max().item() for x in got[:3])
    lib = sdpa_backward(q, k, v, g, bias, scale)

    def call():
        return fa._flash_bwd_cuda(*args)

    live_keys = int((bias[:, 0, 0, :] == 0).sum().item())
    return {"rel_to_largest_grad": err, "masked_row_max": masked,
            "ms": cuda_ms(call, reps), "graph_ms": graph_ms(call, reps),
            "kernel_ms": kernel_ms(call, reps),
            "library_ms": cuda_ms(lib, reps),
            "library_graph_ms": graph_ms(lib, reps),
            **bound(8 * b * heads * l * d * q.element_size()
                    + 2 * b * heads * l * 4 + bias.numel() * 4,
                    10.0 * heads * d * l * live_keys,
                    dtype == torch.float32)}


def adam_case(reps, dev):
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad

    gen = torch.Generator(device=dev).manual_seed(SEED)
    leaves = [(torch.randn(s, generator=gen, device=dev) * 1e-3,
               torch.randn(s, generator=gen, device=dev) * 1e-4,
               (torch.randn(s, generator=gen, device=dev) * 1e-8).abs())
              for s in BERT_BASE_LEAVES]
    gs, mus, nus = (list(x) for x in zip(*leaves))
    scalars = torch.tensor([2e-5, 0.9, 0.999, 1e-8, 1 - 0.9 ** 3,
                            1 - 0.999 ** 3], dtype=torch.float32, device=dev)

    def step():
        return fad.fused_update(gs, mus, nus, scalars)

    before = fad.launch_count
    step()
    torch.cuda.synchronize()
    launches = fad.launch_count - before
    params = [torch.zeros(s, device=dev, requires_grad=True)
              for s in BERT_BASE_LEAVES]
    for p, t in zip(params, gs):
        p.grad = t
    lib = torch.optim.Adam(params, lr=2e-5, fused=True)
    return {"launches_per_step": launches, "ms": cuda_ms(step, reps),
            "graph_ms": graph_ms(step, reps),
            "library_ms": cuda_ms(lib.step, reps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("training_kernels_bench: no CUDA GPU is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    result = {"tag": args.tag, "card": card, "bwd": {}}
    for label, heads, d, dtype in BWD_CASES:
        row = bwd_case(heads, d, getattr(torch, dtype), args.reps, dev)
        result["bwd"][label] = row
        print(f"{args.tag} bwd {label} B=8 H={heads} L=512: error relative "
              f"to the largest gradient {row['rel_to_largest_grad']:.3e}, "
              f"{row['ms']:.4f} ms through the wrapper, {row['graph_ms']:.4f}"
              f" ms graph, {row['kernel_ms']:.4f} ms in its kernels; sdpa "
              f"backward {row['library_ms']:.4f} ms, graph "
              f"{row['library_graph_ms']:.4f} ms; bound {row['bound_ms']:.4f}"
              f" ms ({row['bound_by']})", flush=True)
    row = result["adam"] = adam_case(args.reps, dev)
    print(f"{args.tag} adam over {len(BERT_BASE_LEAVES)} leaves: "
          f"{row['launches_per_step']} launches, {row['ms']:.4f} ms through "
          f"the wrapper, {row['graph_ms']:.4f} ms graph; torch fused Adam "
          f"{row['library_ms']:.4f} ms", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
