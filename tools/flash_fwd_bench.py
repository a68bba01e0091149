#!/usr/bin/env python3
"""Time the port's flash-attention kernels at BERT-base's width (hidden
768, B=8, L=512, the padding bias of chip_smoke.py with a fully masked
last record) on one CUDA GPU, at every head dim a hidden of 768 splits
into, beside SDPA.

    python3 tools/flash_fwd_bench.py [--tag NAME] [--reps 20]
                                     [--dtype float32|bfloat16]
                                     [--only fwd|bwd]

Forward cases: f32 and bf16 at head dims 64 (12 heads), 128 (6), 192 (4),
256 (3) and 384 (2), and f32 at D 64 with dropout 0.1 and the (m, l)
statistics (the training call).  Backward cases: f32 and bf16 at D 192,
256 and 384 (a tree whose kernels do not take a head dim reports
"raises").  ``--dtype`` keeps the cases of one input type (a kernel's
time can depend on what ran on the card before it), ``--only`` the
forward or the backward cases.  Each case: the error
against the plain version on the same inputs (forward: max |d|; backward:
relative to each output's largest gradient), the bound of the kernel's
route (as ``chip_smoke.py`` counts it), the time through the Python
wrapper (CUDA events over calls issued one by one) and from a CUDA-graph
replay of the same calls, the plain version's time (forward: eager and
graph), and SDPA timed the same two ways (forward:
``scaled_dot_product_attention`` with the bias as its mask; backward: the
memory-efficient attention's backward op, without dropout).  Prints the
card's name and power limit, a line per case, and one JSON line last.  To
compare two checkouts, copy this file into the other's ``tools/`` and run
it from each in turn on the same card.  Needs one GPU and nvcc; imports
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
B, L, HIDDEN = 8, 512, 768
FWD_DIMS = (64, 128, 192, 256, 384)
BWD_DIMS = (192, 256, 384)
# published H100 SXM peaks (dense): HBM bytes/s, FLOP/s per input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 494.7e12, "bfloat16": 989e12}


def add_bound(row, nbytes, flops, dtype, tensor_cores):
    """``bound_ms`` of the case and what bounds it: each input read and
    each output written once at the HBM rate, or the operations at the
    route's peak: an f32 tensor-core body (``tensor_cores``) counts three
    tf32 products a value, with the f32 CUDA-core figure beside it
    (``bound_cuda_core_ms``)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    kind = "bfloat16" if dtype == "bfloat16" else "float32"
    if kind == "float32" and tensor_cores:
        row["bound_cuda_core_ms"] = max(t_bytes,
                                        flops / PEAK_FLOPS[kind] * 1e3)
        kind, flops = "tfloat32", 3 * flops
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def live_pairs(bias):
    """(query, live key) pairs of one head: L times the unmasked keys."""
    return L * int((bias[:, 0, 0, :] == 0).sum().item())


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


def both(fn, reps):
    """(eager ms, graph ms) of ``fn``, or (None, None) where it raises."""
    try:
        return cuda_ms(fn, reps), graph_ms(fn, reps)
    except RuntimeError:  # SDPA may not take a head dim
        return None, None


def inputs(d, dtype, dev):
    """q, k, v as split_heads views of one fused projection, dO, and the
    padding bias."""
    import torch

    gen = np.random.default_rng(SEED + d)
    h = HIDDEN // d
    x = torch.from_numpy(gen.normal(size=(B, L, 3 * HIDDEN)).astype(
        np.float32)).to(dev, dtype)
    q, k, v = (t.reshape(B, L, h, d).transpose(1, 2)
               for t in torch.chunk(x, 3, dim=-1))
    g = torch.from_numpy(gen.normal(size=(B, h, L, d)).astype(np.float32)
                         ).to(dev, dtype)
    lengths = gen.integers(64, L + 1, B)
    keep = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    keep[-1] = 0.0
    bias = torch.from_numpy(((1.0 - keep) * np.finfo(np.float32).min)
                            [:, None, None, :]).to(dev)
    return q, k, v, g, bias


def fwd_case(d, dtype, reps, dev, dropout=0.0):
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    q, k, v, _, bias = inputs(d, dtype, dev)
    scale = 1.0 / np.sqrt(d)
    seed = (0x2545F491, 0x9E3779B9) if dropout else None
    stats = dropout > 0.0

    def call():
        return fa._flash_cuda(q, k, v, False, scale, bias, dropout, seed,
                              stats=stats)

    row = {"d": d, "heads": HIDDEN // d, "dtype": str(dtype)[6:],
           "dropout_stats": stats}
    try:
        out = call()[0]
    except (ValueError, RuntimeError) as e:  # a tree whose kernel does
        # not take d
        row["raises"] = type(e).__name__
        return row
    want = fa.attention_reference(q.float(), k.float(), v.float(), False,
                                  scale, bias, dropout, seed)
    torch.cuda.synchronize()
    row["max_abs_err"] = (out.float() - want).abs().max().item()
    h = HIDDEN // d
    add_bound(row, 4 * B * h * L * d * q.element_size() + bias.numel() * 4
              + (2 * B * h * L * 4 if stats else 0),
              4.0 * h * d * live_pairs(bias), row["dtype"], d % 64 == 0)
    row["ms"], row["graph_ms"] = both(call, reps)
    row["plain_ms"], row["plain_graph_ms"] = both(
        lambda: fa.attention_reference(q, k, v, False, scale, bias, dropout,
                                       seed, stats), reps)
    lq, lk, lv = (t.contiguous() for t in (q, k, v))
    mask = bias.to(dtype)
    row["sdpa_ms"], row["sdpa_graph_ms"] = both(
        lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                               dropout_p=dropout,
                                               scale=scale), reps)
    return row


def bwd_case(d, dtype, reps, dev):
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    q, k, v, g, bias = inputs(d, dtype, dev)
    scale = 1.0 / np.sqrt(d)
    seed = (0x2545F491, 0x9E3779B9)
    row = {"d": d, "heads": HIDDEN // d, "dtype": str(dtype)[6:],
           "backward": True}
    try:  # a tree whose kernels do not take d raises
        out, m, lsum = fa._flash_cuda(q, k, v, False, scale, bias, 0.1,
                                      seed, stats=True)
        args = (q, k, v, g, out, m, lsum, False, scale, bias, 0.1, seed)
        got = fa._flash_bwd_cuda(*args)
    except (ValueError, RuntimeError) as e:
        row["raises"] = type(e).__name__
        return row
    want = fa.attention_bwd_reference(
        *(t.float() if torch.is_tensor(t) and t.is_floating_point() else t
          for t in args))
    torch.cuda.synchronize()
    row["rel_to_largest_grad"] = max(
        ((x.float() - w).abs().max() / w.abs().max()).item()
        for x, w in zip(got[:3], want[:3]))
    h = HIDDEN // d
    add_bound(row, 8 * B * h * L * d * q.element_size() + 2 * B * h * L * 4
              + bias.numel() * 4, 10.0 * h * d * live_pairs(bias),
              row["dtype"], True)
    row["ms"], row["graph_ms"] = both(lambda: fa._flash_bwd_cuda(*args),
                                      reps)
    lq, lk, lv = (t.detach().contiguous() for t in (q, k, v))
    mask = bias.to(dtype).expand(B, q.shape[1], L, L)
    try:
        o, lse, s0, s1 = \
            torch.ops.aten._scaled_dot_product_efficient_attention(
                lq, lk, lv, mask, True, 0.0, False, scale=scale)
        gc = g.contiguous()
        row["sdpa_ms"], row["sdpa_graph_ms"] = both(
            lambda: torch.ops.aten.
            _scaled_dot_product_efficient_attention_backward(
                gc, lq, lk, lv, mask, o, lse, s0, s1, 0.0,
                [True, True, True, False], False, scale=scale), reps)
    except RuntimeError:  # SDPA's kernel may not take a head dim
        row["sdpa_ms"] = row["sdpa_graph_ms"] = None
    return row


def fmt(row):
    def ms(x):
        return "none" if x is None else f"{x:.4f}"

    if "raises" in row:
        return f"raises {row['raises']}"
    err = row.get("max_abs_err", row.get("rel_to_largest_grad"))
    cc = (f"; f32 on CUDA cores {row['bound_cuda_core_ms']:.4f}"
          if "bound_cuda_core_ms" in row else "")
    plain = (f"plain {ms(row['plain_ms'])} (graph "
             f"{ms(row['plain_graph_ms'])}); " if "plain_ms" in row else "")
    return (f"{ms(row['ms'])} ms (graph {ms(row['graph_ms'])}); {plain}sdpa "
            f"{ms(row['sdpa_ms'])} (graph {ms(row['sdpa_graph_ms'])}); "
            f"error {err:.3e}; bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}{cc})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"))
    ap.add_argument("--only", choices=("fwd", "bwd"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_bench: no CUDA GPU is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    cases = [(fwd_case, d, dtype, {}) for dtype in (torch.float32,
                                                   torch.bfloat16)
             for d in FWD_DIMS]
    cases.append((fwd_case, 64, torch.float32, {"dropout": 0.1}))
    cases += [(bwd_case, d, dtype, {}) for dtype in (torch.float32,
                                                    torch.bfloat16)
              for d in BWD_DIMS]
    if args.dtype:
        cases = [c for c in cases if str(c[2]) == f"torch.{args.dtype}"]
    if args.only:
        cases = [c for c in cases
                 if (c[0] is bwd_case) == (args.only == "bwd")]
    rows = []
    for fn, d, dtype, kw in cases:
        r = fn(d, dtype, args.reps, dev, **kw)
        rows.append(r)
        kind = ("bwd" if r.get("backward") else
                "fwd dropout+stats" if r.get("dropout_stats") else "fwd")
        print(f"{args.tag} {kind} {r['dtype']} D{r['d']} H{r['heads']}: "
              f"{fmt(r)}", flush=True)
    print(json.dumps({"tag": args.tag, "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
