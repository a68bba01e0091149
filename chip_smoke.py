#!/usr/bin/env python3
"""Run the PyTorch port's serving, training and int8 serving slices on one
CUDA GPU and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (the process then exits non-zero
and prints no result):

1. card: a CUDA GPU must be visible; prints its name and power limit;
2. build: compiles every CUDA kernel of the three slices from ``csrc/``
   (one nvcc per source, all started together) and prints ptxas's register
   report;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it, with the tolerance stated: the
   flash-attention forward (serving, and training with dropout 0.1 and
   the (m, l) statistics), the flash-attention backward, fused Adam over
   the BERT-base parameter tree, and the softmax cross-entropy forward and
   backward at the classifier head (8, 2) and an LM head (4096, 30522), and
   the weight-only int8 matmul at BERT-base's six Dense shapes for one
   8 x 512 micro-batch (f32 x at all six, bf16 x at the four with M = 4096),
   its weights from ``quantize_params_for_plan(params, int8_serving())`` on
   the seeded tree.  Times each kernel, its plain version and one PyTorch
   library call computing the same function (the yardstick only; the port
   never calls it), and computes each kernel's bound from this run's
   inputs;
4. serving slice: BERT-base at full width (vocab 30522, 12 blocks of
   hidden 768, 12 heads, intermediate 3072, sequence 512) with a
   Dense(2, softmax) head, as a 4-input Model served by
   ``InferenceModel`` with random weights from a seed.  It answers
   requests of 1, 3, 8 and 2 records and one bf16 request, checks the
   outputs, holds two requests against the same model run on the CPU, and
   checks from the launch counters that every attention call went through
   the kernel;
5. training slice: the BERT-base classifier (Dense(2) logits, hidden and
   attention dropout 0.1) through ``compile(Adam(2e-5),
   "sparse_categorical_crossentropy_from_logits", ["accuracy"])``, ``fit``
   for 5 steps at batch 8 x 512 and ``evaluate``; checks finite losses,
   that every attention, Adam leaf and loss call went through its kernel,
   that the loss falls when one batch is repeated at a higher learning
   rate, and holds the step-1 loss and gradients against the same model
   run on the CPU (2 blocks at full width, batch 2, hidden dropout 0,
   attention dropout 0.1: the dropout hash is the same on both devices);
6. int8 serving slice: BERT-base served weight-only int8
   (``optimize("int8")``, the 4-input model) and calibrated int8
   (``optimize("int8", calibration_data=...)`` with 16 seeded records, a
   single-input BERT-base over token ids: calibration takes one input
   array, as in the reference, and only the head Dense is a target), each
   answering requests of 1, 3 and 8 records held against the f32 model;
   the calibrated request 0 is held against the same calibrated model on
   the CPU.  Then ``quantized_matmul`` over all 50 quantized Dense kernels
   of BERT-base (48 encoder, pooler, head) under
   ``compile_step(..., plan=with_kernels(int8_serving()))``, which must
   launch the int8 kernel exactly 50 times and agree with the plain
   version, and under a plan that picks ``"xla"`` for
   ``serving.int8_matmul``, which must launch it no time;
7. summary: a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Needs one GPU, nvcc, and nothing from the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
SEQ = 512
BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                 seq_len=SEQ, intermediate_size=3072, type_vocab=2)
REQUEST_SIZES = (1, 3, 8, 2)
CPU_CHECKED = (0, 3)          # requests held against the CPU run
F32_TOL = 1e-4                # kernel vs plain, f32 math on both sides
BF16_TOL = 2e-2               # bf16 kernel vs plain run in f32
CPU_TOL = 1e-4                # GPU vs CPU serving outputs (probabilities)
BF16_SERVE_TOL = 0.1          # bf16 vs f32 serving outputs (probabilities)
# backward kernel vs plain, relative to the largest gradient when that
# exceeds 1: both sum 512-long f32 products, in different orders
BWD_TOL = 2e-4
ADAM_TOL = 1e-6               # relative to the leaf's largest value
XENT_TOL = 1e-5               # f32 sums over the vocab in different orders
DROPOUT = 0.1
TRAIN_BATCH, TRAIN_STEPS = 8, 5
# GPU vs CPU training step at 2 blocks: loss relative, gradients relative
# to each leaf's largest value (f32 on both sides; cuBLAS, MKL and the
# kernels sum in different orders)
TRAIN_CPU_TOL = 1e-3
# int8 matmul vs its plain version, relative L2: f32 sums in another
# order; bf16 x is held against the plain version in f32, so the bf16
# rounding of the output (2**-9 relative) dominates
INT8_F32_TOL = 1e-5
INT8_BF16_TOL = 1e-2
# int8 serving vs the f32 model (probabilities): each weight rounds by up
# to half a step of 1/127 of its column's largest magnitude, through 12
# blocks
INT8_SERVE_TOL = 0.05
# calibrated request on the GPU vs the same calibrated model on the CPU:
# one activation that rounds to the neighbouring int8 step moves a logit
# by act_scale x w_scale (~1e-4 here)
INT8_CPU_TOL = 1e-3
INT8_REQUESTS = (1, 3, 8)
N_CALIB = 16
# the quantized Dense kernels of the BERT-base classifier: 4 per block, the
# pooler and the head
DENSE_KERNELS = r"(qkv|proj|fc|out|pooler)_kernel$|^dense_0/kernel$"
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "fused_adam",
           "fused_softmax_xent", "int8_matmul")
REPLACES = {
    "flash_attention_fwd":
        "analytics_zoo_tpu/ops/pallas/flash_attention.py:216",
    "flash_attention_bwd":
        "analytics_zoo_tpu/ops/pallas/flash_attention.py:458",
    "fused_adam": "analytics_zoo_tpu/ops/pallas/fused_adam.py:109",
    "softmax_xent_fwd":
        "analytics_zoo_tpu/ops/pallas/fused_softmax_xent.py:159",
    "softmax_xent_bwd":
        "analytics_zoo_tpu/ops/pallas/fused_softmax_xent.py:192",
    "int8_matmul": "analytics_zoo_tpu/ops/pallas/int8_matmul.py:92",
}
# Published H100 SXM peaks (dense): HBM bytes/s and FLOP/s per input type
# (f32 outside the tensor cores; bf16 on them).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU is visible")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(line)
    return line


def build_kernels() -> None:
    from analytics_zoo_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    report = build.build(KERNELS)
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(report)}")
    for name, r in report.items():
        for ln in r["log"].splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after warm-up."""
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


def padding_bias(b: int, lk: int, gen: np.random.Generator):
    """(B, 1, 1, Lk) BERT mask bias, made as the BERT layer makes it; the
    last row is fully masked, like a bucket's zero padding record."""
    lengths = gen.integers(64, lk + 1, b)
    keep = (np.arange(lk)[None, :] < lengths[:, None]).astype(np.float32)
    keep[-1] = 0.0
    return ((1.0 - keep) * np.finfo(np.float32).min)[:, None, None, :]


def attention_inputs(b, h, lq, lk, d, gen, device):
    """q, k, v as split_heads views of fused projections, as the model
    hands them to the kernel (non-contiguous rows)."""
    import torch

    def heads(n):
        x = torch.from_numpy(gen.normal(size=(b, n, 3 * h * d)).astype(
            np.float32)).to(device)
        return [t.reshape(b, n, h, d).transpose(1, 2)
                for t in torch.chunk(x, 3, dim=-1)]

    q = heads(lq)[0]
    _, k, v = heads(lk)
    return q, k, v


def kernel_phase(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    gen = np.random.default_rng(SEED)
    b, h, l, d = 8, 12, SEQ, 64
    q, k, v = attention_inputs(b, h, l, l, d, gen, dev)
    bias_np = padding_bias(b, l, gen)
    bias = torch.from_numpy(bias_np).to(dev)
    scale = 1.0 / np.sqrt(d)
    live_keys = int((bias_np[:, 0, 0, :] == 0).sum())  # summed over batch
    entry = {"name": "flash_attention_fwd", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/flash_attention_fwd.cu",
             "replaces": "analytics_zoo_tpu/ops/pallas/flash_attention.py"
                         ":216"}
    per_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        got = fa.flash_attention(qq, kk, vv, False, scale, bias=bias)
        want = fa.attention_reference(qq.float(), kk.float(), vv.float(),
                                      False, scale, bias=bias)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        log(f"kernel {name} B={b} H={h} L={l} D={d} padded bias: "
            f"max|d| {err:.3e} (tol {tol:g}); fully masked row max "
            f"{got[-1].float().abs().max().item():.1e}")
        if not err <= tol or not torch.isfinite(got.float()).all():
            raise AssertionError(f"flash kernel {name} disagrees: {err}")
        if got[-1].float().abs().max().item() != 0.0:
            raise AssertionError("fully masked row is not zero")
        ms = cuda_ms(lambda: fa.flash_attention(qq, kk, vv, False, scale,
                                                bias=bias))
        plain_ms = cuda_ms(lambda: fa.attention_reference(
            qq, kk, vv, False, scale, bias=bias))
        lib_bias = bias.to(dtype)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=lib_bias, scale=scale))
        # least time for the same work: q, k, v, out and the bias moved
        # once; the two products over the (query, live key) pairs only
        nbytes = 4 * b * h * l * d * qq.element_size() + bias.numel() * 4
        flops = 4.0 * h * l * live_keys * d
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        per_dtype[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({per_dtype[name]['bound_by']}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")

    # end-aligned causal with lq != lk and a ragged lk, both dtypes
    qc, kc, vc = attention_inputs(2, h, 448, 500, d, gen, dev)
    causal_err = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        qq, kk, vv = (t.to(dtype) for t in (qc, kc, vc))
        got = fa.flash_attention(qq, kk, vv, True, scale)
        want = fa.attention_reference(qq.float(), kk.float(), vv.float(),
                                      True, scale)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        log(f"kernel causal lq=448 lk=500 {dtype}: max|d| {err:.3e} "
            f"(tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"causal flash kernel disagrees: {err}")
        if dtype == torch.float32:
            causal_err = err
    entry.update(per_dtype["float32"])
    entry["max_abs_err"] = max(per_dtype["float32"]["max_abs_err"],
                               causal_err)
    entry["bf16"] = per_dtype["bfloat16"]
    return entry


def timed(fn, plain, library) -> dict:
    return {"ms": cuda_ms(fn), "plain_ms": cuda_ms(plain),
            "library_ms": None if library is None else cuda_ms(library)}


def bound(nbytes: float, flops: float, dtype: str = "float32") -> dict:
    """The least time for the work: bytes at the HBM rate, operations at
    the input type's peak; the larger one bounds."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    return ((got.float() - want.float()).abs().max()
            / max(1.0, want.float().abs().max().item())).item()


def flash_train_phase(dev, fwd_entry) -> dict:
    """The flash forward with dropout and statistics, and the backward,
    at the BERT-base training shape with the padding bias."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    gen = np.random.default_rng(SEED + 2)
    b, h, l, d = 8, 12, SEQ, 64
    q, k, v = attention_inputs(b, h, l, l, d, gen, dev)
    g = torch.from_numpy(gen.normal(size=(b, h, l, d)).astype(np.float32)
                         ).to(dev)
    bias_np = padding_bias(b, l, gen)
    bias = torch.from_numpy(bias_np).to(dev)
    scale = 1.0 / np.sqrt(d)
    seed = (0x2545F491, 0x9E3779B9)
    live_keys = int((bias_np[:, 0, 0, :] == 0).sum())

    out, m, lsum = fa._flash_cuda(q, k, v, False, scale, bias, DROPOUT,
                                  seed, stats=True)
    w_out, w_m, w_l = fa.attention_reference(q, k, v, False, scale, bias,
                                             DROPOUT, seed, True)
    torch.cuda.synchronize()
    errs = [(out - w_out).abs().max().item(),
            (m - w_m).abs().max().item(),
            ((lsum - w_l).abs() / w_l.abs().clamp_min(1.0)).max().item()]
    log(f"kernel fwd train (dropout {DROPOUT}, stats): max|d| out "
        f"{errs[0]:.3e}, m {errs[1]:.3e}, l (rel) {errs[2]:.3e} "
        f"(tol {F32_TOL:g}); fully masked row max "
        f"{out[-1].abs().max().item():.1e}")
    if not max(errs) <= F32_TOL or out[-1].abs().max().item() != 0.0:
        raise AssertionError(f"flash forward with dropout disagrees: {errs}")
    lib_q, lib_k, lib_v = (t.contiguous() for t in (q, k, v))
    train = timed(
        lambda: fa._flash_cuda(q, k, v, False, scale, bias, DROPOUT, seed,
                               stats=True),
        lambda: fa.attention_reference(q, k, v, False, scale, bias,
                                       DROPOUT, seed, True),
        lambda: F.scaled_dot_product_attention(
            lib_q, lib_k, lib_v, attn_mask=bias, dropout_p=DROPOUT,
            scale=scale))
    fwd_bytes = 4 * b * h * l * d * 4 + bias.numel() * 4 + 2 * b * h * l * 4
    train.update(bound(fwd_bytes, 4.0 * h * l * live_keys * d))
    train["max_abs_err"] = max(errs)
    fwd_entry["train"] = train
    fwd_entry["max_abs_err"] = max(fwd_entry["max_abs_err"], max(errs))
    log(f"kernel fwd train: {train['ms']:.4f} ms, plain "
        f"{train['plain_ms']:.4f} ms, sdpa {train['library_ms']:.4f} ms, "
        f"bound {train['bound_ms']:.4f} ms")

    args = (q, k, v, g, out, m, lsum, False, scale, bias, DROPOUT, seed)
    got = fa._flash_bwd_cuda(*args)
    want = fa.attention_bwd_reference(*args)
    torch.cuda.synchronize()
    err = max(rel_err(x, y) for x, y in zip(got[:3], want[:3]))
    abs_err = max((x - y).abs().max().item()
                  for x, y in zip(got[:3], want[:3]))
    masked = max(x[-1].abs().max().item() for x in got[:3])
    log(f"kernel bwd B={b} H={h} L={l} D={d} padded bias, dropout "
        f"{DROPOUT}: max|d| {abs_err:.3e}, relative {err:.3e} "
        f"(tol {BWD_TOL:g}); fully masked row grads max {masked:.1e}")
    if not err <= BWD_TOL or masked != 0.0:
        raise AssertionError(f"flash backward disagrees: {err}")
    lq_, lk_, lv_ = (t.detach().contiguous().requires_grad_()
                     for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq_, lk_, lv_, attn_mask=bias,
                                             scale=scale)
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/flash_attention_bwd.cu",
             "replaces": REPLACES["flash_attention_bwd"],
             "max_abs_err": abs_err}
    entry.update(timed(
        lambda: fa._flash_bwd_cuda(*args),
        lambda: fa.attention_bwd_reference(*args),
        lambda: torch.autograd.grad(lib_out, (lq_, lk_, lv_), g,
                                    retain_graph=True)))
    # q, k, v, dO, O, m, l and the bias read once; dq, dk, dv written once;
    # five (query, live key, D) products
    entry.update(bound(5 * b * h * l * d * 4 + 2 * b * h * l * 4
                       + bias.numel() * 4 + 3 * b * h * l * d * 4,
                       10.0 * h * l * live_keys * d))
    log(f"kernel bwd: {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} "
        f"ms, sdpa backward {entry['library_ms']:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})")
    return entry


def adam_phase(dev, leaf_shapes) -> dict:
    """Fused Adam over the BERT-base parameter tree."""
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    leaves = [(rand(s, 1e-3), rand(s, 1e-4), rand(s, 1e-8).abs())
              for s in leaf_shapes]
    kernel_leaves = [t for t in leaves
                     if t[0].numel() >= fad.MIN_KERNEL_LEAF]
    scalars = torch.tensor([2e-5, 0.9, 0.999, 1e-8, 1 - 0.9 ** 3,
                            1 - 0.999 ** 3], dtype=torch.float32, device=dev)
    err = 0.0
    for g, mu, nu in kernel_leaves:
        got = fad.adam_leaf(g, mu, nu, scalars)
        want = fad.adam_leaf_reference(g, mu, nu, scalars)
        for x, y in zip(got, want):
            err = max(err, ((x - y).abs().max()
                            / y.abs().max().clamp_min(1e-30)).item())
    n = sum(t[0].numel() for t in kernel_leaves)
    log(f"kernel adam: {len(kernel_leaves)} leaves of {len(leaves)}, "
        f"{n / 1e6:.1f} M parameters: max relative |d| {err:.3e} "
        f"(tol {ADAM_TOL:g})")
    if not err <= ADAM_TOL:
        raise AssertionError(f"fused adam disagrees: {err}")
    params = [torch.zeros(s, device=dev, requires_grad=True)
              for s in leaf_shapes]
    for p, (g, _, _) in zip(params, leaves):
        p.grad = g
    lib = torch.optim.Adam(params, lr=2e-5, fused=True)
    entry = {"name": "fused_adam", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/fused_adam.cu",
             "replaces": REPLACES["fused_adam"], "max_abs_err": err}
    entry.update(timed(
        lambda: [fad.adam_leaf(*t, scalars) for t in kernel_leaves],
        lambda: [fad.adam_leaf_reference(*t, scalars)
                 for t in kernel_leaves],
        lib.step))
    entry.update(bound(24.0 * n, 12.0 * n))
    log(f"kernel adam: {entry['ms']:.4f} ms per step, plain "
        f"{entry['plain_ms']:.4f} ms, torch fused Adam "
        f"{entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms")
    return entry


def xent_phase(dev) -> list:
    """Softmax cross-entropy forward and backward at the classifier head
    (the main path's shape) and at an LM head."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import fused_softmax_xent as fx

    fwd = {"name": "softmax_xent_fwd", "route": "cuda",
           "source": "analytics_zoo_tpu_torch/csrc/fused_softmax_xent.cu",
           "replaces": REPLACES["softmax_xent_fwd"], "max_abs_err": 0.0}
    bwd = dict(fwd, name="softmax_xent_bwd",
               replaces=REPLACES["softmax_xent_bwd"])
    gen = np.random.default_rng(SEED + 3)
    for key, (b, v) in (("head", (TRAIN_BATCH, 2)),
                        ("lm_head", (4096, 30522))):
        x = torch.from_numpy((gen.normal(size=(b, v)) * 3).astype(
            np.float32)).to(dev)
        labels = torch.from_numpy(gen.integers(0, v, b)).to(dev)
        g = torch.from_numpy(gen.normal(size=b).astype(np.float32)).to(dev)
        loss, lse = fx._fwd_cuda(x, labels)
        dx = fx._bwd_cuda(x, labels, lse, g)
        w_loss, w_lse = fx.xent_reference(x, labels)
        w_dx = fx.xent_bwd_reference(x, labels, w_lse, g)
        torch.cuda.synchronize()
        e_f = max(((loss - w_loss).abs() / w_loss.abs().clamp_min(1)).max(
        ).item(), ((lse - w_lse).abs() / w_lse.abs().clamp_min(1)).max(
        ).item())
        e_b = (dx - w_dx).abs().max().item()
        log(f"kernel xent ({b}, {v}): fwd max rel|d| {e_f:.3e}, bwd "
            f"max|d| {e_b:.3e} (tol {XENT_TOL:g})")
        if not (e_f <= XENT_TOL and e_b <= XENT_TOL):
            raise AssertionError(f"softmax xent disagrees at ({b}, {v})")
        xr = x.detach().clone().requires_grad_()
        lib_loss = F.cross_entropy(xr, labels, reduction="none")
        nbytes = b * v * 4
        f_row = timed(lambda: fx._fwd_cuda(x, labels),
                      lambda: fx.xent_reference(x, labels),
                      lambda: F.cross_entropy(x, labels, reduction="none"))
        f_row.update(bound(nbytes + 4 * b * 4, 3.0 * b * v))
        b_row = timed(lambda: fx._bwd_cuda(x, labels, lse, g),
                      lambda: fx.xent_bwd_reference(x, labels, lse, g),
                      lambda: torch.autograd.grad(lib_loss, xr, g,
                                                  retain_graph=True))
        b_row.update(bound(2 * nbytes + 4 * b * 4, 4.0 * b * v))
        f_row["max_abs_err"], b_row["max_abs_err"] = e_f, e_b
        for entry, row in ((fwd, f_row), (bwd, b_row)):
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       row["max_abs_err"])
            if key == "head":
                entry.update({k: row[k] for k in row if k != "max_abs_err"})
            else:
                entry[key] = row
            log(f"kernel {entry['name']} ({b}, {v}): {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, library "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    return [fwd, bwd]


def bert_model():
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense

    ins = [Input((SEQ,)) for _ in range(4)]
    _, pooled = BERT(**BERT_BASE)(ins)
    return Model(ins, Dense(2, activation="softmax")(pooled))


def requests_of(n: int, gen: np.random.Generator):
    """n records of real lengths 64-512: token ids, segment types,
    positions and the attention mask."""
    lengths = gen.integers(64, SEQ + 1, n)
    split = (lengths * gen.uniform(0.3, 0.7, n)).astype(np.int64)
    pos = np.arange(SEQ)[None, :]
    mask = (pos < lengths[:, None]).astype(np.float32)
    ids = gen.integers(1, BERT_BASE["vocab"], (n, SEQ)) * mask
    types = ((pos >= split[:, None]) & (mask > 0)).astype(np.int32)
    return [ids.astype(np.int32), types,
            np.tile(pos.astype(np.int32), (n, 1)), mask]


def requests(gen: np.random.Generator):
    return [requests_of(n, gen) for n in REQUEST_SIZES]


def tree_leaves_of_bert():
    """The BERT-base classifier's parameter leaves (on the CPU)."""
    from analytics_zoo_tpu_torch.common.engine import make_generator
    from analytics_zoo_tpu_torch.common.utils import tree_leaves

    return tree_leaves(bert_classifier(BERT_BASE["n_block"], DROPOUT,
                                       DROPOUT).init_params(
        make_generator(SEED)))


def slice_phase(card_line: str) -> int:
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(seed=SEED, device="cuda")
    t0 = time.perf_counter()
    net = bert_model()
    net.build_params()
    im = InferenceModel().from_keras_net(net)
    im.warmup([(SEQ,)] * 4, batch_sizes=REQUEST_SIZES)
    im_bf16 = InferenceModel().from_keras_net(net).optimize("bf16")
    im_bf16.warmup([(SEQ,)] * 4, batch_sizes=REQUEST_SIZES)
    torch.cuda.synchronize()
    log(f"slice: BERT-base built and warmed up in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = requests(np.random.default_rng(SEED + 1))

    fa.launch_count = 0  # main path: from here to the read below
    outs, f32_launches = [], 0
    for i, xs in enumerate(reqs):
        t0 = time.perf_counter()
        out = im.predict(xs)
        ms = (time.perf_counter() - t0) * 1e3
        f32_launches = fa.launch_count
        outs.append(out)
        log(f"request {i}: {len(out)} records in {ms:.2f} ms "
            f"({card_line})")
        if out.shape != (len(xs[0]), 2) or not np.isfinite(out).all():
            raise AssertionError(f"request {i}: bad output {out.shape}")
        if not np.allclose(out.sum(axis=1), 1.0, atol=1e-5):
            raise AssertionError(f"request {i}: rows do not sum to 1")
    t0 = time.perf_counter()
    bf16_out = im_bf16.predict(reqs[2])
    ms = (time.perf_counter() - t0) * 1e3
    launches = fa.launch_count  # end of the main path
    blocks = BERT_BASE["n_block"]
    log(f"bf16 request: {len(bf16_out)} records in {ms:.2f} ms; "
        f"flash launches: {f32_launches} f32 + {launches - f32_launches} "
        f"bf16 (expected {blocks} per micro-batch)")
    if f32_launches != blocks * len(reqs) or launches != blocks * (
            len(reqs) + 1):
        raise AssertionError(f"flash launches {f32_launches}/{launches}: "
                             "attention did not run through the kernel")
    bf16_err = float(np.abs(bf16_out - outs[2]).max())
    log(f"bf16 vs f32 outputs: max|d| {bf16_err:.3e} "
        f"(tol {BF16_SERVE_TOL:g})")
    if not np.isfinite(bf16_out).all() or not bf16_err <= BF16_SERVE_TOL \
            or not np.allclose(bf16_out.sum(axis=1), 1.0, atol=1e-2):
        raise AssertionError("bf16 request disagrees with f32")

    # the same model (same seed, same weights) on the CPU, plain versions
    cpu = bert_model()
    cpu.build_params(device="cpu")
    cpu_im = InferenceModel().from_keras_net(cpu)
    for i in CPU_CHECKED:
        err = float(np.abs(cpu_im.predict(reqs[i]) - outs[i]).max())
        log(f"request {i} vs CPU: max|d| {err:.3e} (tol {CPU_TOL:g})")
        if not err <= CPU_TOL:
            raise AssertionError(f"request {i} disagrees with the CPU run")
    return launches


def bert_classifier(n_block, hidden_drop, attn_drop):
    """BERT with a Dense(2) logits head, fine-tuned as users of BERT do."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense

    ins = [Input((SEQ,)) for _ in range(4)]
    cfg = dict(BERT_BASE, n_block=n_block, hidden_p_drop=hidden_drop,
               attn_p_drop=attn_drop)
    _, pooled = BERT(**cfg)(ins)
    return Model(ins, Dense(2)(pooled))


def counters() -> dict:
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad
    from analytics_zoo_tpu_torch.ops.cuda import fused_softmax_xent as fx
    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as im8

    return {"flash_attention_fwd": fa.launch_count,
            "flash_attention_bwd": fa.bwd_launch_count,
            "fused_adam": fad.launch_count,
            "softmax_xent_fwd": fx.fwd_launch_count,
            "softmax_xent_bwd": fx.bwd_launch_count,
            "int8_matmul": im8.launch_count}


def reset_counters() -> None:
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad
    from analytics_zoo_tpu_torch.ops.cuda import fused_softmax_xent as fx
    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as im8

    fa.launch_count = fa.bwd_launch_count = 0
    fad.launch_count = 0
    fx.fwd_launch_count = fx.bwd_launch_count = 0
    im8.launch_count = 0


def train_data(n: int, gen: np.random.Generator):
    x = requests_of(n, gen)
    return x, gen.integers(0, 2, n).astype(np.int32)


def training_phase(card_line: str) -> dict:
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import step_generator
    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
        get_loss,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    init_zoo_context(seed=SEED, device="cuda")
    gen = np.random.default_rng(SEED + 4)
    t0 = time.perf_counter()
    net = bert_classifier(BERT_BASE["n_block"], DROPOUT, DROPOUT)
    net.build_params()
    net.compile(optimizer=Adam(2e-5),
                loss="sparse_categorical_crossentropy_from_logits",
                metrics=["accuracy"])
    n = TRAIN_BATCH * TRAIN_STEPS
    x, y = train_data(n, gen)
    warm = [a[:TRAIN_BATCH] for a in x]
    net.fit(warm, y[:TRAIN_BATCH], batch_size=TRAIN_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    log(f"training: BERT-base classifier built and one warm-up step in "
        f"{time.perf_counter() - t0:.1f} s")
    kernel_leaves = sum(
        1 for t in tree_leaves(net.params)
        if t.dtype == torch.float32 and t.numel() >= fad.MIN_KERNEL_LEAF)

    reset_counters()  # main path: from here to the read below
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = counters()  # end of the main path
    est = net._estimator
    losses = [v for _, v in est.loss_log[-TRAIN_STEPS:]]
    log(f"training: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} x {SEQ}: "
        f"{step_ms:.1f} ms per step ({card_line}); losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    blocks = BERT_BASE["n_block"]
    expected = {"flash_attention_fwd": blocks * TRAIN_STEPS,
                "flash_attention_bwd": blocks * TRAIN_STEPS,
                "fused_adam": kernel_leaves * TRAIN_STEPS,
                "softmax_xent_fwd": TRAIN_STEPS,
                "softmax_xent_bwd": TRAIN_STEPS,
                "int8_matmul": 0}
    log(f"training launches: {launches} (expected {expected}; "
        f"{kernel_leaves} f32 leaves of >= {fad.MIN_KERNEL_LEAF})")
    if launches != expected:
        raise AssertionError("a training call did not run through its "
                             "kernel")
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"training losses not finite: {losses}")
    res = net.evaluate(x, y, batch_size=TRAIN_BATCH)
    log(f"evaluate: {res}")
    if not (np.isfinite(res["loss"]) and 0.0 <= res["accuracy"] <= 1.0):
        raise AssertionError(f"bad evaluate result {res}")

    # one batch the model has not seen, repeated at a higher learning rate
    # (fresh Adam moments): the loss falls
    fresh_x, fresh_y = train_data(TRAIN_BATCH, gen)
    net.compile(optimizer=Adam(5e-5),
                loss="sparse_categorical_crossentropy_from_logits")
    net.fit(fresh_x, fresh_y, batch_size=TRAIN_BATCH, nb_epoch=10)
    rep = [v for _, v in net._estimator.loss_log]
    log("repeated batch at lr 5e-5: " + ", ".join(f"{v:.4f}" for v in rep))
    if not min(rep[-3:]) < rep[0]:
        raise AssertionError(f"the loss did not fall: {rep}")

    # step 1 on the GPU against the same model on the CPU: 2 blocks at full
    # width, batch 2, hidden dropout 0, attention dropout on
    xs, ys = train_data(2, gen)
    batch = {"x": xs, "y": ys}
    results = []
    for device in ("cuda", "cpu"):
        small = bert_classifier(2, 0.0, DROPOUT)
        small.build_params(rng=torch.Generator().manual_seed(SEED),
                           device=device)
        est = Estimator(small, loss=get_loss(
            "sparse_categorical_crossentropy_from_logits"))
        loss, grads, _ = est.loss_and_grads(
            small.params, small.state, _to_device(batch, small.device),
            step_generator(SEED, 0, small.device))
        results.append((loss.item(), [g.cpu() for g in tree_leaves(grads)]))
    (g_loss, g_grads), (c_loss, c_grads) = results
    loss_err = abs(g_loss - c_loss) / abs(c_loss)
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   .item() for a, b in zip(g_grads, c_grads))
    log(f"training step 1 vs CPU (2 blocks, batch 2, attention dropout "
        f"{DROPOUT}): loss {g_loss:.6f} vs {c_loss:.6f} (rel {loss_err:.2e})"
        f", grads max rel to leaf max {grad_err:.2e} (tol "
        f"{TRAIN_CPU_TOL:g})")
    if not (loss_err <= TRAIN_CPU_TOL and grad_err <= TRAIN_CPU_TOL):
        raise AssertionError("the GPU training step disagrees with the CPU")
    return launches


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in f32."""
    diff = got.float() - want.float()
    return (diff.norm() / want.float().norm().clamp_min(1e-30)).item()


def int8_weights(dev) -> dict:
    """The 50 quantized Dense kernels of the serving BERT-base (48 encoder,
    the pooler and the head), by leaf path, on ``dev``: the seeded tree
    through ``quantize_params_for_plan(params, int8_serving())``."""
    import re

    from analytics_zoo_tpu_torch.common.engine import make_generator
    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.parallel import int8_serving
    from analytics_zoo_tpu_torch.parallel.partition import (
        leaf_path_name,
        tree_map_with_path,
    )
    from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
        QuantizedTensor,
        quantize_params_for_plan,
    )

    params = tree_map(lambda t: t.to(dev),
                      bert_model().init_params(make_generator(SEED)))
    out = {}

    def pick(path, leaf):
        name = leaf_path_name(path)
        if isinstance(leaf, QuantizedTensor) and re.search(DENSE_KERNELS,
                                                           name):
            out[name] = leaf
        return leaf

    tree_map_with_path(pick, quantize_params_for_plan(params, int8_serving()))
    if len(out) != 4 * BERT_BASE["n_block"] + 2:
        raise AssertionError(f"expected 50 quantized Dense kernels, got "
                             f"{len(out)}")
    return out


def int8_rows(path: str) -> int:
    """Rows of the activations a Dense kernel sees for one 8 x 512
    micro-batch: every token in the encoder, one per record after it."""
    return 8 if "pooler" in path or path.startswith("dense_0") else 8 * SEQ


def int8_kernel_phase(dev, weights) -> dict:
    """The int8 matmul kernel against its plain version at BERT-base's six
    Dense shapes, f32 x at all, bf16 x at the four with M = 4096."""
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as im8

    gen = np.random.default_rng(SEED + 5)
    shapes = [(label, f"bert_0/blocks/0/{label}_kernel")
              for label in ("qkv", "proj", "fc", "out")]
    shapes += [("pooler", "bert_0/pooler_kernel"), ("head", "dense_0/kernel")]
    rows, errs = [], []
    for label, path in shapes:
        qt = weights[path]
        values, scale = qt.values, qt.scale.reshape(-1)
        (k, n), m = values.shape, int8_rows(path)
        x = torch.from_numpy(gen.normal(size=(m, k)).astype(np.float32)
                             ).to(dev)
        for dtype in ((torch.float32, torch.bfloat16) if m > 8
                      else (torch.float32,)):
            name = str(dtype).split(".")[1]
            xx = x.to(dtype)
            got = im8.int8_matmul(xx, values, scale)
            want = im8._reference(xx.float(), values, scale)
            torch.cuda.synchronize()
            rel = rel_l2(got, want)
            abs_err = (got.float() - want).abs().max().item()
            tol = INT8_F32_TOL if dtype == torch.float32 else INT8_BF16_TOL
            log(f"kernel int8 {label} ({m}, {k}, {n}) {name}: relative L2 "
                f"{rel:.3e} (tol {tol:g}), max|d| {abs_err:.3e}")
            if not rel <= tol or got.dtype != dtype \
                    or not torch.isfinite(got.float()).all():
                raise AssertionError(f"int8 matmul {label} {name} disagrees:"
                                     f" {rel}")
            wdeq = values.to(dtype) * scale.to(dtype)
            row = {"shape": label, "m": m, "k": k, "n": n, "dtype": name,
                   "rel_l2": rel, "max_abs_err": abs_err}
            row.update(timed(lambda: im8.int8_matmul(xx, values, scale),
                             lambda: im8._reference(xx, values, scale),
                             lambda: xx @ wdeq))
            # x, W (1 byte), the scale and the output moved once; 2 M K N
            # operations at the input type's peak
            esize = xx.element_size()
            row.update(bound(m * k * esize + k * n + 4 * n + m * n * esize,
                             2.0 * m * k * n, name))
            log(f"kernel int8 {label} {name}: {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, dequantize+matmul "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
            rows.append(row)
            if dtype == torch.float32:
                errs.append(abs_err)
    f32 = {r["shape"]: r for r in rows if r["dtype"] == "float32"}
    blocks = BERT_BASE["n_block"]
    per_pass = {key: blocks * sum(f32[s][key] for s in
                                  ("qkv", "proj", "fc", "out"))
                + f32["pooler"][key] + f32["head"][key]
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"kernel int8 f32, one BERT-base pass (12 blocks, pooler, head): "
        f"{per_pass['ms']:.3f} ms, bound {per_pass['bound_ms']:.3f} ms, "
        f"dequantize+matmul {per_pass['library_ms']:.3f} ms")
    entry = {"name": "int8_matmul", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/int8_matmul.cu",
             "replaces": REPLACES["int8_matmul"], "max_abs_err": max(errs)}
    entry.update({k: f32["qkv"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")})
    entry["shapes"] = rows
    entry["f32_pass"] = per_pass
    return entry


def bert_tokens_model():
    """BERT-base over token ids alone, with the Dense(2, softmax) head: the
    one-input model that calibrated int8 takes."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense

    ids = Input((SEQ,))
    _, pooled = BERT(**BERT_BASE)(ids)
    return Model(ids, Dense(2, activation="softmax")(pooled))


def check_probs(tag, out, n, want, tol):
    err = float(np.abs(out - want).max())
    if out.shape != (n, 2) or not np.isfinite(out).all() \
            or not np.allclose(out.sum(axis=1), 1.0, atol=1e-5):
        raise AssertionError(f"{tag}: bad output {out.shape}")
    if not err <= tol:
        raise AssertionError(f"{tag}: max|d| {err} from f32 (tol {tol})")
    return err


def int8_serving_phase(card_line: str, weights) -> dict:
    """Weight-only and calibrated int8 serving of BERT-base, and the
    int8_matmul kernel route over its 50 Dense kernels; returns the launch
    counts of the path."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as im8
    from analytics_zoo_tpu_torch.ops.cuda import kernel_invocation_counts
    from analytics_zoo_tpu_torch.parallel import (
        compile_step,
        int8_serving,
        with_kernels,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
        Int8Model,
        QuantizedTensor,
        quantized_matmul,
    )

    dev = next(iter(weights.values())).values.device
    init_zoo_context(seed=SEED, device=dev.type)
    gen = np.random.default_rng(SEED + 6)
    t0 = time.perf_counter()
    net, tok_net = bert_model(), bert_tokens_model()
    net.build_params()
    tok_net.build_params()
    calib = requests_of(N_CALIB, gen)[0]
    f32_im = InferenceModel().from_keras_net(net)
    f32_tok = InferenceModel().from_keras_net(tok_net)
    w8 = InferenceModel().from_keras_net(net).optimize("int8")
    cal = InferenceModel().from_keras_net(tok_net).optimize(
        "int8", calibration_data=calib)
    w8.warmup([(SEQ,)] * 4, batch_sizes=INT8_REQUESTS)
    cal.warmup([(SEQ,)], batch_sizes=INT8_REQUESTS)
    reqs = [requests_of(n, gen) for n in INT8_REQUESTS]
    want = [f32_im.predict(r) for r in reqs]
    want_tok = [f32_tok.predict(r[0]) for r in reqs]
    scales = cal._int8_model.act_scales
    log(f"int8 serving: models built, calibrated on {N_CALIB} records and "
        f"warmed up in {time.perf_counter() - t0:.1f} s; calibrated "
        f"targets {sorted(scales)} (activation scales {scales})")
    # one seeded activation per (rows, K) of the Dense kernels
    acts = {key: torch.from_numpy(gen.normal(size=key).astype(np.float32)
                                  ).to(dev)
            for key in sorted({(int8_rows(p), qt.values.shape[0])
                               for p, qt in weights.items()})}
    torch.cuda.synchronize()

    reset_counters()  # int8 serving main path: from here to the read below
    outs = {}
    for tag, im, pick, refs in (("weight-only", w8, lambda r: r, want),
                                ("calibrated", cal, lambda r: r[0],
                                 want_tok)):
        for i, r in enumerate(reqs):
            t0 = time.perf_counter()
            out = im.predict(pick(r))
            ms = (time.perf_counter() - t0) * 1e3
            err = check_probs(f"int8 {tag} request {i}", out, len(r[0]),
                              refs[i], INT8_SERVE_TOL)
            outs[tag, i] = out
            log(f"int8 {tag} request {i}: {len(out)} records in {ms:.2f} ms "
                f"({card_line}); max|d| from f32 {err:.3e} (tol "
                f"{INT8_SERVE_TOL:g})")
    flash = counters()["flash_attention_fwd"]

    def route():
        return {p: quantized_matmul(
                    acts[(int8_rows(p), qt.values.shape[0])], qt)
                for p, qt in weights.items()}

    kernel_route = compile_step(route, with_kernels(int8_serving()),
                                label="int8_kernel_route")
    xla_route = compile_step(
        route, with_kernels(int8_serving(),
                            (("serving.int8_matmul", "xla"),)),
        label="int8_xla_route")
    before = kernel_invocation_counts()["int8_matmul"]
    t0 = time.perf_counter()
    got = kernel_route()
    torch.cuda.synchronize()
    route_ms = (time.perf_counter() - t0) * 1e3
    mid = kernel_invocation_counts()["int8_matmul"]
    xla = xla_route()
    torch.cuda.synchronize()
    after = kernel_invocation_counts()["int8_matmul"]
    launches = counters()  # end of the int8 serving main path
    log(f"int8 kernel route: {len(got)} quantized_matmul calls in "
        f"{route_ms:.2f} ms ({card_line}); int8_matmul counts {before} -> "
        f"{mid} (kernel route) -> {after} (xla route)")
    if mid["kernel"] - before["kernel"] != len(weights) \
            or mid["plain"] != before["plain"] or after != mid:
        raise AssertionError("quantized_matmul did not route through the "
                             "int8 kernel exactly once per Dense kernel")
    route_err = xla_err = 0.0
    for p, qt in weights.items():
        x = acts[(int8_rows(p), qt.values.shape[0])]
        plain = im8._reference(x, qt.values, qt.scale.reshape(-1))
        route_err = max(route_err, rel_l2(got[p], plain))
        xla_err = max(xla_err, rel_l2(xla[p], plain))
    log(f"int8 kernel route vs plain: relative L2 {route_err:.3e}; xla "
        f"(dequantize) route {xla_err:.3e} (tol {INT8_F32_TOL:g})")
    if not (route_err <= INT8_F32_TOL and xla_err <= INT8_F32_TOL):
        raise AssertionError("an int8 route disagrees with the plain version")
    blocks = BERT_BASE["n_block"]
    expected_flash = 2 * blocks * len(INT8_REQUESTS)
    log(f"int8 serving launches: {launches} (expected flash "
        f"{expected_flash}, int8_matmul {len(weights)})")
    if flash != expected_flash or launches["flash_attention_fwd"] != flash \
            or launches["int8_matmul"] != len(weights):
        raise AssertionError("an int8 serving call did not run through its "
                             "kernel")

    # the calibrated request 0 against the same calibrated model (its
    # activation scales and int8 kernels) on the CPU, plain versions
    cpu = bert_tokens_model()
    cpu.build_params(device="cpu")
    cpu_q = Int8Model(cpu, tree_map(
        lambda l: QuantizedTensor(l.values.cpu(), l.scale.cpu(), l.axis)
        if isinstance(l, QuantizedTensor) else l.cpu(),
        cal._int8_model.qparams), scales)
    err = float(np.abs(cpu_q.predict(reqs[0][0], batch_size=1)
                       - outs["calibrated", 0]).max())
    log(f"calibrated request 0 vs CPU: max|d| {err:.3e} (tol "
        f"{INT8_CPU_TOL:g})")
    if not err <= INT8_CPU_TOL:
        raise AssertionError("the calibrated request disagrees with the CPU")
    return launches


def main() -> int:
    import torch

    card_line = card()
    dev = torch.device("cuda")
    build_kernels()
    fwd = kernel_phase(dev)
    bwd = flash_train_phase(dev, fwd)
    shapes = [tuple(t.shape) for t in tree_leaves_of_bert()]
    adam = adam_phase(dev, shapes)
    xent = xent_phase(dev)
    weights = int8_weights(dev)
    int8 = int8_kernel_phase(dev, weights)
    entries = [fwd, bwd, adam] + xent + [int8]
    reset_counters()  # serving main path: counted inside slice_phase
    serving = {"flash_attention_fwd": slice_phase(card_line)}
    training = training_phase(card_line)
    int8_serving = int8_serving_phase(card_line, weights)
    for entry in entries:
        name = entry["name"]
        paths = {"serving": serving.get(name, 0),
                 "training": training.get(name, 0),
                 "int8_serving": int8_serving.get(name, 0)}
        entry["launches"] = sum(paths.values())
        entry["launches_by_path"] = paths
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(json.dumps({"kernels": [
        {**{k: e[k] for k in keys}, **{k: v for k, v in e.items()
                                         if k not in keys}}
        for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
