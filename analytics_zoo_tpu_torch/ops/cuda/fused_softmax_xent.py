"""Fused sparse softmax cross-entropy from logits: the CUDA kernels'
wrappers and their plain versions.

Counterpart of ``analytics_zoo_tpu/ops/pallas/fused_softmax_xent.py``.
``csrc/fused_softmax_xent.cu`` replaces the TPU's forward kernel
(``_fwd_pallas``: per-row loss = lse - x[label] and lse, f32, without a
(B, V) intermediate) and backward kernel (``_bwd_pallas``:
dx = g * (exp(x - lse) - onehot), in the logits' type).

:func:`softmax_xent` is a ``torch.autograd.Function`` over the two; the
labels get no gradient.  A CUDA tensor launches the kernels, a CPU tensor
takes the plain versions :func:`xent_reference` and
:func:`xent_bwd_reference`; nothing falls back from one to the other.
``fwd_launch_count`` and ``bwd_launch_count`` count the kernel launches,
``fwd_plain_count`` and ``bwd_plain_count`` the plain-version calls.
"""

from __future__ import annotations

import ctypes

import torch

fwd_launch_count = 0
bwd_launch_count = 0
fwd_plain_count = 0     # calls that took the plain versions (CPU)
bwd_plain_count = 0

_KERNEL = "fused_softmax_xent"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def xent_reference(logits, labels):
    """Plain forward (the reference's ``_reference_fwd``): (loss, lse),
    both (B,) f32."""
    x = logits.float()
    m = x.amax(dim=-1)
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(dim=-1))
    picked = x.gather(-1, labels.long()[:, None])[:, 0]
    return lse - picked, lse


def xent_bwd_reference(logits, labels, lse, g):
    """Plain backward (the reference's ``_reference_bwd``): dx in the
    logits' dtype."""
    x = logits.float()
    probs = torch.exp(x - lse[:, None])
    onehot = torch.nn.functional.one_hot(labels.long(), x.shape[-1]).float()
    return (g.float()[:, None] * (probs - onehot)).to(logits.dtype)


def softmax_xent(logits, labels):
    """Per-example sparse softmax cross-entropy, (B,) f32: ``logits`` (B, V)
    float, ``labels`` (B,) int; ``logsumexp(logits) - logits[label]``
    computed in f32."""
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"softmax_xent takes (B, V) logits and (B,) labels, "
                         f"got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    return _SoftmaxXent.apply(logits, labels)


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        global fwd_plain_count
        if logits.device.type == "cpu":
            fwd_plain_count += 1
            loss, lse = xent_reference(logits, labels)
        else:
            loss, lse = _fwd_cuda(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        global bwd_plain_count
        logits, labels, lse = ctx.saved_tensors
        if logits.device.type == "cpu":
            bwd_plain_count += 1
            dx = xent_bwd_reference(logits, labels, lse, g)
        else:
            dx = _bwd_cuda(logits, labels, lse, g)
        return dx, None


def _check(logits, labels):
    if logits.device.type != "cuda":
        raise ValueError(f"softmax_xent: no kernel for device "
                         f"{logits.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"softmax_xent kernel takes float32, bfloat16 or "
                        f"float16 logits, got {logits.dtype}")
    if labels.device != logits.device:
        raise ValueError("softmax_xent: logits and labels on different "
                         "devices")
    return (logits.contiguous(),
            labels.to(torch.int32).contiguous())


def _fwd_cuda(logits, labels):
    global fwd_launch_count
    logits, labels = _check(logits, labels)
    b, v = logits.shape
    loss = torch.empty(b, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    rc = _library().zoo_softmax_xent_fwd(
        _DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
        loss.data_ptr(), lse.data_ptr(), b, v,
        torch.cuda.current_stream(logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"softmax_xent forward launch failed: "
                           f"cudaError {rc}")
    fwd_launch_count += 1
    return loss, lse


def _bwd_cuda(logits, labels, lse, g):
    global bwd_launch_count
    logits, labels = _check(logits, labels)
    b, v = logits.shape
    g = g.to(torch.float32).contiguous()
    dx = torch.empty_like(logits)
    rc = _library().zoo_softmax_xent_bwd(
        _DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dx.data_ptr(), b, v,
        torch.cuda.current_stream(logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"softmax_xent backward launch failed: "
                           f"cudaError {rc}")
    bwd_launch_count += 1
    return dx


_LIB = None


def _library():
    """The kernel library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        from analytics_zoo_tpu_torch.ops.cuda.build import load

        lib = load(_KERNEL)
        lib.zoo_softmax_xent_fwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.zoo_softmax_xent_bwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.zoo_softmax_xent_fwd.restype = ctypes.c_int
        lib.zoo_softmax_xent_bwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB
