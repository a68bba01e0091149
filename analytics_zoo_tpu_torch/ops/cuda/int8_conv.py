"""The calibrated int8 layer: the activation quantization and the int8 x
int8 convolution with its float epilogue, the CUDA kernels' wrappers and
their plain versions.

No Pallas kernel is their counterpart: the reference's calibrated conv and
Dense (``_int8_conv``, ``_int8_dense``, with ``_quantize_act``, in
``analytics_zoo_tpu/pipeline/inference/quantize.py``) are lax ops with
``preferred_element_type=int32``, and PyTorch has no int8 convolution on
CUDA, so ``csrc/int8_conv.cu`` computes them on the H100.  A calibrated
layer is two launches:

- :func:`quantize_act`: f32 x (N, ..spatial.., Cin) -> int8
  ``clamp(round(x / scale), -127, 127)``, its channels zero-padded to
  ``cin_p`` (:func:`padded_channels`, a multiple of 16), reading the
  scale from a device scalar;
- :func:`int8_conv`: the int8 channels-last x (N, ..spatial.., Cin_p) of
  rank 1, 2 or 3 with the kernel as a (Cout, K) int8 copy
  (:func:`conv_weight_t`; K = taps x Cin_p, in the HWIO kernel's order),
  the kernel size, strides, dilation and (before, after) pads per spatial
  dim.  Without ``mult`` it returns the exact int32 sums (N, ..out..,
  Cout); with it, the fused f32 epilogue ``acc * mult`` (``+ bias``, then
  ReLU), where ``mult`` is the per-channel ``act_scale * w_scale``.  A
  calibrated Dense is the rank-1 case with one tap (x (M, 1, K_p)).

The sums are exact for operands in [-127, 127] while K x 127^2 stays below
2^31: the wrapper raises past ``MAX_K``, where the reference's int32 would
wrap.  Zero channels add exactly 0, so the sums over the padded operands
are the sums over the unpadded ones.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
version (:func:`int8_conv_reference` with :func:`int8_epilogue_reference`,
:func:`quantize_act_reference`) for a CPU tensor; nothing falls back from
one to the other.  ``launch_count`` / ``plain_count`` count the
convolution's kernel launches and plain calls, ``quantize_launch_count`` /
``quantize_plain_count`` the quantization's.
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import math

import torch
import torch.nn.functional as F

launch_count = 0
plain_count = 0
quantize_launch_count = 0
quantize_plain_count = 0

_KERNEL = "int8_conv"
_INT32_MAX = 2 ** 31 - 1
# the largest K whose sums of products in [-127, 127]^2 fit in int32
MAX_K = _INT32_MAX // (127 * 127)
# channels are padded to a multiple of this: one 16-byte copy of K then
# lies inside one tap
CHANNEL_ALIGN = 16
# the kernel's output tile rows and K tile bytes, and the card's SMs
BM, BK = 128, 128
SMS = 132
# K is split only where it has at least SPLIT_K_TILES K tiles, into at
# most MAX_SPLIT blocks of at least two
SPLIT_K_TILES, MAX_SPLIT = 8, 8
# one split-K ticket per output tile; split-K runs only where the tiles
# fill less than the card, so a launch needs fewer than SMS of them
TICKETS = SMS

_LOG = logging.getLogger(__name__)
#: (m, k, cout) -> (bn, split, per): every plan the wrapper chose
PLANS: dict = {}


def padded_channels(c: int) -> int:
    """``c`` rounded up to a multiple of CHANNEL_ALIGN."""
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


def conv_weight_t(values, pad: bool = False):
    """The (Cout, K) copy of an int8 kernel (..taps.., Cin, Cout) (a Dense
    kernel (K, Cout) is one tap) that the kernel reads: K contiguous for
    each output channel, in the kernel's own (taps, Cin) order.  ``pad``
    zero-pads each tap's Cin to :func:`padded_channels`, as the card
    takes it."""
    v = values.reshape(-1, values.shape[-2], values.shape[-1])
    if pad:
        v = F.pad(v, (0, 0, 0, padded_channels(v.shape[1]) - v.shape[1]))
    return v.reshape(-1, v.shape[-1]).t().contiguous()


def out_size(n: int, k: int, stride: int, dilation: int, lo: int,
             hi: int) -> int:
    """One output dim of a convolution over ``n`` padded by (lo, hi)."""
    return (n + lo + hi - (k - 1) * dilation - 1) // stride + 1


def _geometry(x, w_t, kernel_size, strides, dilation, pads):
    """(rank, out spatial dims) after checking the arguments agree."""
    r = x.dim() - 2
    if r not in (1, 2, 3):
        raise ValueError(f"int8_conv takes rank 1, 2 or 3 (x of 3 to 5 "
                         f"dims), got x {tuple(x.shape)}")
    for name, v in (("kernel_size", kernel_size), ("strides", strides),
                    ("dilation", dilation), ("pads", pads)):
        if len(v) != r:
            raise ValueError(f"int8_conv: {name} {v} is not of rank {r}")
    if min(kernel_size) < 1 or min(strides) < 1 or min(dilation) < 1 \
            or min(p for lo_hi in pads for p in lo_hi) < 0:
        raise ValueError(f"int8_conv: kernel {kernel_size}, strides "
                         f"{strides}, dilation {dilation}, pads {pads}")
    k = math.prod(kernel_size) * x.shape[-1]
    if w_t.dim() != 2 or w_t.shape[1] != k:
        raise ValueError(f"int8_conv takes the kernel as (Cout, {k}), got "
                         f"{tuple(w_t.shape)}")
    out = tuple(out_size(int(n), kk, s, d, lo, hi) for n, kk, s, d, (lo, hi)
                in zip(x.shape[1:-1], kernel_size, strides, dilation, pads))
    if min(out) < 1:
        raise ValueError(f"int8_conv: input {tuple(x.shape)} gives output "
                         f"dims {out}")
    return r, out


def int8_conv_reference(x, w_t, kernel_size, strides, dilation, pads):
    """Plain version: the zero-padded input in int32, and for each tap its
    strided slice (N, ..out.., Cin) times that tap's (Cin, Cout) slice of
    the kernel (int32 matmul), summed over the taps.  Exact for every rank;
    CPU tensors only (CUDA has no int32 matmul)."""
    r, out = _geometry(x, w_t, kernel_size, strides, dilation, pads)
    cin, cout = x.shape[-1], w_t.shape[0]
    flat = [0, 0] + [p for lo_hi in reversed(pads) for p in lo_hi]
    xp = F.pad(x.to(torch.int32), flat)
    acc = torch.zeros((x.shape[0],) + out + (cout,), dtype=torch.int32)
    for t, tap in enumerate(itertools.product(*map(range, kernel_size))):
        window = tuple(slice(i * d, i * d + (o - 1) * s + 1, s)
                       for i, d, o, s in zip(tap, dilation, out, strides))
        xs = xp[(slice(None),) + window]
        wk = w_t[:, t * cin:(t + 1) * cin].to(torch.int32)
        acc += (xs.reshape(-1, cin) @ wk.t()).reshape(acc.shape)
    return acc


def int8_epilogue_reference(acc, mult, bias=None, relu: bool = False):
    """Plain version of the fused epilogue, in the reference's order:
    ``acc.astype(f32) * mult`` (mult = act_scale * w_scale, per output
    channel), then ``+ bias``, then ReLU as ``jax.nn.relu`` computes it
    (-0 becomes +0 and NaN stays NaN, where ``F.relu`` keeps -0: the
    kernel's ``y <= 0 ? 0 : y``)."""
    y = acc.to(torch.float32) * mult
    if bias is not None:
        y = y + bias
    return torch.where(y <= 0, 0.0, y) if relu else y


def quantize_act_reference(x, scale, cin_p: int):
    """Plain version of :func:`quantize_act`: the reference's
    ``_quantize_act`` (``clip(round(x / scale), -127, 127)`` as int8,
    rounding half to even), its channels zero-padded to ``cin_p``."""
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return F.pad(q, (0, cin_p - x.shape[-1]))


def quantize_act(x, scale, cin_p: int | None = None):
    """The int8 activation (..., cin_p) of the f32 ``x`` (..., Cin) at
    ``scale`` (an f32 scalar tensor on x's device, or a float), its
    channels zero-padded to ``cin_p`` (default :func:`padded_channels` of
    Cin)."""
    global quantize_plain_count
    cin_p = padded_channels(x.shape[-1]) if cin_p is None else cin_p
    if cin_p < x.shape[-1]:
        raise ValueError(f"quantize_act: cin_p {cin_p} < Cin {x.shape[-1]}")
    if x.device.type == "cpu":
        quantize_plain_count += 1
        return quantize_act_reference(x, scale, cin_p)
    return _quantize_act_cuda(x, scale, cin_p)


def _quantize_act_cuda(x, scale, cin_p):
    global quantize_launch_count
    if x.device.type != "cuda":
        raise ValueError(f"quantize_act: no kernel for device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"quantize_act kernel takes a contiguous f32 x, got "
                        f"{x.dtype}")
    if cin_p % CHANNEL_ALIGN:
        raise ValueError(f"quantize_act kernel pads to a multiple of "
                         f"{CHANNEL_ALIGN}, got cin_p {cin_p}")
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(float(scale), dtype=torch.float32,
                             device=x.device)
    if scale.dtype != torch.float32 or scale.numel() != 1 \
            or scale.device != x.device:
        raise ValueError(f"quantize_act kernel takes the scale as one f32 on "
                         f"{x.device}, got {scale.dtype} {tuple(scale.shape)}"
                         f" on {scale.device}")
    out = torch.empty(tuple(x.shape[:-1]) + (cin_p,), dtype=torch.int8,
                      device=x.device)
    if out.numel() // 4 > _INT32_MAX:
        raise ValueError(f"quantize_act: {tuple(out.shape)} exceeds the "
                         "kernel's 32-bit indices")
    if out.numel():
        rc = _library().zoo_quantize_act(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            x.numel() // x.shape[-1], x.shape[-1], cin_p,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"quantize_act kernel launch failed: "
                               f"cudaError {rc}")
        quantize_launch_count += 1
    return out


def int8_conv(x, w_t, kernel_size, strides, dilation, pads, mult=None,
              bias=None, relu: bool = False, tickets=None):
    """The convolution of the int8 channels-last ``x`` (N, ..spatial..,
    Cin) with the int8 kernel copy ``w_t`` (Cout, K), at ``strides`` and
    ``dilation``, x padded by ``pads`` ((before, after) per spatial dim)
    with zeros: the exact int32 sums (N, ..out.., Cout), or with ``mult``
    (Cout,) f32 the f32 ``acc * mult`` (``+ bias``, then ReLU where
    ``relu``).  On the card Cin must be a multiple of 16.

    ``tickets`` (from :func:`new_tickets`) are the split-K counters a
    split launch reads and leaves zeroed; the caller owns them, and two
    launches that may overlap (on two streams) must not share them.  When
    not given, a split launch makes a zeroed array of its own (one memset
    more)."""
    global plain_count
    if mult is None and (bias is not None or relu):
        raise ValueError("int8_conv: bias and relu belong to the epilogue, "
                         "which needs mult")
    if x.device.type == "cpu":
        plain_count += 1
        acc = int8_conv_reference(x, w_t, kernel_size, strides, dilation,
                                  pads)
        return acc if mult is None else int8_epilogue_reference(
            acc, mult, bias, relu)
    return _int8_conv_cuda(x, w_t, kernel_size, strides, dilation, pads,
                           mult, bias, relu, tickets)


def _check(x, w_t, mult=None, bias=None):
    """Raise on what the kernel does not take: a device other than CUDA,
    operands that are not int8 (the epilogue's not f32 of Cout), on other
    devices or not contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for device {x.device}")
    for name, t, dtype in (("x", x, torch.int8), ("the kernel", w_t,
                                                 torch.int8),
                           ("mult", mult, torch.float32),
                           ("bias", bias, torch.float32)):
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"int8_conv kernel takes {dtype} {name}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"int8_conv: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_conv kernel takes a contiguous {name}")
    for name, t in (("mult", mult), ("bias", bias)):
        if t is not None and tuple(t.shape) != (w_t.shape[0],):
            raise ValueError(f"int8_conv: {name} {tuple(t.shape)} is not "
                             f"({w_t.shape[0]},)")


def plan(m: int, k: int, cout: int, taps: int = 1) -> tuple[int, int, int]:
    """(bn, split, per) for an (M, K, Cout) product over ``taps`` taps:
    the N tile is 128 where Cout and K are deep (at least 128 columns,
    512 bytes of K), M spans at least 8 row tiles, and either the taps
    re-read the input or the 128-column tiles fill the card (132 SMs);
    64 elsewhere.  128 halves A's gathers; 64 runs three blocks an SM to
    two, which wins where the output or too few tiles bound the call.
    Then, where the tiles fill less than one block an SM and K has at
    least SPLIT_K_TILES K tiles of 128 bytes, K is split across ``split``
    blocks of ``per`` K tiles (at least two, at most MAX_SPLIT ways).  The
    thresholds come from timing every plan at ResNet-50's shapes at 1
    and 32 images (``tools/int8_conv_plans.py``).  Logged the first time
    a shape asks."""
    key = (m, k, cout, taps)
    got = PLANS.get(key)
    if got is not None:
        return got
    m_tiles = -(-m // BM)
    deep = cout >= 128 and k >= 512 and m_tiles >= 8
    bn = 128 if deep and (taps > 1 or m_tiles * -(-cout // 128) >= SMS) \
        else 64
    tiles = m_tiles * -(-cout // bn)
    nk = -(-k // BK)
    split = 1
    if tiles < SMS and nk >= SPLIT_K_TILES:
        split = max(1, min(SMS // tiles, nk // 2, MAX_SPLIT))
    per = -(-nk // split)
    split = -(-nk // per)
    got = PLANS[key] = (bn, split, per)
    _LOG.info("int8_conv plan for M %d, K %d, Cout %d, %d taps: %d x %d "
              "tiles of %d x %d, K split %d ways (%d K tiles each)", m, k,
              cout, taps, m_tiles, -(-cout // bn), BM, bn, split, per)
    return got


def new_tickets(device):
    """Zeroed split-K tickets for one caller's launches on ``device``
    (each split launch leaves them zeroed, so a captured launch's replays
    start clean)."""
    return torch.zeros(TICKETS, dtype=torch.int32, device=device)


def _int8_conv_cuda(x, w_t, kernel_size, strides, dilation, pads,
                    mult=None, bias=None, relu=False, tickets=None):
    global launch_count
    _check(x, w_t, mult, bias)
    if tickets is not None and (
            tickets.dtype != torch.int32 or tickets.device != x.device
            or not tickets.is_contiguous() or tickets.numel() < TICKETS):
        raise ValueError(f"int8_conv takes tickets as {TICKETS} contiguous "
                         f"int32 on {x.device} (new_tickets), got "
                         f"{tickets.dtype} {tuple(tickets.shape)} on "
                         f"{tickets.device}")
    r, out = _geometry(x, w_t, kernel_size, strides, dilation, pads)
    k = w_t.shape[1]
    if k > MAX_K:
        raise ValueError(f"int8_conv: K = {k} taps x channels could wrap "
                         f"the int32 sums (at most {MAX_K})")
    if x.shape[-1] % CHANNEL_ALIGN:
        raise ValueError(f"int8_conv kernel takes Cin a multiple of "
                         f"{CHANNEL_ALIGN} (quantize_act and conv_weight_t("
                         f"pad=True) pad it), got {x.shape[-1]}")
    m = x.shape[0] * math.prod(out)
    if max(m, x.numel(), w_t.shape[0]) > _INT32_MAX:
        raise ValueError(f"int8_conv: sizes of x {tuple(x.shape)} exceed "
                         "the kernel's 32-bit rows")
    if x.data_ptr() % 16 or w_t.data_ptr() % 16:
        raise ValueError("int8_conv kernel takes x and the kernel 16-byte "
                         "aligned")
    cout = w_t.shape[0]
    bn, split, per = plan(m, k, cout, math.prod(kernel_size))
    ws = None
    if split > 1:
        tiles = -(-m // BM) * -(-cout // bn)
        if tiles > TICKETS:
            raise ValueError(f"int8_conv: a K split over {tiles} output "
                             f"tiles needs more than the {TICKETS} tickets")
        if tickets is None:
            tickets = new_tickets(x.device)
        ws = torch.empty(split * tiles * BM * bn, dtype=torch.int32,
                         device=x.device)
    ones = (1,) * (3 - r)
    spatial = ones + tuple(x.shape[1:-1])
    geo = (ctypes.c_int * 21)(
        x.shape[0], *spatial, x.shape[-1], *(ones + out), cout,
        *(ones + tuple(kernel_size)), *(ones + tuple(strides)),
        *(ones + tuple(dilation)),
        *((0,) * (3 - r) + tuple(lo for lo, _ in pads)))
    res = torch.empty((x.shape[0],) + out + (cout,),
                      dtype=torch.int32 if mult is None else torch.float32,
                      device=x.device)
    rc = _library().zoo_int8_conv(
        x.data_ptr(), w_t.data_ptr(), res.data_ptr(),
        None if mult is None else mult.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if ws is None else tickets.data_ptr(), geo,
        (ctypes.c_int * 3)(bn, split, per), int(mult is not None),
        int(bool(relu)), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: cudaError {rc}")
    launch_count += 1
    return res


_LIB = None


def _library():
    """The kernel library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        from analytics_zoo_tpu_torch.ops.cuda.build import load

        lib = load(_KERNEL)
        lib.zoo_int8_conv.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.zoo_int8_conv.restype = ctypes.c_int
        lib.zoo_quantize_act.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.zoo_quantize_act.restype = ctypes.c_int
        _LIB = lib
    return _LIB
