#!/usr/bin/env python3
"""The calibrated int8 layer and request of ResNet-50 on one CUDA GPU,
timed for a tree of the port given by ``--root`` (default: this one).

    python3 tools/int8_conv_bench.py [--root DIR] [--reps 20]

Imports ``analytics_zoo_tpu_torch`` from ``--root`` (so an older
checkout can be held against this one in the same call: parent, change,
change, parent) and takes its helpers and shapes from this tree's
``chip_smoke.py``.  For each distinct conv of ResNet-50 (and its fc) at 32
and at 1 image, random int8 operands from a seed, from one CUDA graph of
``--reps`` calls each:

- ``kernel_ms``: the ``int8_conv`` kernel as the tree's calibrated layer
  launches it: with its fused epilogue on channels padded to 16 where the
  tree has ``quantize_act``, else the int32 sums on the unpadded operands;
- ``layer_ms``: the layer's whole device work on an f32 input: the
  quantization (``quantize_act``, or the older four torch passes), the
  kernel, and where the tree has no fused epilogue the rescale
  ``acc.to(float32) * (act_scale * w_scale)``.

Each shape's sum times its count in the net gives the pass.  Then
ResNet-50 (random weights from the seed, moving statistics from one
batch) served through ``InferenceModel`` in f32, bf16 and calibrated int8
(``optimize("int8", calibration_data=...)`` on 32 seeded images, as
``chip_smoke.py``'s ``resnet50_int8`` phase builds it): each request's
device time at 1, 8 and 32 images, one replay of its captured forward
timed with CUDA events over ``--reps`` replays.  Prints the card's name
and power limit first and every number as one JSON line last.  Needs one
GPU and nvcc; imports nothing of the JAX package.
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


def smoke_helpers():
    """This tree's ``chip_smoke.py`` as a module of its own name (the
    package it imports inside its functions comes from ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(
        "int8_bench_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shape_rows(cs, batch: int, reps: int, gen) -> list:
    """kernel_ms and layer_ms of each distinct ResNet-50 conv at
    ``batch`` images."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import int8_conv as ic8

    fused = hasattr(ic8, "quantize_act")
    dev = torch.device("cuda")
    rows = []
    for label, n, spatial, cin, cout, ks, st, dil, pads, count in \
            cs.resnet50_int8_shapes(batch):
        w = torch.from_numpy(gen.integers(-127, 128, ks + (cin, cout),
                                          dtype=np.int8))
        scale = 0.0371
        xf = torch.from_numpy((gen.standard_normal(
            (n,) + spatial + (cin,), dtype=np.float32) * 40 * scale)).to(dev)
        sd = torch.tensor(scale, dtype=torch.float32, device=dev)
        w_scale = torch.from_numpy(gen.uniform(
            1e-3, 1e-2, cout).astype(np.float32)).to(dev)
        args = (ks, st, dil, pads)
        if fused:
            cp = ic8.padded_channels(cin)
            wd = ic8.conv_weight_t(w, pad=True).to(dev)
            md = (sd * w_scale).contiguous()
            xs = ic8.quantize_act(xf, sd, cp)
            tk = ic8.new_tickets(dev)

            def kernel():
                return ic8.int8_conv(xs, wd, *args, mult=md, tickets=tk)

            def layer():
                return ic8.int8_conv(ic8.quantize_act(xf, sd, cp), wd,
                                     *args, mult=md, tickets=tk)
        else:
            # the older tree's layer: four torch passes of quantization,
            # the int32 sums, and the rescale
            wd = ic8.conv_weight_t(w).to(dev)

            def quantize():
                return torch.clamp(torch.round(xf / sd), -127, 127).to(
                    torch.int8)

            xs = quantize()

            def kernel():
                return ic8.int8_conv(xs, wd, *args)

            def layer():
                acc = ic8.int8_conv(quantize(), wd, *args)
                return acc.to(torch.float32) * (sd * w_scale)

        rows.append({"shape": label, "count": count,
                     "kernel_ms": cs.graph_ms(kernel, reps),
                     "layer_ms": cs.graph_ms(layer, reps)})
        print(f"{label}: kernel {rows[-1]['kernel_ms']:.4f} ms, layer "
              f"{rows[-1]['layer_ms']:.4f} ms (graph, {reps} calls)",
              flush=True)
    return rows


def request_ms(cs, reps: int) -> dict:
    """The device time of one replayed ResNet-50 request at each of
    RESNET_REQUESTS images, in f32, bf16 and calibrated int8."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models import ResNet
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        recalibrate_batchnorm,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(seed=cs.SEED, device="cuda")
    gen = np.random.default_rng(cs.SEED + 80)
    net = ResNet.image_net(50, classes=cs.RESNET_CLASSES,
                           input_shape=cs.RESNET_SHAPE)
    net.build_params()
    recalibrate_batchnorm(net, gen.standard_normal(
        (cs.RESNET_BATCH,) + cs.RESNET_SHAPE, dtype=np.float32))
    calib = gen.standard_normal((cs.INT8_CALIB,) + cs.RESNET_SHAPE,
                                dtype=np.float32)
    models = {"f32": InferenceModel().from_keras_net(net),
              "bf16": InferenceModel().from_keras_net(net).optimize("bf16"),
              "int8": InferenceModel().from_keras_net(net).optimize(
                  "int8", calibration_data=calib)}
    out = {}
    for tag, im in models.items():
        im.warmup([cs.RESNET_SHAPE], dtype=np.float32,
                  batch_sizes=cs.RESNET_REQUESTS)
        for n in cs.RESNET_REQUESTS:
            x = gen.standard_normal((n,) + cs.RESNET_SHAPE, dtype=np.float32)
            im.predict(x)
            key = ((x.shape, str(x.dtype)),)
            out[f"{tag} {n}"] = cs.replay_ms(
                cs.graph_of(im._steps[key].step), reps)
            print(f"resnet50 request {tag}, {n} image(s): device "
                  f"{out[f'{tag} {n}']:.3f} ms a replay ({reps} replays)",
                  flush=True)
        torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = smoke_helpers()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int8_conv_bench: no CUDA GPU is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    import analytics_zoo_tpu_torch

    print(f"package from {os.path.dirname(analytics_zoo_tpu_torch.__file__)}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = np.random.default_rng(cs.SEED + 71)
    result = {"card": card, "root": root, "passes": {}}
    for batch in cs.INT8_CONV_BATCHES:
        rows = shape_rows(cs, batch, args.reps, gen)
        total = {k: sum(r[k] * r["count"] for r in rows)
                 for k in ("kernel_ms", "layer_ms")}
        print(f"pass at {batch} image(s), {sum(r['count'] for r in rows)} "
              f"calls: kernel {total['kernel_ms']:.3f} ms, layer (quantize, "
              f"kernel, rescale) {total['layer_ms']:.3f} ms ({card})",
              flush=True)
        result["passes"][batch] = {**total, "shapes": rows}
    result["requests"] = request_ms(cs, args.reps)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
