#!/usr/bin/env python3
"""Where the time of one request goes, on one CUDA GPU.

    python3 tools/torch_serve_profile.py [--model bert|resnet50]
        [--precision f32 bf16 int8] [--sizes 1 32] [--requests 10]
        [--trace DIR] [--root DIR]

Serves a model of ``chip_smoke.py`` through ``InferenceModel`` as it
does, with random weights and requests from a seed: ``--model bert`` (the
default) BERT-base at full width with a Dense(2, softmax) head, sequence
512, at 1 and 8 records a request; ``--model resnet50`` ResNet-50
(224x224x3, 1000 classes; its moving statistics set to one batch's, as
the smoke's serving phase sets them) at 1, 8 and 32 images (``--sizes``
picks some).  Each in f32 and bf16 (``optimize("bf16")``), or the
precisions ``--precision`` names: ``int8`` is ResNet-50 calibrated as
``chip_smoke.py``'s ``resnet50_int8`` phase builds it
(``optimize("int8", calibration_data=...)`` on INT8_CALIB seeded images),
its device time split into the ``int8_conv`` kernel, the activation
quantization (the ``quantize_act`` kernel), copies and casts (where an
older tree quantizes, its int8 cast), pooling, host-device copies, and
BatchNorm, ReLU and the rest (where an older tree rescales, its
rescale).  ``--root DIR`` imports the port's package from another
checkout (an older tree, held against this one in the same call).  Each
precision is served two ways: the captured forward
``predict`` replays (one CUDA graph a micro-batch, the batch written into
its static inputs), and the eager forward (the same forward function
called on a batch copied up, as ``predict`` ran it before it was
captured).  Each case warms up (``warmup`` captures the bucket), then
times ``--requests`` requests on the host clock, then traces as many more
with ``torch.profiler`` (CPU and CUDA activity).  Prints the card's name
and power limit, and for each case the host-clock time a request without
the profiler (and under it), the device time a request by kernel group
(BERT: the flash forward, cuBLAS matrix products, copies and casts,
host-device copies, everything else: elementwise work and reductions;
ResNet-50: cuDNN convolutions, pooling, copies and casts, host-device
copies, BatchNorm, ReLU and the rest), the device's busy and idle shares
of the unprofiled request; then all cases as one JSON line last.
``--trace DIR`` also writes the Chrome traces there.  Needs one GPU (and
nvcc for BERT's kernels); imports nothing of the JAX package.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (  # noqa: E402
    INT8_CALIB,
    REQ_DTYPES,
    RESNET_BATCH,
    RESNET_CLASSES,
    RESNET_REQUESTS,
    RESNET_SHAPE,
    SEED,
    SEQ,
    bert_model,
    requests_of,
)
from torch_train_profile import (  # noqa: E402
    CONV_GROUPS,
    GROUPS,
    INT8_GROUPS,
    measure,
)

RECORDS = (1, 8)


def report(name: str, r: dict, card: str) -> None:
    print(f"{name}: {r['step_ms']:.3f} ms a request on the host clock "
          f"({r['profiled_step_ms']:.3f} under the profiler; {card}); "
          f"device busy {r['device_busy_ms']:.3f} ms, idle "
          f"{r['idle_share']:.1%}", flush=True)
    for g, ms in sorted(r["groups_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {ms:.4f} ms a request, {r['launches'][g]} launches",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("bert", "resnet50"), default="bert")
    ap.add_argument("--precision", nargs="+", default=["f32", "bf16"],
                    choices=("f32", "bf16", "int8"))
    ap.add_argument("--sizes", nargs="+", type=int, default=None)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    if "int8" in args.precision and args.model != "resnet50":
        raise SystemExit("torch_serve_profile: --precision int8 serves "
                         "--model resnet50")
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_profile: no CUDA GPU is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    import analytics_zoo_tpu_torch
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models import ResNet
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        recalibrate_batchnorm,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(seed=SEED, device="cuda")
    gen = np.random.default_rng(SEED + 1)
    if args.model == "resnet50":
        net = ResNet.image_net(50, classes=RESNET_CLASSES,
                               input_shape=RESNET_SHAPE)
        net.build_params()
        recalibrate_batchnorm(net, gen.standard_normal(
            (RESNET_BATCH,) + RESNET_SHAPE, dtype=np.float32))
        records, groups = RESNET_REQUESTS, CONV_GROUPS
        shapes, dtypes, unit = [RESNET_SHAPE], [np.float32], "images"

        def request(n):
            return [gen.standard_normal((n,) + RESNET_SHAPE,
                                        dtype=np.float32)]
    else:
        net = bert_model()
        net.build_params()
        records, groups = RECORDS, GROUPS
        shapes, dtypes, unit = [(SEQ,)] * 4, REQ_DTYPES, "records"

        def request(n):
            return requests_of(n, gen)
    print(f"package from "
          f"{os.path.dirname(analytics_zoo_tpu_torch.__file__)}", flush=True)
    records = tuple(args.sizes) if args.sizes else records
    calib = gen.standard_normal((INT8_CALIB,) + RESNET_SHAPE,
                                dtype=np.float32) \
        if "int8" in args.precision else None
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
    out = {}
    for precision in args.precision:
        im = InferenceModel().from_keras_net(net)
        if precision == "bf16":
            im.optimize("bf16")
        elif precision == "int8":
            im.optimize("int8", calibration_data=calib)
        kernel_groups = INT8_GROUPS if precision == "int8" else groups
        im.warmup(shapes, dtype=dtypes, batch_sizes=records)
        fwd = im._forward_fn()
        for n in records:
            xs = request(n)

            def captured():
                for _ in range(args.requests):
                    im.predict(xs)

            def eager():
                for _ in range(args.requests):
                    ts = [torch.from_numpy(a).to(net.device) for a in xs]
                    fwd(im._params, im._state, ts).cpu().numpy()

            eager()  # warm-up: cuBLAS, cuDNN and the kernel libraries
            for kind, run in (("captured", captured), ("eager", eager)):
                name = f"{precision} {n} {unit} {kind}"
                trace = os.path.join(
                    args.trace,
                    f"serve_{args.model}_{precision}_{n}_{kind}.json") \
                    if args.trace else None
                torch.cuda.synchronize()
                out[name] = measure(run, args.requests, trace,
                                    kernel_groups)
                report(name, out[name], card)
    print(json.dumps({"card": card, "model": args.model,
                      "package": os.path.dirname(
                          analytics_zoo_tpu_torch.__file__),
                      "requests": args.requests, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
