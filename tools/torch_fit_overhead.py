"""Host clock of a short captured fit: BERT-base (bf16 mixed precision,
Adam 2e-5, dropout 0.1, batch 8 x 512) fits one epoch of 5 steps to
capture its steps, then six more, each timed on the host clock a step
(from the call to the device's end), then one under ``cProfile`` (the
functions by cumulative and own time).

``--root DIR`` runs the tree unpacked at DIR (``git archive <commit> |
tar -x -C DIR``) in place of this checkout, so two trees compare in one
call: ``python3 tools/torch_fit_overhead.py --root build/parent`` then
``python3 tools/torch_fit_overhead.py``.  Needs a CUDA GPU.
"""

import argparse
import cProfile
import io
import os
import pstats
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--fits", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.parallel import mixed_precision
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    print("root", os.path.abspath(args.root), cs.card(), flush=True)
    init_zoo_context(seed=1, device="cuda")
    net = cs.bert_classifier(12, 0.1, 0.1)
    net.build_params()
    net.compile(optimizer=Adam(2e-5),
                loss="sparse_categorical_crossentropy_from_logits")
    x, y = cs.train_data(8 * args.steps, np.random.default_rng(0))
    plan = mixed_precision()

    def fit():
        net.fit(x, y, batch_size=8, nb_epoch=1, plan=plan)

    fit()  # step 1 eager, the capture, replays
    times = []
    for _ in range(args.fits):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / args.steps)
    print("host ms a step", [round(t, 2) for t in times], flush=True)
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    fit()
    torch.cuda.synchronize()
    prof.disable()
    for key in ("cumulative", "tottime"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(30)
        print(out.getvalue(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
