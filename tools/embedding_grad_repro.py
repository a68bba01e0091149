#!/usr/bin/env python3
"""Is an embedding table's gradient bit-reproducible on the GPU?

For each (rows, width, ids) case, computes the table's gradient of a
lookup seven times and reports whether every run equals the first, the
largest difference seen, and the mean time of a forward and backward
(CUDA events over 20 calls): for ``F.embedding`` on all the ids at once,
and for the port's ``layers.embedding.lookup`` (which gathers heavily
repeated ids in chunks).  The cases are the smoke's tables: the taggers'
character table (24,576 ids over 100 rows), their word table, the
TextClassifier's and KNRM's.

    python3 tools/embedding_grad_repro.py
"""

import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embedding import (  # noqa: E402
    lookup,
)

CASES = ((100, 30, (32, 768)), (1000, 30, (32, 768)), (20000, 100, (32, 64)),
         (20000, 200, (128, 500)), (20000, 300, (200, 40)))


def grad_of(fn, table, ids, g):
    t = table.detach().requires_grad_()
    (gt,) = torch.autograd.grad(fn(t, ids), t, g)
    return gt


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    torch.manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    for rows, width, shape in CASES:
        table = torch.randn(rows, width, device="cuda")
        ids = torch.randint(0, rows, shape, device="cuda")
        g = torch.randn(shape + (width,), device="cuda")
        for name, fn in (("F.embedding", lambda t, i: F.embedding(i, t)),
                         ("lookup", lookup)):
            ref = grad_of(fn, table, ids, g)
            diff = max(float((grad_of(fn, table, ids, g) - ref).abs().max())
                       for _ in range(6))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                grad_of(fn, table, ids, g)
            end.record()
            torch.cuda.synchronize()
            print(f"rows {rows} width {width} ids {ids.numel()} {name}: "
                  f"reproducible {diff == 0.0}, largest difference "
                  f"{diff:.3e}, {start.elapsed_time(end) / 20:.3f} ms",
                  flush=True)


if __name__ == "__main__":
    main()
