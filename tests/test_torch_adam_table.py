"""The one-launch fused Adam's leaf table and flat output buffers, on the
CPU.

On the card ``fused_update`` hands every f32 leaf of at least 128 elements
to one kernel launch, with a table of the leaves and their outputs as
views into three flat buffers (updates, mu', nu').  These tests check the
layout those views come from (leaf order, shapes, 16-byte aligned offsets
that never overlap), that the routing leaves small and non-f32 leaves on
the plain formula, and that an optimizer state made of such views behaves
as separate leaves: writes stay in their leaf and ``torch.save`` /
``torch.load`` round-trips it.  The kernel itself is held against the
plain version on a GPU in tests/test_torch_training_kernels.py.  Nothing
here imports the JAX package.
"""

import io

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops.cuda import fused_adam as tadam
from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as topt

SHAPES = [(768, 2304), (2304,), (3,), (129,), (5, 7, 11), (1,), (4099,)]


def _layout(shapes=SHAPES):
    return tadam._Layout([tuple(s) for s in shapes])


def test_layout_offsets_are_ordered_aligned_and_disjoint():
    lay = _layout()
    sizes = [int(np.prod(s)) for s in SHAPES]
    assert lay.sizes == sizes
    assert lay.offsets[0] == 0
    assert all(o % 4 == 0 for o in lay.offsets)  # 16 bytes of f32
    ends = [o + n for o, n in zip(lay.offsets, sizes)]
    assert all(e <= o for e, o in zip(ends, lay.offsets[1:]))
    assert lay.total == -(-ends[-1] // 4) * 4
    assert lay.table[:, 3].tolist() == lay.offsets
    assert lay.table[:, 4].tolist() == sizes
    assert lay.launches == 1
    assert _layout([(128,)] * (tadam.TABLE_LEAVES + 1)).launches == 2


def test_views_are_separate_contiguous_leaves():
    lay = _layout()
    flat = torch.zeros(lay.total)
    views = lay.views(flat)
    assert [tuple(v.shape) for v in views] == SHAPES
    assert all(v.is_contiguous() for v in views)
    for i, v in enumerate(views):
        v.fill_(i + 1)
    for i, v in enumerate(views):  # no write reached another leaf
        assert torch.equal(v, torch.full(SHAPES[i], float(i + 1)))
    # the padding between leaves was never written
    assert int((flat != 0).sum()) == sum(v.numel() for v in views)


def test_state_of_views_round_trips_through_save_and_load():
    lay = _layout()
    gen = torch.Generator().manual_seed(0)
    mu_flat, nu_flat = (torch.randn(lay.total, generator=gen)
                        for _ in range(2))
    state = topt.AdamState(torch.tensor(3, dtype=torch.int32),
                           {"w": lay.views(mu_flat)},
                           {"w": lay.views(nu_flat)})
    buf = io.BytesIO()
    torch.save(state._asdict(), buf)
    buf.seek(0)
    loaded = topt.AdamState(**torch.load(buf))
    assert int(loaded.count) == 3
    for a, b in zip(state.mu["w"] + state.nu["w"],
                    loaded.mu["w"] + loaded.nu["w"]):
        assert torch.equal(a, b) and a.shape == b.shape
    loaded.mu["w"][0].zero_()  # writes stay in their leaf
    assert torch.equal(loaded.mu["w"][1], state.mu["w"][1])
    assert not torch.equal(state.mu["w"][0], loaded.mu["w"][0])
    # as numpy arrays (a model's weights are saved that way), one per leaf
    arrays = [t.numpy().copy() for t in loaded.nu["w"]]
    assert [a.shape for a in arrays] == SHAPES


class _OnCuda:
    """A CPU tensor that reports a CUDA device."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_only_f32_leaves_of_128_or_more_go_to_the_one_launch(monkeypatch):
    leaves = [torch.ones(128), torch.ones(127), torch.ones(4, 64),
              torch.ones(300, dtype=torch.float64),
              torch.ones(300, dtype=torch.bfloat16), torch.ones(1000)]
    calls, plain = [], []

    def fake_cuda(grads, mu, nu, scalars):
        calls.append([g._t for g in grads])
        return tuple([torch.zeros(g.shape) for g in grads] for _ in range(3))

    monkeypatch.setattr(tadam, "_adam_cuda", fake_cuda)
    monkeypatch.setattr(tadam, "adam_leaf_reference",
                        lambda g, m, n, s: plain.append(g._t) or (g, m, n))
    on = [_OnCuda(t) for t in leaves]
    upd, _, _ = tadam.fused_update(on, on, on, _OnCuda(torch.zeros(6)))
    assert len(calls) == 1
    assert [t is leaves[i] for i, t in zip((0, 2, 5), calls[0])] == [True] * 3
    assert len(calls[0]) == 3
    assert [id(t) for t in plain] == [id(leaves[i]) for i in (1, 3, 4)]
    assert [tuple(u.shape) for u in upd] == [tuple(t.shape) for t in leaves]
    # the xla pick: no launch, every leaf plain
    calls.clear()
    plain.clear()
    tadam.fused_update(on, on, on, _OnCuda(torch.zeros(6)), kernel=False)
    assert calls == [] and len(plain) == len(leaves)


def test_cpu_leaves_take_the_plain_version_leaf_by_leaf():
    leaves = [torch.ones(200), torch.ones(3)]
    scalars = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.1, 0.001])
    before = tadam.plain_count, tadam.launch_count
    tadam.fused_update(leaves, [torch.zeros_like(t) for t in leaves],
                       [torch.zeros_like(t) for t in leaves], scalars)
    assert (tadam.plain_count, tadam.launch_count) == (before[0] + 1,
                                                        before[1])


def test_layout_is_checked_once_per_tree_structure():
    on = [_OnCuda(torch.zeros(s)) for s in ((256,), (3, 129))]
    first = tadam._layout(on, on, on)
    assert tadam._layout(on, on, on) is first  # cached
    assert first.shapes == [(256,), (3, 129)]
    other = [_OnCuda(torch.zeros(s)) for s in ((256,), (129, 3))]
    assert tadam._layout(other, other, other) is not first
    bad = [_OnCuda(torch.zeros(256)), _OnCuda(torch.zeros(3, 128))]
    with pytest.raises(TypeError, match="leaf 1"):
        tadam._layout(on, on, bad)
    meta = [torch.zeros(256, device="meta")] * 2
    with pytest.raises(ValueError, match="no kernel"):
        tadam._layout(meta, meta, meta)
