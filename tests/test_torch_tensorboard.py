"""The port's TensorBoard writer against the reference's.

The event bytes (the TFRecord framing with its masked CRC32C, the Event
and Summary protos) must be the reference's at a fixed wall time; the CRC
must give the CRC-32C check values; and a fit's summaries (``Loss`` for
every step, ``Throughput`` once an epoch, the validation results) must
sit on the reference's iteration numbers with the reference's values, to
the tolerance of the other fit twins (losses within 1e-5 relative).
"""

import io
import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.tensorboard import record as jrec
from analytics_zoo_tpu_torch.common import engine
from analytics_zoo_tpu_torch.tensorboard import (
    FileWriter,
    InferenceSummary,
    TrainSummary,
    ValidationSummary,
)
from analytics_zoo_tpu_torch.tensorboard import record as trec

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _restore():
    saved = engine._CONTEXT
    yield
    engine._CONTEXT = saved


@pytest.mark.parametrize("data,want", [
    (b"", 0x00000000),
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),
    (bytes([0xFF] * 32), 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
])
def test_crc32c_check_values(data, want):
    assert trec.crc32c(data) == want
    assert trec.masked_crc(data) == jrec.masked_crc(data)


@pytest.mark.parametrize("step,tag,value", [
    (0, "Loss", 0.5), (1, "Loss", -3.25), (127, "Throughput", 1234.5),
    (128, "Top1Accuracy", 0.875), (300000, "Loss", 1e-9),
])
def test_event_bytes_match_the_reference(step, tag, value):
    wall = 1792315734.5608187
    for fv in (None, "brain.Event:2"):
        want = jrec.encode_event(step=step, wall_time=wall,
                                 summary=jrec.encode_scalar_summary(
                                     tag, value), file_version=fv)
        got = trec.encode_event(step=step, wall_time=wall,
                                summary=trec.encode_scalar_summary(
                                    tag, value), file_version=fv)
        assert got == want
        a, b = io.BytesIO(), io.BytesIO()
        jrec.write_record(a, want)
        trec.write_record(b, got)
        assert b.getvalue() == a.getvalue()
        assert list(trec.decode_event_scalars(got)) == list(
            jrec.decode_event_scalars(want))


def test_summaries_write_and_read_back(tmp_path):
    train = TrainSummary(str(tmp_path), "app")
    val = ValidationSummary(str(tmp_path), "app")
    inf = InferenceSummary(str(tmp_path), "app")
    for i in range(1, 4):
        train.add_scalar("Loss", 1.0 / i, i)
    val.add_scalar("Top1Accuracy", 0.5, 3)
    inf.add_scalar("Throughput", 10.0, 1)
    assert [(s, v) for s, v, _ in train.read_scalar("Loss")] == [
        (1, 1.0), (2, 0.5), (3, np.float32(1 / 3))]
    assert [(s, v) for s, v, _ in val.read_scalar("Top1Accuracy")] == [
        (3, 0.5)]
    assert os.path.isdir(tmp_path / "app" / "inference")
    for w in (train, val, inf):
        w.close()
        assert w.closed
    train.add_scalar("Loss", 9.0, 9)  # a closed writer drops events
    assert len(train.read_scalar("Loss")) == 3
    fw = FileWriter(str(tmp_path / "raw"))
    fw.add_scalar("x", 2.0, 5)
    fw.close()
    with open(fw.path, "rb") as fh:
        recs = list(trec.read_records(fh))
    assert len(recs) == 2  # the file-version event, then the scalar


def test_fit_summaries_match_the_jax_package(tmp_path):
    """Two epochs of an MLP (with validation) in both packages from the
    same weights: the ``Loss`` scalars read back equal the port's
    ``loss_log``, and they, ``Throughput``'s steps and the validation
    scalars agree with the reference's summaries."""
    import jax

    from analytics_zoo_tpu import init_zoo_context as jax_init
    from analytics_zoo_tpu.common import engine as jax_engine
    from analytics_zoo_tpu.pipeline.api import keras as jkeras
    from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.convert import params_from_jax
    from analytics_zoo_tpu_torch.pipeline.api import keras as tkeras
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tlayers

    torch.set_num_threads(1)
    saved = jax_engine._CONTEXT
    try:
        jax_init(seed=3)
        init_zoo_context(seed=3, device="cpu")
        nets = []
        for keras, layers, tag in ((jkeras, jlayers, "jax"),
                                   (tkeras, tlayers, "torch")):
            net = keras.Sequential()
            net.add(layers.Dense(16, activation="tanh", input_shape=(6,)))
            net.add(layers.Dense(3, activation="softmax"))
            net.compile(optimizer="adam",
                        loss="sparse_categorical_crossentropy",
                        metrics=["accuracy"])
            net.build_params()
            net.set_tensorboard(str(tmp_path / tag), "app")
            nets.append(net)
        jnet, tnet = nets
        tnet.set_weights(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
        rng = np.random.default_rng(4)
        x = rng.normal(size=(48, 6)).astype(np.float32)
        y = rng.integers(0, 3, 48).astype(np.int32)
        for net in nets:
            net.fit(x, y, batch_size=8, nb_epoch=2,
                    validation_data=(x[:16], y[:16]))
        jw, tw = jnet._estimator._writers, tnet._estimator._writers
        tloss = [(s, v) for s, v, _ in tw[0].read_scalar("Loss")]
        log = tnet._estimator.loss_log
        assert [s for s, _ in tloss] == [s for s, _ in log] == list(
            range(1, 13))
        assert [v for _, v in tloss] == [np.float32(v) for _, v in log]
        jloss = {s: v for s, v, _ in jw[0].read_scalar("Loss")}
        assert sorted(jloss) == list(range(1, 13))
        for s, v in tloss:
            assert v == pytest.approx(jloss[s], rel=LOSS_RTOL), s
        assert [s for s, _, _ in tw[0].read_scalar("Throughput")] == [
            s for s, _, _ in jw[0].read_scalar("Throughput")] == [6, 12]
        for tag in ("loss", "accuracy"):
            got = [(s, v) for s, v, _ in tw[1].read_scalar(tag)]
            want = [(s, v) for s, v, _ in jw[1].read_scalar(tag)]
            assert [s for s, _ in got] == [s for s, _ in want] == [6, 12]
            for (_, a), (_, b) in zip(got, want):
                assert a == pytest.approx(b, rel=LOSS_RTOL, abs=1e-6), tag
    finally:
        jax_engine._CONTEXT = saved
