"""Event-file writers — reference tensorboard/FileWriter.scala:32-88 and the
TrainSummary/ValidationSummary API on KerasNet (Topology.scala:183-236,
including scalar read-back ``getTrainSummary("Loss"/"Throughput")``).

The port's own copy of ``analytics_zoo_tpu/tensorboard/writer.py``: the
same files under the same directories, with the same bytes.
"""

from __future__ import annotations

import os
import socket
import threading
import time

from analytics_zoo_tpu_torch.tensorboard.record import (
    decode_event_scalars,
    encode_event,
    encode_scalar_summary,
    read_records,
    write_record,
)


class FileWriter:
    """Appends Event protos to a tfevents file (FileWriter.scala:32-88)."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%d.%s%s" % (
            int(time.time()), socket.gethostname(), filename_suffix
        )
        self.path = os.path.join(log_dir, fname)
        # writes AND close serialize on _lock: a concurrent _write either
        # completes before the close or sees closed-and-drops
        self._fh = open(self.path, "ab")  # guarded-by: _lock
        self._lock = threading.Lock()
        self._write(encode_event(file_version="brain.Event:2"))

    def _write(self, event: bytes):
        with self._lock:
            # a closed writer drops events instead of raising: serving's
            # run() closes its summary on loop exit, and a concurrently
            # finishing batch (or a later warm-up run() on the same server
            # object) must not crash on the trailing Throughput scalar
            if self._fh.closed:
                return
            write_record(self._fh, event)
            self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write(
            encode_event(step=step,
                         summary=encode_scalar_summary(tag, float(value)))
        )

    def close(self):
        # under the lock: a concurrent _write must either complete before
        # the close or observe closed-and-drop — never write a closed fh
        with self._lock:
            self._fh.close()

    @property
    def closed(self) -> bool:
        return self._fh.closed


class _SummaryBase:
    """A named sub-writer under <log_dir>/<app_name>/<kind> — mirrors the
    reference's TrainSummary/ValidationSummary directory convention."""

    kind = "train"

    def __init__(self, log_dir: str, app_name: str):
        self.dir = os.path.join(log_dir, app_name, self.kind)
        self._writer = FileWriter(self.dir)

    def add_scalar(self, tag: str, value: float, step: int):
        self._writer.add_scalar(tag, value, step)

    def read_scalar(self, tag: str):
        """Read back [(step, value, wall_time)] for a tag (reference
        ``getScalar``/``getTrainSummary`` Topology.scala:204-236)."""
        out = []
        for fname in sorted(os.listdir(self.dir)):
            if "tfevents" not in fname:
                continue
            with open(os.path.join(self.dir, fname), "rb") as fh:
                for rec in read_records(fh):
                    for wall, step, t, v in decode_event_scalars(rec):
                        if t == tag:
                            out.append((step, v, wall))
        return out

    def close(self):
        self._writer.close()

    @property
    def closed(self) -> bool:
        return self._writer.closed


class TrainSummary(_SummaryBase):
    kind = "train"


class ValidationSummary(_SummaryBase):
    kind = "validation"


class InferenceSummary(_SummaryBase):
    """Reference inference/InferenceSummary.scala."""

    kind = "inference"
