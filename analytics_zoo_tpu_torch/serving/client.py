"""Cluster Serving client (reference pyzoo/zoo/serving/client.py).

``InputQueue.enqueue_image`` pushes (uri, tensor) onto the input stream;
``OutputQueue.query/dequeue`` reads prediction results back.  Tensors travel
base64-encoded (npy bytes) like the reference's base64 JPEG strings
(client.py:122 ``base64_encode_image``), but dtype/shape-preserving.
"""

from __future__ import annotations

import base64
import io
import time

import numpy as np

from .broker import connect_broker

INPUT_STREAM = "image_stream"  # reference stream key, ClusterServing.scala:108
RESULT_PREFIX = "result:"
# Front-door admission verdict hash per stream (serving/admission.py):
# {"state": "accept"|"shed", "retry_after_ms", "reason", "ts"}.  The
# client reads it at enqueue; an absent hash means no admission
# controller guards the stream and every enqueue is accepted.
ADMISSION_KEY_PREFIX = "admission:"


def model_stream(model: str) -> str:
    """Input stream for one routed model (serving/router.py): the
    single-tenant default stream stays ``image_stream`` so existing
    clients are untouched; routed models get ``model_stream:<name>``."""
    return f"model_stream:{model}"


class ServingRejected(RuntimeError):
    """The admission controller shed this enqueue at the front door.

    Typed like :class:`ServingTimeout`: carries the ``uri``, the
    ``retry_after_s`` hint the verdict published (obey it — the
    controller sized it from the backlog drain rate), and the
    ``reason`` (broker_pressure / slo_burn / backlog).  Raised BEFORE
    the record enters the stream — a rejected request was never
    accepted, so the exactly-once guarantee over accepted work is
    undiluted."""

    def __init__(self, uri: str, retry_after_s: float, reason: str = ""):
        super().__init__(
            f"enqueue of {uri!r} shed by admission control"
            f"{f' ({reason})' if reason else ''}; retry after "
            f"{retry_after_s:.2f}s")
        self.uri = uri
        self.retry_after_s = float(retry_after_s)
        self.reason = reason


class ServingTimeout(TimeoutError):
    """A result did not arrive within the polling deadline.

    Carries the ``uri`` and the ``timeout`` that elapsed, so callers can
    requeue or alert on the specific lost record instead of parsing a
    message string."""

    def __init__(self, uri: str, timeout: float):
        super().__init__(
            f"no result for {uri!r} within {timeout:.1f}s — the record "
            "was trimmed under backpressure, dropped as undecodable, or "
            "the serving fleet is down (check /healthz and "
            "zoo_serving_backpressure_trims_total)")
        self.uri = uri
        self.timeout = timeout


def encode_ndarray(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_ndarray(s: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(s)), allow_pickle=False)


class API:
    """Shared connection state (reference client.py:25-56).

    ``model`` routes to a per-model stream (serving/router.py);
    ``stream`` overrides the stream name directly.  Default: the
    single-tenant ``image_stream``."""

    def __init__(self, broker=None, host: str = "localhost",
                 port: int = 6379, model: str | None = None,
                 stream: str | None = None):
        if broker is None:
            broker = f"{host}:{port}"
        self.db = connect_broker(broker)
        self.stream = stream if stream is not None else (
            model_stream(model) if model else INPUT_STREAM)


class InputQueue(API):
    def enqueue_image(self, uri: str, data) -> None:
        """Push one record.  ``data``: ndarray, or a path to ``.npy`` /
        an image file (decoded via PIL when available).

        When an admission controller guards this stream
        (serving/admission.py publishes its verdict under
        ``admission:<stream>``), a shedding verdict raises
        :class:`ServingRejected` BEFORE the record is added — the one
        extra broker read per enqueue is the price of never trimming
        accepted work."""
        if isinstance(data, str):
            if data.endswith(".npy"):
                data = np.load(data)
            else:
                try:
                    from PIL import Image
                except ImportError as e:
                    raise ImportError(
                        "decoding image files needs PIL; pass an ndarray "
                        "or .npy path instead") from e
                data = np.asarray(Image.open(data))
        arr = np.asarray(data)
        verdict = self.db.hgetall(ADMISSION_KEY_PREFIX + self.stream)
        if verdict and verdict.get("state") == "shed":
            raise ServingRejected(
                uri,
                retry_after_s=float(verdict.get("retry_after_ms", 1000.0))
                / 1e3,
                reason=verdict.get("reason", ""))
        self.db.xadd(self.stream, {"uri": uri,
                                   "image": encode_ndarray(arr)})

    enqueue = enqueue_image

    def backlog(self) -> int:
        return self.db.xlen(self.stream)


class OutputQueue(API):
    def query(self, uri: str):
        """Result for one uri, or None if not ready (client.py:142)."""
        h = self.db.hgetall(RESULT_PREFIX + uri)
        if not h:
            return None
        return _decode_result(h)

    def poll(self, uri: str, timeout: float = 30.0,
             initial_delay: float = 0.005, max_delay: float = 0.25):
        """Block until the result for ``uri`` arrives; raise
        :class:`ServingTimeout` after ``timeout`` seconds.

        Polling backs off exponentially from ``initial_delay`` up to
        ``max_delay`` — a just-served result returns in milliseconds,
        while a slow batch costs at most ``max_delay`` staleness and a
        LOST record (trimmed under backpressure, undecodable) costs a
        bounded number of broker round-trips instead of a spin loop that
        hammers the broker forever."""
        deadline = time.monotonic() + timeout
        delay = max(initial_delay, 1e-4)
        while True:
            res = self.query(uri)
            if res is not None:
                return res
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ServingTimeout(uri, timeout)
            time.sleep(min(delay, remaining))
            delay = min(delay * 2, max_delay)

    def dequeue(self) -> dict:
        """All finished results keyed by uri, removing them from the
        broker (reference client.py:131 ``dequeue``)."""
        out = {}
        for key in self.db.keys(RESULT_PREFIX):
            h = self.db.hgetall(key)
            if not h:
                continue
            # key on the uri stored IN the hash: broker key names may be
            # transport-mangled (FileBroker replaces "/")
            uri = h.get("uri", key[len(RESULT_PREFIX):])
            out[uri] = _decode_result(h)
            self.db.delete(key)
        return out


def _decode_result(h: dict):
    if "value" in h:
        import json
        return json.loads(h["value"])
    if "tensor" in h:
        return decode_ndarray(h["tensor"])
    return h
