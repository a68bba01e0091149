"""Step tracing — nested ``span()`` blocks exported as Chrome-trace JSON.

Counterpart of ``analytics_zoo_tpu/metrics/tracing.py``.  Every
``with span("zoo.train.step")`` records one complete event (``ph: "X"``)
into the process-global :class:`Tracer`; ``Tracer.to_chrome_trace()``
renders the ``chrome://tracing`` / Perfetto-loadable document, the same
format ``torch.profiler`` traces use, so the two timelines can be read
side by side.

Spans nest through a :mod:`contextvars` variable, so nesting is correct
across threads (the serving loop thread and the infeed thread each get
their own span stack) and each event records its parent span's name.

Two device hooks:

- ``span(..., sync=tree)`` synchronizes every CUDA device that holds a
  tensor of the tree before closing the span (the reference's
  ``jax.block_until_ready``), so the span covers device execution and not
  just the asynchronous launches.  A sync inside a CUDA graph capture
  would end the capture: it raises instead.  Spans wrap a captured
  step's replay, never the captured function.
- ``Tracer(profiler_bridge=True)`` (default) also wraps each span in
  ``torch.profiler.record_function`` while a ``torch.profiler`` session
  is recording, so zoo spans show by name in the ``ZOO_PROFILE_DIR``
  traces.  With no session recording it costs one flag read.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time

__all__ = ["Tracer", "span", "get_tracer", "set_tracer"]

# Innermost open span's name (per execution context / thread).
_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "zoo_current_span", default=None)


def _block_until_ready(tree):
    """Synchronize every CUDA device holding a tensor of ``tree`` (nested
    lists, tuples and dicts); no-op for host values."""
    import torch

    devices = set()

    def visit(x):
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    if devices and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "span(sync=...) inside a CUDA graph capture: a sync would end "
            "the capture; wrap the replay, not the captured function")
    for d in sorted(devices, key=str):
        torch.cuda.synchronize(d)


def _profiler_recording() -> bool:
    import torch.autograd.profiler as prof

    return bool(prof._is_profiler_enabled)


class Tracer:
    """Bounded in-memory event sink.

    ``max_events`` caps memory on multi-day jobs as a RING buffer: past
    the cap the OLDEST events are evicted and counted (``dropped``),
    never silently — the export carries the eviction count as metadata.
    Keeping the newest window is the debugging-shaped choice: the trace
    an operator saves after a day-2 anomaly must contain day 2, not the
    first hour of startup spans.
    """

    def __init__(self, enabled: bool = True, max_events: int = 50_000,
                 profiler_bridge: bool = True):
        import collections

        self.enabled = bool(enabled)
        self.max_events = int(max_events)
        self.profiler_bridge = bool(profiler_bridge)
        self.dropped = 0  # guarded-by: _lock
        self._events: collections.deque = collections.deque(  # guarded-by: _lock
            maxlen=self.max_events)
        self._lock = threading.Lock()
        # registry counter mirroring `dropped`, resolved lazily on the
        # first eviction (constructing a Tracer must not force the
        # process-global registry into existence)
        self._drop_counter = None
        # perf_counter origin so ts fields are small positive
        # microseconds — plus a (monotonic, epoch) anchor captured at
        # the SAME instant, so tools/flight_merge.py can place this
        # process's µs timeline on the cluster-wide wall clock (each
        # process's trace clock alone is only self-consistent)
        self._t0 = time.perf_counter()
        self._t0_monotonic = time.monotonic()
        self._t0_epoch = time.time()

    # -- recording ------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def add_event(self, name: str, ts_us: float, dur_us: float,
                  args: dict | None = None):
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "X",
            "ts": ts_us,
            "dur": dur_us,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "cat": "zoo",
        }
        if args:
            ev["args"] = args
        evicting = False
        with self._lock:
            if len(self._events) == self.max_events:
                self.dropped += 1  # deque evicts the oldest on append
                evicting = True
            self._events.append(ev)
        if evicting:
            # ring evictions were silent before: a
            # scraper watching zoo_trace_spans_dropped_total now sees a
            # trace outgrowing its window without pulling /trace
            if self._drop_counter is None:
                from analytics_zoo_tpu_torch.metrics.registry import (
                    get_registry,
                )

                self._drop_counter = get_registry().counter(
                    "zoo_trace_spans_dropped_total",
                    "span events evicted from the tracer ring buffer")
            self._drop_counter.inc()

    # -- export ---------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clock_anchor(self) -> dict:
        """The trace-origin instant on three clocks: ``ts=0`` µs of
        this trace corresponds to ``epoch`` wall time and ``monotonic``
        (CLOCK_MONOTONIC — shared by all processes of one boot, so
        same-host merges can sidestep wall-clock skew entirely)."""
        return {"epoch": self._t0_epoch,
                "monotonic": self._t0_monotonic,
                "pid": os.getpid()}

    def to_chrome_trace(self) -> dict:
        """The ``chrome://tracing`` JSON object format."""
        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "metadata": {"producer":
                         "analytics_zoo_tpu_torch.metrics.tracing",
                         "dropped_events": self.dropped,
                         "clock_anchor": self.clock_anchor()},
        }
        return doc

    def save(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def clear(self):
        with self._lock:
            self._events.clear()
            self.dropped = 0


@contextlib.contextmanager
def span(name: str, sync=None, args: dict | None = None,
         tracer: Tracer | None = None):
    """Time a block as one trace event; nests via contextvars.

    Args:
      name: event name (dotted convention: ``zoo.train.step``).
      sync: optional tree of tensors whose CUDA devices are synchronized
        before the span closes: the span then covers device execution,
        not just the asynchronous launches.
      args: extra key/values attached to the event.
      tracer: override the process-global tracer (tests).
    """
    t = tracer if tracer is not None else get_tracer()
    if not t.enabled:
        # cheap disabled path: no contextvar churn, no event dict
        yield
        if sync is not None:
            _block_until_ready(sync)
        return
    parent = _current_span.get()
    token = _current_span.set(name)
    annot = None
    if t.profiler_bridge and _profiler_recording():
        from torch.profiler import record_function

        annot = record_function(name)
        annot.__enter__()
    t0 = t.now_us()
    try:
        yield
        if sync is not None:
            _block_until_ready(sync)
    finally:
        dur = t.now_us() - t0
        if annot is not None:
            annot.__exit__(None, None, None)
        _current_span.reset(token)
        ev_args = dict(args) if args else {}
        if parent is not None:
            ev_args["parent"] = parent
        t.add_event(name, t0, dur, ev_args or None)


# ---------------------------------------------------------------------------
# Process-global default tracer.  ZOO_TRACE=0 disables span recording;
# ZOO_TRACE_EVENTS overrides the event cap.
# ---------------------------------------------------------------------------

_default: Tracer | None = None  # guarded-by: _default_lock
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                env = os.environ
                _default = Tracer(
                    enabled=env.get("ZOO_TRACE", "1") != "0",
                    max_events=int(env.get("ZOO_TRACE_EVENTS", "50000")),
                )
    return _default


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer; returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, tracer
    return prev
