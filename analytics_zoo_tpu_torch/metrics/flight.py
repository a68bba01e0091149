"""Crash flight recorder — the last N structured events, dumped on death.

A crashed run's registry dies with the process; what a postmortem needs
is the *sequence of final steps* — which step was in flight, whether it
was a straggler, which component went stale, what exception fired.  The
:class:`FlightRecorder` is a bounded ring of structured events (dicts)
fed by the estimator fit loop, ``ClusterServing.step()`` and the health
rollup; on ``atexit``, ``SIGTERM`` or an unhandled exception the ring is
dumped as JSON into ``ZOO_FLIGHT_DIR`` (one file per pid, atomic
rename), and a live process serves the same ring at ``/flightz``
(:mod:`analytics_zoo_tpu_torch.metrics.http`).

The black-box-recorder shape (bounded, newest-window, always-on) follows
the Tracer ring (tracing.py): a multi-day job's recorder is O(capacity)
forever, and the window an operator reads after a day-2 crash contains
day 2.  Disable with ``ZOO_FLIGHT=0`` (then ``record`` is a cheap early
return); cap with ``ZOO_FLIGHT_EVENTS`` (default 4096).

:class:`StragglerDetector` is the per-step anomaly flagger: a step
slower than ``k`` x the rolling p50 of recent steps is a straggler (the
multi-host stall signature — one slow host drags every SPMD step), and
the fit loop records it as a ``straggler`` event.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

__all__ = ["FlightRecorder", "StragglerDetector", "StragglerBoard",
           "get_flight_recorder", "set_flight_recorder",
           "register_predump_hook"]


# ---------------------------------------------------------------------------
# Pre-dump hooks: subsystems with in-flight background work (the async
# checkpoint writer) register a flush here so a SIGTERM/exit/crash dump
# contains their FINAL event (e.g. the ``ckpt`` complete/error record)
# instead of racing the writer thread to process death.  Hooks must be
# bounded (join with timeout) and exception-safe; a dying process never
# dies harder over a hook.
# ---------------------------------------------------------------------------

_predump_lock = threading.Lock()
_predump_hooks: list = []  # guarded-by: _predump_lock


def register_predump_hook(fn) -> None:
    """Run ``fn()`` before any flight dump is written (idempotent per
    function object).  Used by the async checkpointer so the shutdown
    ordering is: flush pending snapshot -> record its ``ckpt`` event ->
    write the flight dump -> exit."""
    with _predump_lock:
        if fn not in _predump_hooks:
            _predump_hooks.append(fn)


def _run_predump_hooks() -> None:
    with _predump_lock:
        hooks = list(_predump_hooks)
    for fn in hooks:
        try:
            fn()
        except Exception:  # noqa: BLE001 - dump path must never raise
            pass


class FlightRecorder:
    """Bounded ring of structured events + crash/exit dump hooks."""

    def __init__(self, capacity: int = 4096, dump_dir: str | None = None,
                 enabled: bool = True):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.dropped = 0  # guarded-by: _lock
        self._events: collections.deque = collections.deque(  # guarded-by: _lock
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._installed = False
        self._dumped_reasons: set[str] = set()  # guarded-by: _lock

    # -- recording ------------------------------------------------------
    def record(self, kind: str, **fields) -> dict | None:
        """Append one event; returns it (None when disabled).

        Events carry a ``(mono, ts)`` clock pair:
        CLOCK_MONOTONIC is shared across processes of one boot, so
        ``tools/flight_merge.py`` can align dumps from many processes
        on one timeline without trusting each process's wall clock."""
        if not self.enabled:
            return None
        ev = {"ts": time.time(), "mono": time.monotonic(), "kind": kind}
        ev.update(fields)
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1  # deque evicts the oldest on append
            self._events.append(ev)
        return ev

    def record_exception(self, exc: BaseException, where: str = ""):
        """One ``exception`` event carrying type/message/traceback tail
        (last frames only — the ring holds many events, not one core
        dump)."""
        import traceback

        tb = traceback.format_exception(type(exc), exc, exc.__traceback__)
        self.record("exception", where=where,
                    exc_type=type(exc).__name__, message=str(exc),
                    traceback="".join(tb[-6:]))

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        return evs

    def clear(self):
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # -- dumping --------------------------------------------------------
    def to_doc(self, reason: str = "live") -> dict:
        # (monotonic, epoch) captured back-to-back: the merge tool's
        # per-process offset estimate even for docs whose events
        # predate the per-event `mono` field
        return {
            "reason": reason,
            "pid": os.getpid(),
            "dumped_unix": time.time(),
            "clock_anchor": {"epoch": time.time(),
                             "monotonic": time.monotonic()},
            "dropped_events": self.dropped,
            "events": self.events(),
        }

    def dump(self, reason: str) -> str | None:
        """Write the ring to ``dump_dir`` (atomic rename); one file per
        (pid, reason) so the atexit pass after a SIGTERM dump doesn't
        overwrite the more interesting earlier snapshot.  Returns the
        path, or None when no dir is configured / already dumped."""
        if not self.dump_dir or not self.enabled:
            return None
        with self._lock:
            if reason in self._dumped_reasons:
                return None
            self._dumped_reasons.add(reason)
        # Shutdown ordering fix: flush registered background writers
        # BEFORE snapshotting the ring, so their final events (the async
        # checkpointer's ``ckpt`` complete) are IN this dump.  Runs
        # outside ``_lock`` — hooks record events themselves.
        _run_predump_hooks()
        path = os.path.join(self.dump_dir,
                            f"flight-{os.getpid()}-{reason}.json")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.to_doc(reason), f)
            os.replace(tmp, path)
        except OSError:
            return None  # a dying process must not die harder over this
        return path

    # -- death hooks ----------------------------------------------------
    def install(self) -> "FlightRecorder":
        """Arm atexit + SIGTERM + unhandled-exception dumps (idempotent).

        Existing handlers are CHAINED, not replaced: the prior excepthook
        still prints the traceback, a prior SIGTERM handler still runs.
        Signal installation is skipped off the main thread (signal.signal
        raises there) and when a non-default SIGTERM handler belongs to
        an embedding app we chain to it.
        """
        if self._installed:
            return self
        self._installed = True
        import atexit
        import signal
        import sys

        atexit.register(lambda: self.dump("exit"))

        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            try:
                e = exc if exc is not None else exc_type()
                e.__traceback__ = tb
                self.record_exception(e, where="unhandled")
                self.dump("crash")
            finally:
                prev_hook(exc_type, exc, tb)

        sys.excepthook = hook

        try:
            prev_sig = signal.getsignal(signal.SIGTERM)
            if prev_sig is None:
                # a C-level handler we cannot call or restore from
                # Python: leave it alone entirely (atexit still dumps)
                return self

            def on_term(signum, frame):
                self.record("signal", signal="SIGTERM")
                self.dump("sigterm")
                if prev_sig == signal.SIG_IGN:
                    return  # the app IGNORES SIGTERM: keep it alive
                if callable(prev_sig):
                    prev_sig(signum, frame)
                else:  # SIG_DFL: re-deliver with default disposition
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, on_term)
        except (ValueError, OSError):
            pass  # not the main thread (embedded run): atexit still fires
        return self


class StragglerDetector:
    """Flag steps exceeding ``k`` x the rolling p50 of recent steps.

    The p50 baseline (not the mean) makes the detector robust to the
    stragglers themselves: ten 30s stalls in a 128-step window barely
    move the median, so the threshold stays anchored to the *typical*
    step.  ``min_steps`` suppresses verdicts until the window has enough
    history to mean something (compile steps would otherwise flag the
    whole warmup).
    """

    def __init__(self, k: float = 3.0, window: int = 128,
                 min_steps: int = 20):
        if k <= 1.0:
            raise ValueError(f"straggler factor k={k} must be > 1")
        self.k = float(k)
        self.min_steps = int(min_steps)
        self._window: collections.deque = collections.deque(  # guarded-by: _lock
            maxlen=int(window))
        self._lock = threading.Lock()

    @staticmethod
    def _median(vals: list) -> float:
        if not vals:
            return 0.0
        mid = len(vals) // 2
        return vals[mid] if len(vals) % 2 \
            else 0.5 * (vals[mid - 1] + vals[mid])

    def rolling_p50(self) -> float:
        with self._lock:
            vals = sorted(self._window)
        return self._median(vals)

    def observe(self, seconds: float) -> bool:
        """Record one step duration; True iff it is a straggler against
        the *prior* window (the step never dilutes its own baseline)."""
        with self._lock:
            vals = sorted(self._window)
            self._window.append(seconds)
        if len(vals) < self.min_steps:
            return False
        return seconds > self.k * self._median(vals)


class StragglerBoard:
    """Per-WORKER rolling-p50 slowdown factors (the elastic-training
    rebalance signal).

    :class:`StragglerDetector` answers "was THIS step a straggler";
    the board answers "which worker is persistently slow, and by how
    much" — ``observe(worker, step_s)`` feeds one worker's step time
    and returns that worker's slowdown factor: its rolling p50 over the
    median of every worker's rolling p50 (the fleet baseline).  1.0
    means on-pace; ``k`` means k x slower than the typical worker.  The
    supervisor's micro-batch rebalancer consumes :meth:`factors`
    instead of reaching into flight internals.

    Per-worker p50s (not pooled samples) keep the baseline robust to
    uneven reporting rates: a chatty fast worker cannot drown out a
    silent slow one.  ``min_steps`` suppresses factors until a worker
    has enough history (warmup steps would otherwise flag everyone).
    """

    def __init__(self, window: int = 128, min_steps: int = 5):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.min_steps = int(min_steps)
        self._windows: dict = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def _p50s_locked(self) -> dict:
        # zoolint: disable=guarded-by -- _locked suffix: callers hold _lock across this call
        return {w: StragglerDetector._median(sorted(win))
                for w, win in self._windows.items()
                if len(win) >= self.min_steps}

    def observe(self, worker: str, step_s: float) -> float:
        """Record one step duration for ``worker``; returns the
        worker's current slowdown factor (1.0 while history is thin)."""
        with self._lock:
            win = self._windows.get(worker)
            if win is None:
                win = self._windows[worker] = collections.deque(
                    maxlen=self.window)
            win.append(float(step_s))
        return self.slowdown(worker)

    def fleet_p50(self) -> float:
        """Median of the per-worker rolling p50s (0.0 with no data)."""
        with self._lock:
            p50s = self._p50s_locked()
        return StragglerDetector._median(sorted(p50s.values()))

    def slowdown(self, worker: str) -> float:
        with self._lock:
            p50s = self._p50s_locked()
        base = StragglerDetector._median(sorted(p50s.values()))
        mine = p50s.get(worker)
        if mine is None or base <= 0.0:
            return 1.0
        return mine / base

    def factors(self) -> dict:
        """``{worker: slowdown_factor}`` for every worker with enough
        history — the rebalancer's one input."""
        with self._lock:
            p50s = self._p50s_locked()
        base = StragglerDetector._median(sorted(p50s.values()))
        if base <= 0.0:
            return {w: 1.0 for w in p50s}
        return {w: p / base for w, p in p50s.items()}

    def forget(self, worker: str) -> None:
        """Drop a departed worker's window so its history cannot skew
        the fleet baseline after it left the membership."""
        with self._lock:
            self._windows.pop(worker, None)


# ---------------------------------------------------------------------------
# Process-global default.  ZOO_FLIGHT=0 disables recording; ZOO_FLIGHT_DIR
# arms the crash dump; ZOO_FLIGHT_EVENTS overrides the ring capacity.
# ---------------------------------------------------------------------------

_default: FlightRecorder | None = None  # guarded-by: _default_lock
_default_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                env = os.environ
                _default = FlightRecorder(
                    capacity=int(env.get("ZOO_FLIGHT_EVENTS", "4096")),
                    dump_dir=env.get("ZOO_FLIGHT_DIR") or None,
                    enabled=env.get("ZOO_FLIGHT", "1") != "0",
                )
    return _default


def set_flight_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process-global recorder (tests); returns the previous."""
    global _default
    with _default_lock:
        prev, _default = _default, recorder
    return prev
