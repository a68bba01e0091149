"""The compile plane: the one choke point every capture and kernel build
goes through, and the directory the built artefacts persist in.

Counterpart of ``analytics_zoo_tpu/common/compile_cache.py``.  The
reference's compiled artefacts are XLA executables; the port's are two
kinds:

- the CUDA graphs of captured steps (``parallel.plan.compile_step``): a
  capture lives as long as its step object, in this process only;
- the nvcc-built kernel libraries (``ops/cuda/build.py``): shared
  libraries keyed by a hash of their sources and flags, which persist in
  a directory.  :func:`maybe_enable_persistent_cache` (or
  ``ZOO_COMPILE_CACHE``) points them at one, so a second process finds
  them there: a library found is a hit, an nvcc run is a miss.

:func:`timed_compile` times each such piece of work under its label
(``train_step``, ``train_step_scan4``, ``kernel_<name>``, ...) and counts
it as a hit or a miss, into the reference's ``zoo_compile_seconds{label}``
histogram and its ``zoo_compile_cache_hits_total`` /
``zoo_compile_cache_misses_total`` counters, and into this module's own
record, read by :func:`compile_stats`.  A replay of an existing capture
is a hit in :func:`compile_stats` only (the reference's in-process
executable cache counts in no metric either).
"""

from __future__ import annotations

import logging
import os
import threading
import time

logger = logging.getLogger("analytics_zoo_tpu_torch")

#: the reference's ``zoo_compile_seconds`` buckets
COMPILE_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 120.0, 300.0)

_LOCK = threading.Lock()
_ENABLED_DIR: str | None = None  # guarded-by: _LOCK
# label -> {"seconds": [...], "hits": n, "misses": n}
_STATS: dict[str, dict] = {}  # guarded-by: _LOCK


def cache_dir() -> str | None:
    """The enabled persistent directory, or None."""
    return _ENABLED_DIR


def maybe_enable_persistent_cache(path: str | None = None) -> str | None:
    """Point the kernel libraries at a persistent directory; idempotent.

    Resolution: explicit ``path`` > ``ZOO_COMPILE_CACHE``.  Returns the
    enabled directory, or None when neither is set (the libraries then
    build into ``build/kernels/`` beside the package).  A no-argument
    call after an explicit one keeps the explicit directory; a later
    explicit call with another path re-points it."""
    global _ENABLED_DIR
    if path is None and _ENABLED_DIR is not None:
        return _ENABLED_DIR
    resolved = path or os.environ.get("ZOO_COMPILE_CACHE") or None
    if resolved is None:
        return _ENABLED_DIR
    resolved = os.path.abspath(resolved)
    with _LOCK:
        if _ENABLED_DIR != resolved:
            os.makedirs(resolved, exist_ok=True)
            logger.info("persistent compile cache at %s (was %s)", resolved,
                        _ENABLED_DIR)
            _ENABLED_DIR = resolved
    return _ENABLED_DIR


def disable_persistent_cache() -> None:
    """Turn the persistent directory back off (symmetric teardown for
    :func:`maybe_enable_persistent_cache`)."""
    global _ENABLED_DIR
    with _LOCK:
        _ENABLED_DIR = None


def _metrics(label: str):
    from analytics_zoo_tpu_torch.metrics.registry import get_registry

    reg = get_registry()
    return (
        reg.histogram("zoo_compile_seconds",
                      "wall time of AOT lower().compile() calls",
                      ("label",), buckets=COMPILE_BUCKETS)
        .labels(label=label),
        reg.counter("zoo_compile_cache_hits_total",
                    "AOT compiles served from the persistent cache",
                    ("label",)).labels(label=label),
        reg.counter("zoo_compile_cache_misses_total",
                    "AOT compiles that ran XLA (no persistent-cache "
                    "entry)", ("label",)).labels(label=label),
    )


def timed_compile(work, label: str, *, hit: bool = False):
    """Run ``work()`` (a capture, or a kernel build) and record its wall
    seconds under ``label``, as a hit (``hit``: served from what was
    already built) or a miss, in :func:`compile_stats` and the registry
    (the reference's family names and help strings, letter for letter);
    returns what ``work`` returns.  A ``work`` that raises records
    nothing.  The registry is fed after ``work`` returns: a capture is
    over by then."""
    t0 = time.perf_counter()
    out = work()
    dt = time.perf_counter() - t0
    record(label, dt, hit=hit)
    hist, hits, misses = _metrics(label)
    hist.observe(dt)
    (hits if hit else misses).inc()
    return out


def record(label: str, seconds: float | None = None, *,
           hit: bool = False) -> None:
    """Count one hit or miss under ``label``, with its seconds when it
    was timed (a call served by an existing capture is a hit with no
    seconds: the reference's in-process executable cache)."""
    with _LOCK:
        row = _STATS.setdefault(label, {"seconds": [], "hits": 0,
                                        "misses": 0})
        if seconds is not None:
            row["seconds"].append(seconds)
        row["hits" if hit else "misses"] += 1
    if seconds is not None:
        logger.debug("compile[%s]: %.3fs (%s)", label, seconds,
                     "hit" if hit else "miss")


def compile_stats() -> dict:
    """``{label: {"seconds": [...], "hits": n, "misses": n}}``, a copy."""
    with _LOCK:
        return {k: {"seconds": list(v["seconds"]), "hits": v["hits"],
                    "misses": v["misses"]} for k, v in _STATS.items()}


def reset_compile_stats() -> None:
    """Forget every label's record (tests)."""
    with _LOCK:
        _STATS.clear()
