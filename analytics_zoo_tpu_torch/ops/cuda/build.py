"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc into a shared library with a
plain C interface, at first use, into ``build/kernels/`` beside the
package (a directory git ignores), or into the persistent directory of
the compile plane (``common.compile_cache.maybe_enable_persistent_cache``,
``ZOO_COMPILE_CACHE``) when one is set.  The file name carries a hash of
the sources and flags, so an edited source builds anew and an unchanged
one is reused.  Every build and first load goes through the compile
plane's choke point under ``kernel_<name>``: a library found is a hit, an
nvcc run a miss.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from analytics_zoo_tpu_torch.common.compile_cache import (
    cache_dir,
    maybe_enable_persistent_cache,
    record,
    timed_compile,
)

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}  # guarded-by: _LOCK


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME``, then ``PATH``, then the toolkit's default
    install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def build_dir() -> Path:
    """The compile plane's persistent directory when one is set, else
    ``BUILD_DIR``."""
    maybe_enable_persistent_cache()
    return Path(cache_dir() or BUILD_DIR)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the sources (the .cu
    and every header in csrc/) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, dict]:
    """Compile every named kernel source that is not built yet, one nvcc
    process each, all started together; each counts as a miss under
    ``kernel_<name>`` with its seconds.  Returns ``{name: {"seconds",
    "log"}}`` for the sources it compiled (``log`` holds ptxas's register
    and spill report).  Raises with nvcc's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        dest = library_path(name)
        tmp = dest.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (dest, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (dest, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, dest)  # atomic: a reader never sees half a library
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        record(f"kernel_{name}", report[name]["seconds"])  # a miss
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use (a
    miss); a library already built is loaded as a hit under
    ``kernel_<name>``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            import torch

            if torch.cuda.is_available() \
                    and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"kernel library {name} first needed inside a CUDA "
                    "graph capture: a captured step's eager run loads its "
                    "libraries before the capture")
            path = library_path(name)
            if path.exists():
                lib = timed_compile(lambda: ctypes.CDLL(str(path)),
                                    f"kernel_{name}", hit=True)
            else:
                build([name])
                lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
