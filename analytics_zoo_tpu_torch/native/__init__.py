"""The host library of the data plane: plain C++ bound with ctypes.

The port's own copy of ``analytics_zoo_tpu/native`` (its source,
``zoonative.cpp``, is the reference's letter for letter).  It runs on the
host, never on the card:

- crc32c (the TFRecord framing's hot loop);
- ``normalize_u8``: a uint8 HWC batch to float32 ``(x - mean) / std``;
- ``assemble_batch``: variable-size uint8 images to one cropped and
  flipped (N, oh, ow, C) batch on C++ threads;
- ``resize_bilinear``: a (N, H, W, C) uint8 batch resized on C++ threads.

The build is optional, as in the reference: the import never fails, and
``lib`` is None (the numpy paths apply) until a library loads.  The
library is built with ``g++`` by :func:`build_native` into
``build/native/`` at the root of the checkout (:data:`BUILD_DIR`, which
git ignores), never into the package.  The import loads a library already
built there, so every later process takes the native paths without
building again; an unreadable or stale one (an older source, missing a
symbol) leaves ``lib`` None at import.  The loader keeps a library it
has loaded by its path for the life of the process, so
:func:`build_native` builds a stale library, or a forced rebuild of one
already loaded, to a unique path in the same directory.
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import os
import subprocess

logger = logging.getLogger("analytics_zoo_tpu_torch")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "zoonative.cpp")
#: where the library is built: ``build/native`` beside the package
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
_SO = os.path.join(BUILD_DIR, "libzoonative.so")
_unique = itertools.count()


class _NativeLib:
    def __init__(self, cdll, path: str):
        self.path = path
        self._dll = cdll
        self._dll.zoo_crc32c.restype = ctypes.c_uint32
        self._dll.zoo_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        self._dll.zoo_normalize_u8.restype = None
        self._dll.zoo_normalize_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        self._dll.zoo_assemble_batch.restype = None
        self._dll.zoo_assemble_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
        ]
        self._dll.zoo_resize_bilinear_u8.restype = None
        self._dll.zoo_resize_bilinear_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]

    def crc32c(self, data: bytes) -> int:
        return self._dll.zoo_crc32c(data, len(data))

    def normalize_u8(self, img, mean, std):
        """uint8 HWC image batch -> float32 normalized, in C."""
        import numpy as np

        img = np.ascontiguousarray(img, dtype=np.uint8)
        ch = img.shape[-1]
        out = np.empty(img.shape, dtype=np.float32)
        mean = np.ascontiguousarray(mean, dtype=np.float32)
        std = np.ascontiguousarray(std, dtype=np.float32)
        self._dll.zoo_normalize_u8(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            img.size, ch,
            mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out

    def assemble_batch(self, images, offsets, flips, out_h, out_w,
                       n_threads=None):
        """Pack variable-size HWC uint8 images into one (N, oh, ow, C)
        uint8 batch with per-image crop offsets and horizontal flips, on
        C++ threads.  ``offsets``/``flips`` come from the caller's seeded
        RNG, so an augmentation replays exactly."""
        import numpy as np

        n = len(images)
        ch = images[0].shape[-1]
        imgs = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
        ptrs = (ctypes.c_void_p * n)(
            *[im.ctypes.data_as(ctypes.c_void_p).value for im in imgs])
        hw = np.ascontiguousarray(
            [[im.shape[0], im.shape[1]] for im in imgs], dtype=np.int32)
        off = np.ascontiguousarray(offsets, dtype=np.int32)
        flp = np.ascontiguousarray(flips, dtype=np.uint8)
        out = np.empty((n, out_h, out_w, ch), dtype=np.uint8)
        if n_threads is None:
            n_threads = min(8, os.cpu_count() or 1)
        self._dll.zoo_assemble_batch(
            ptrs,
            hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, out_h, out_w, ch, int(n_threads),
        )
        return out

    def resize_bilinear(self, batch, out_h, out_w, n_threads=None):
        """(N, H, W, C) uint8 -> (N, oh, ow, C) uint8, half-pixel-center
        bilinear (cv2 INTER_LINEAR convention), on C++ threads."""
        import numpy as np

        batch = np.ascontiguousarray(batch, dtype=np.uint8)
        n, ih, iw, ch = batch.shape
        out = np.empty((n, out_h, out_w, ch), dtype=np.uint8)
        if n_threads is None:
            n_threads = min(8, os.cpu_count() or 1)
        self._dll.zoo_resize_bilinear_u8(
            batch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, ih, iw, out_h, out_w, ch, int(n_threads),
        )
        return out


def build_native(force: bool = False):
    """Compile the library with g++ (no other dependency) into
    :data:`BUILD_DIR` and load it; returns ``lib``, or None when there is
    no compiler or the build fails (the numpy paths stay).  Without
    ``force`` a library already there is loaded as it is."""
    global lib
    if force and lib is not None:
        # the loader keeps the mapping of a path it has loaded for the
        # life of the process: a rebuild here loads from a unique path
        return _build_unique()
    if force or not os.path.exists(_SO):
        if not _compile(_SO):
            return None
    try:
        lib = _NativeLib(ctypes.CDLL(_SO), _SO)
        return lib
    except AttributeError:
        # a stale library (an older source, missing a new symbol), and
        # a rebuild at the same path cannot replace its mapping
        if force:
            logger.warning("native lib missing symbols even after rebuild")
            return None
        return _build_unique()
    except OSError as e:
        logger.warning("native load failed: %s", e)
        return None


def _build_unique():
    """Build to a unique path in :data:`BUILD_DIR` and load that, then
    install a copy at the canonical path for later processes."""
    global lib
    uniq = os.path.join(
        BUILD_DIR, f"libzoonative-{os.getpid()}-{next(_unique)}.so")
    if not _compile(uniq):
        return None
    try:
        lib = _NativeLib(ctypes.CDLL(uniq), uniq)
    except (OSError, AttributeError) as e:
        logger.warning("native reload failed: %s", e)
        return None
    try:
        import shutil

        shutil.copy(uniq, _SO + ".new")
        os.replace(_SO + ".new", _SO)
    except OSError:
        pass
    return lib


def _compile(out_path: str) -> bool:
    # compile to a temporary name, then rename: atomic for builders racing
    tmp = f"{out_path}.{os.getpid()}.build"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-march=native",
           "-pthread", "-o", tmp, _SRC]
    try:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out_path)
        return True
    except Exception as e:  # no compiler, or a failed build: numpy paths
        logger.warning("native build failed: %s", e)
        return False


lib = None
if os.path.exists(_SO):
    try:
        lib = _NativeLib(ctypes.CDLL(_SO), _SO)
    except (OSError, AttributeError):
        # unreadable, or stale (an older source without a new symbol): the
        # import never fails, and build_native() rebuilds
        lib = None
