"""Image preprocessing ops — host-side, numpy/C++-backed, feeding infeed.

The port's own copy of ``analytics_zoo_tpu/feature/image/transforms.py``
(which imports no JAX).  The class names are the reference's: a random
op's stream is seeded from its class name, a process-wide instance count
and a per-instance call count (:class:`_RandomOp`), so the same chain
built in the same order draws the same crops and flips in both packages.
cv2 is imported lazily: ``ImageResize`` takes its numpy fallback without
it (the GPU host has no cv2 and no PIL), ``ImageBytesToMat`` needs it.

Reference: zoo/.../feature/image/ImageProcessing.scala + the ~25
OpenCV-backed ops under feature/image (resize, crop variants, flip, hue,
saturation, brightness, normalize, expand, jitter — SURVEY.md §2.1).  The
reference runs OpenCV via BigDL's JNI; here the per-record ops are numpy
(uint8 in, float32 out at the normalize boundary), with the normalize hot
loop optionally served by the C++ host library
(``analytics_zoo_tpu_torch/native/zoonative.cpp``).  Records are HWC uint8/float
numpy arrays; all ops are `Preprocessing` stages composing with ``>>``.

Geometric ops use seeded per-record RNG derived from a records counter so a
transformed FeatureSet remains reproducible/checkpointable (the reference's
OpenCV ops were non-deterministic across retries).
"""

from __future__ import annotations

import zlib

import numpy as np

from analytics_zoo_tpu_torch.feature.common import Preprocessing


def _rng_for(record_seed):
    return np.random.default_rng(record_seed)


_random_op_instances = 0


class _RandomOp(Preprocessing):
    """Base for randomized ops: derives an rng from a per-record counter.

    The seed mixes a stable hash of the class name with a process-wide
    instance index, so streams are (a) reproducible across process restarts
    (checkpoint resume replays the same augmentations) and (b) independent
    between instances of the same op class.
    """

    def __init__(self):
        global _random_op_instances
        _random_op_instances += 1
        self._instance = _random_op_instances
        self._class_seed = zlib.crc32(type(self).__name__.encode())
        self._counter = 0

    def next_rng(self):
        self._counter += 1
        return np.random.default_rng(
            (self._class_seed, self._instance, self._counter))


class ImageResize(Preprocessing):
    """Bilinear resize to (height, width) (reference image/Resize)."""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = int(resize_h), int(resize_w)

    def transform(self, img):
        img = np.asarray(img)
        h, w = img.shape[:2]
        if (h, w) == (self.h, self.w):
            return img
        try:
            import cv2

            # The reference resizes through OpenCV (BigDL augmentation.
            # Resize); using cv2 here IS the oracle behavior.
            out = cv2.resize(img, (self.w, self.h),
                             interpolation=cv2.INTER_LINEAR)
            if out.ndim == 2 and img.ndim == 3:
                out = out[:, :, None]  # cv2 drops singleton channels
            return out
        except ImportError:
            pass
        # numpy fallback with OpenCV's half-pixel-center convention:
        # src = (dst + 0.5) * scale - 0.5
        ys = np.clip((np.arange(self.h) + 0.5) * h / self.h - 0.5, 0, h - 1)
        xs = np.clip((np.arange(self.w) + 0.5) * w / self.w - 0.5, 0, w - 1)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        img_f = img.astype(np.float32)
        top = img_f[y0][:, x0] * (1 - wx) + img_f[y0][:, x1] * wx
        bot = img_f[y1][:, x0] * (1 - wx) + img_f[y1][:, x1] * wx
        out = top * (1 - wy) + bot * wy
        return np.clip(np.rint(out), 0, 255).astype(img.dtype) \
            if img.dtype == np.uint8 else out.astype(np.float32)


class ImageCenterCrop(Preprocessing):
    def __init__(self, crop_h: int, crop_w: int):
        self.h, self.w = int(crop_h), int(crop_w)

    def transform(self, img):
        h, w = img.shape[:2]
        top = max(0, (h - self.h) // 2)
        left = max(0, (w - self.w) // 2)
        return img[top:top + self.h, left:left + self.w]


class ImageRandomCrop(_RandomOp):
    def __init__(self, crop_h: int, crop_w: int):
        super().__init__()
        self.h, self.w = int(crop_h), int(crop_w)

    def transform(self, img):
        rng = self.next_rng()
        h, w = img.shape[:2]
        top = int(rng.integers(0, max(h - self.h, 0) + 1))
        left = int(rng.integers(0, max(w - self.w, 0) + 1))
        return img[top:top + self.h, left:left + self.w]


class ImageHFlip(_RandomOp):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def transform(self, img):
        if self.next_rng().random() < self.p:
            return img[:, ::-1]
        return img


class ImageBrightness(_RandomOp):
    """Additive brightness jitter in [delta_low, delta_high] (reference
    image/Brightness)."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0):
        super().__init__()
        self.lo, self.hi = float(delta_low), float(delta_high)

    def transform(self, img):
        delta = self.next_rng().uniform(self.lo, self.hi)
        out = img.astype(np.float32) + delta
        return np.clip(out, 0, 255).astype(img.dtype) \
            if img.dtype == np.uint8 else out


class ImageSaturation(_RandomOp):
    def __init__(self, lower: float = 0.5, upper: float = 1.5):
        super().__init__()
        self.lower, self.upper = float(lower), float(upper)

    def transform(self, img):
        s = self.next_rng().uniform(self.lower, self.upper)
        f = img.astype(np.float32)
        gray = f.mean(axis=-1, keepdims=True)
        out = gray + (f - gray) * s
        return np.clip(out, 0, 255).astype(img.dtype) \
            if img.dtype == np.uint8 else out


class ImageHue(_RandomOp):
    """Hue rotation by [-delta, delta] degrees (reference image/Hue),
    approximated in RGB via the YIQ rotation matrix."""

    def __init__(self, delta: float = 18.0):
        super().__init__()
        self.delta = float(delta)

    def transform(self, img):
        theta = np.deg2rad(self.next_rng().uniform(-self.delta, self.delta))
        c, s = np.cos(theta), np.sin(theta)
        m = np.array([
            [0.299 + 0.701 * c + 0.168 * s,
             0.587 - 0.587 * c + 0.330 * s,
             0.114 - 0.114 * c - 0.497 * s],
            [0.299 - 0.299 * c - 0.328 * s,
             0.587 + 0.413 * c + 0.035 * s,
             0.114 - 0.114 * c + 0.292 * s],
            [0.299 - 0.300 * c + 1.250 * s,
             0.587 - 0.588 * c - 1.050 * s,
             0.114 + 0.886 * c - 0.203 * s],
        ], np.float32)
        out = img.astype(np.float32) @ m.T
        return np.clip(out, 0, 255).astype(img.dtype) \
            if img.dtype == np.uint8 else out


class ImageExpand(_RandomOp):
    """Zoom-out expansion onto a mean-filled canvas (reference image/Expand,
    used by SSD augmentation)."""

    def __init__(self, max_expand_ratio: float = 4.0,
                 means=(123, 117, 104)):
        super().__init__()
        self.max_ratio = float(max_expand_ratio)
        self.means = np.asarray(means, np.float32)

    def transform(self, img):
        rng = self.next_rng()
        ratio = rng.uniform(1.0, self.max_ratio)
        h, w, c = img.shape
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.broadcast_to(
            self.means.astype(img.dtype), (nh, nw, c)
        ).copy()
        top = int(rng.integers(0, nh - h + 1))
        left = int(rng.integers(0, nw - w + 1))
        canvas[top:top + h, left:left + w] = img
        return canvas


class ImageChannelNormalize(Preprocessing):
    """(x - mean) / std per channel → float32 (reference
    image/ChannelNormalize); uses the C++ kernel when built."""

    def __init__(self, mean_r, mean_g, mean_b, std_r=1.0, std_g=1.0,
                 std_b=1.0):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)

    def transform(self, img):
        from analytics_zoo_tpu_torch.native import lib

        if lib is not None and img.dtype == np.uint8:
            return lib.normalize_u8(img, self.mean, self.std)
        return (img.astype(np.float32) - self.mean) / self.std


class ImagePixelNormalizer(Preprocessing):
    """Subtract a per-pixel mean image (reference PixelNormalizer)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def transform(self, img):
        return img.astype(np.float32) - self.means


class ImageMatToTensor(Preprocessing):
    """Reference MatToTensor: OpenCV mat → CHW tensor.  The model zoo's
    layout is NHWC, so this is float32 conversion (+ optional layout swap
    for parity)."""

    def __init__(self, to_chw: bool = False):
        self.to_chw = to_chw

    def transform(self, img):
        out = np.asarray(img, np.float32)
        if self.to_chw:
            out = np.transpose(out, (2, 0, 1))
        return out


class ImageSetToSample(Preprocessing):
    """Attach the record as (feature, label) sample (reference
    ImageSetToSample)."""

    def transform(self, record):
        if isinstance(record, tuple):
            return record
        return (record, None)


class ImageBytesToMat(Preprocessing):
    """Decode encoded image bytes (JPEG/PNG) to an HWC array (reference
    ImageBytesToMat.scala -> OpenCVMethod.fromImageBytes).  The reference
    decodes to BGR mats; default here is RGB (the rest of this stack is
    RGB) with ``order="BGR"`` for byte-exact reference parity."""

    def __init__(self, order: str = "RGB"):
        assert order in ("RGB", "BGR")
        self.order = order

    def transform(self, data):
        import cv2

        buf = np.frombuffer(bytes(data), np.uint8)
        img = cv2.imdecode(buf, cv2.IMREAD_COLOR)  # BGR
        if img is None:
            raise ValueError("undecodable image bytes")
        return img if self.order == "BGR" else img[:, :, ::-1]


class ImagePixelBytesToMat(Preprocessing):
    """Raw pixel bytes -> HWC uint8 array (reference
    ImagePixelBytesToMat.scala)."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.shape = (int(height), int(width), int(channels))

    def transform(self, data):
        return np.frombuffer(bytes(data), np.uint8).reshape(self.shape)


class ImageChannelOrder(Preprocessing):
    """Swap RGB<->BGR (reference ImageChannelOrder.scala)."""

    def transform(self, img):
        return img[:, :, ::-1]


class ImageChannelScaledNormalizer(Preprocessing):
    """(x - per-channel mean) * scale, one scale for all channels
    (reference ImageChannelScaledNormalizer.scala)."""

    def __init__(self, mean_r: int, mean_g: int, mean_b: int, scale: float):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.scale = float(scale)

    def transform(self, img):
        return (img.astype(np.float32) - self.mean) * self.scale


class ImageFiller(Preprocessing):
    """Fill a (normalized-coordinate) region with a constant (reference
    ImageFiller.scala -> augmentation.Filler; used for occlusion-style
    augmentation)."""

    def __init__(self, start_x: float, start_y: float, end_x: float,
                 end_y: float, value: int = 255):
        self.x1, self.y1 = float(start_x), float(start_y)
        self.x2, self.y2 = float(end_x), float(end_y)
        self.value = value

    def transform(self, img):
        h, w = img.shape[:2]
        out = img.copy()
        out[int(self.y1 * h):int(self.y2 * h),
            int(self.x1 * w):int(self.x2 * w)] = self.value
        return out


class ImageFixedCrop(Preprocessing):
    """Crop a fixed region, in normalized or pixel coordinates (reference
    ImageFixedCrop.scala -> augmentation.FixedCrop)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool, is_clip: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized
        self.is_clip = is_clip

    def transform(self, img):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        if self.is_clip:
            x1, x2 = max(0, x1), min(w, x2)
            y1, y2 = max(0, y1), min(h, y2)
        return img[int(y1):int(y2), int(x1):int(x2)]


class ImageMirror(Preprocessing):
    """Unconditional horizontal mirror (reference ImageMirror.scala ->
    BigDL augmentation.Mirror; the deterministic cousin of ImageHFlip)."""

    def transform(self, img):
        return img[:, ::-1]


class ImageRandomCropper(_RandomOp):
    """Random (or center) crop to a fixed size with optional random mirror
    (reference ImageRandomCropper.scala; the ImageNet training cropper)."""

    def __init__(self, crop_width: int, crop_height: int,
                 mirror: bool = True, cropper_method: str = "random"):
        super().__init__()
        self.w, self.h = int(crop_width), int(crop_height)
        self.mirror = mirror
        assert cropper_method in ("random", "center")
        self.method = cropper_method

    def transform(self, img):
        rng = self.next_rng()
        h, w = img.shape[:2]
        if h < self.h or w < self.w:
            # Fail here, not as a shape mismatch in np.stack three stages
            # later: the cropper contract is a fixed output size.
            raise ValueError(
                f"image {h}x{w} is smaller than crop "
                f"{self.h}x{self.w}; resize before ImageRandomCropper")
        if self.method == "random":
            top = int(rng.integers(0, h - self.h + 1))
            left = int(rng.integers(0, w - self.w + 1))
        else:
            top = (h - self.h) // 2
            left = (w - self.w) // 2
        out = img[top:top + self.h, left:left + self.w]
        if self.mirror and rng.random() < 0.5:
            out = out[:, ::-1]
        return out


class ImageRandomPreprocessing(_RandomOp):
    """Apply an inner preprocessing with probability ``prob`` (reference
    ImageRandomPreprocessing.scala; e.g. random expand in the SSD chain)."""

    def __init__(self, inner: Preprocessing, prob: float):
        super().__init__()
        self.inner = inner
        self.prob = float(prob)

    def transform(self, img):
        if self.next_rng().random() < self.prob:
            return self.inner.transform(img)
        return img


class ImageRandomResize(_RandomOp):
    """Resize the SHORT side to a random size in [min_size, max_size],
    preserving aspect ratio (reference ImageRandomResize.scala -> BigDL
    RandomResize; the Inception-style scale augmentation)."""

    def __init__(self, min_size: int, max_size: int):
        super().__init__()
        self.min_size, self.max_size = int(min_size), int(max_size)

    def transform(self, img):
        size = int(self.next_rng().integers(self.min_size,
                                            self.max_size + 1))
        h, w = img.shape[:2]
        if h < w:
            nh, nw = size, max(1, round(w * size / h))
        else:
            nh, nw = max(1, round(h * size / w)), size
        return ImageResize(nh, nw).transform(img)


class ImageMatToFloats(Preprocessing):
    """HWC array -> float32 (reference ImageMatToFloats.scala; layout stays
    NHWC — the model zoo's layout)."""

    def transform(self, img):
        return np.asarray(img, np.float32)


class ImageAspectScale(Preprocessing):
    """Scale so the short side is ``min_size`` without exceeding
    ``max_size`` on the long side (reference pipeline's aspect-preserving
    scale used by detection eval)."""

    def __init__(self, min_size: int, max_size: int = 1000):
        self.min_size, self.max_size = int(min_size), int(max_size)

    def transform(self, img):
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        scale = min(self.min_size / short, self.max_size / long)
        nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
        return ImageResize(nh, nw).transform(img)


def assemble_crop_batch(images, out_h, out_w, rng=None, offsets=None,
                        flips=None, mirror=True, n_threads=None):
    """Pack variable-size HWC uint8 images into one (N, oh, ow, C) uint8
    batch with per-image random crop + horizontal flip — the host-side
    batch-assembly hot loop that feeds the infeed (the one native host
    component).  Runs on C++ threads when the
    native library is built (``native.build_native()``), numpy otherwise;
    both paths are bit-identical.

    Either pass a seeded ``rng`` (offsets/flips are drawn from it — the
    deterministic-replay contract of the preprocessing chains) or pass
    explicit ``offsets`` (N, 2) and ``flips`` (N,).
    """
    import numpy as np

    from analytics_zoo_tpu_torch import native

    n = len(images)
    need_rng = offsets is None or (flips is None and mirror)
    if need_rng and rng is None:
        raise ValueError(
            "pass a seeded rng (random crops/flips) or explicit "
            "offsets/flips — a hidden fixed seed would silently repeat "
            "the same augmentation every batch")
    if offsets is None:
        offsets = np.stack([
            [rng.integers(0, im.shape[0] - out_h + 1),
             rng.integers(0, im.shape[1] - out_w + 1)]
            for im in images
        ]).astype(np.int32)
    if flips is None:
        flips = (rng.random(n) < 0.5) if mirror else np.zeros(n, bool)
    offsets = np.asarray(offsets, np.int32).reshape(n, 2)
    flips = np.asarray(flips, bool).reshape(n)
    # validate BEFORE dispatch: the C++ path would otherwise read out of
    # bounds where the numpy path raises — same inputs must behave the same
    for i, im in enumerate(images):
        y0, x0 = int(offsets[i, 0]), int(offsets[i, 1])
        if y0 < 0 or x0 < 0 or y0 + out_h > im.shape[0] \
                or x0 + out_w > im.shape[1]:
            raise ValueError(
                f"image {i} ({im.shape[0]}x{im.shape[1]}): crop "
                f"({out_h}x{out_w} at {y0},{x0}) out of bounds")
    if native.lib is not None:
        return native.lib.assemble_batch(images, offsets,
                                         flips.astype(np.uint8),
                                         out_h, out_w, n_threads=n_threads)
    ch = images[0].shape[-1]
    out = np.empty((n, out_h, out_w, ch), np.uint8)
    for i, im in enumerate(images):
        y0, x0 = int(offsets[i, 0]), int(offsets[i, 1])
        crop = np.asarray(im, np.uint8)[y0:y0 + out_h, x0:x0 + out_w]
        out[i] = crop[:, ::-1] if flips[i] else crop
    return out


def resize_batch(batch, out_h, out_w, n_threads=None):
    """Bilinear-resize a (N, H, W, C) uint8 batch to (N, oh, ow, C) —
    the resize stage of the host preprocess chain (resize -> crop/flip ->
    normalize), on C++ threads when the native library is built, cv2
    otherwise.  Both use half-pixel-center sampling (cv2 INTER_LINEAR),
    agreeing to +-1 from uint8 rounding.
    """
    import numpy as np

    from analytics_zoo_tpu_torch import native

    batch = np.ascontiguousarray(batch, np.uint8)
    if batch.ndim != 4:
        raise ValueError(f"expected (N, H, W, C) uint8, got {batch.shape}")
    if native.lib is not None:
        return native.lib.resize_bilinear(batch, out_h, out_w,
                                          n_threads=n_threads)
    import cv2

    out = np.empty((batch.shape[0], out_h, out_w, batch.shape[-1]),
                   np.uint8)
    for i, im in enumerate(batch):
        r = cv2.resize(im, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
        out[i] = r if r.ndim == 3 else r[..., None]
    return out
