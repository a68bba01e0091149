"""The port's image ops (``feature/image/transforms.py``, ``imageset.py``,
``roi.py``, ``feature/image3d``) against the JAX package's on the same
seeded inputs: uint8 and float outputs equal (cv2 paths too), the native
library's paths bit for bit their numpy ones (its resize within 1, the
reference's own contract), random ops drawing the same crops, flips and
jitters when both packages build them from the same instance count."""

import os
import sys

import numpy as np
import pytest

from analytics_zoo_tpu.feature import image as jimage
from analytics_zoo_tpu.feature import image3d as jimage3d
from analytics_zoo_tpu.feature.image import transforms as jtf

from analytics_zoo_tpu_torch import native
from analytics_zoo_tpu_torch.feature import image as timage
from analytics_zoo_tpu_torch.feature import image3d as timage3d
from analytics_zoo_tpu_torch.feature.image import transforms as ttf


def _img(h=24, w=32, seed=0, c=3):
    return np.random.default_rng(seed).integers(
        0, 256, size=(h, w, c)).astype(np.uint8)


@pytest.fixture
def same_instances(monkeypatch):
    """Both packages' random-op instance counters from 0, so ops built in
    the same order seed alike."""
    import analytics_zoo_tpu.feature.image.transforms as jt
    import analytics_zoo_tpu_torch.feature.image.transforms as tt

    monkeypatch.setattr(jt, "_random_op_instances", 0)
    monkeypatch.setattr(tt, "_random_op_instances", 0)


@pytest.fixture
def no_cv2(monkeypatch):
    """``import cv2`` raises, as on a host without it."""
    monkeypatch.setitem(sys.modules, "cv2", None)


@pytest.fixture(scope="module")
def built_lib():
    """The port's library, built for this module; ``native.lib`` as it was
    afterwards, so other modules see the import-time state."""
    saved = native.lib
    lib = native.build_native()
    assert lib is not None and native.lib is lib
    yield lib
    native.lib = saved


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    """Both packages' ops on their numpy paths, whether or not a library
    was built before this test (the import loads one already built); a
    test that holds the native path sets ``native.lib`` itself."""
    import analytics_zoo_tpu.native as jnative

    monkeypatch.setattr(jnative, "lib", None)
    monkeypatch.setattr(native, "lib", None)


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


DETERMINISTIC = {
    "resize_up": lambda m: m.ImageResize(30, 40),
    "resize_down": lambda m: m.ImageResize(12, 9),
    "center_crop": lambda m: m.ImageCenterCrop(10, 14),
    "pixel_normalizer": lambda m: m.ImagePixelNormalizer(
        np.arange(24 * 32 * 3, dtype=np.float32).reshape(24, 32, 3) / 7),
    "mat_to_tensor": lambda m: m.ImageMatToTensor(to_chw=True),
    "mat_to_floats": lambda m: m.ImageMatToFloats(),
    "set_to_sample": lambda m: m.ImageSetToSample(),
    "channel_order": lambda m: m.ImageChannelOrder(),
    "scaled_normalizer": lambda m: m.ImageChannelScaledNormalizer(
        120, 110, 100, 0.017),
    "filler": lambda m: m.ImageFiller(0.1, 0.2, 0.6, 0.7, value=9),
    "fixed_crop_normalized": lambda m: m.ImageFixedCrop(
        0.1, 0.2, 0.8, 0.9, normalized=True),
    "fixed_crop_pixels": lambda m: m.ImageFixedCrop(
        -3, 2, 50, 20, normalized=False),
    "mirror": lambda m: m.ImageMirror(),
    "aspect_scale": lambda m: m.ImageAspectScale(16, max_size=20),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
@pytest.mark.parametrize("cv2_path", [True, False], ids=["cv2", "numpy"])
def test_deterministic_op_matches_the_reference(name, cv2_path, monkeypatch):
    if not cv2_path:
        monkeypatch.setitem(sys.modules, "cv2", None)
    for seed in (0, 1):
        img = _img(seed=seed)
        _same(DETERMINISTIC[name](ttf)(img), DETERMINISTIC[name](jtf)(img))


def test_resize_keeps_a_single_channel_and_floats(no_cv2):
    gray = _img(c=1)
    _same(ttf.ImageResize(10, 12)(gray), jtf.ImageResize(10, 12)(gray))
    f = gray.astype(np.float32) / 3
    _same(ttf.ImageResize(10, 12)(f), jtf.ImageResize(10, 12)(f))


def test_channel_normalize_numpy_and_native(monkeypatch, built_lib):
    """The numpy path equals the reference's numpy path bit for bit; the
    native path is ``(x - mean) * (1 / std)`` in f32, bit for bit."""
    import analytics_zoo_tpu.native as jnative

    img = _img()
    mean, std = (123.68, 116.779, 103.939), (58.4, 57.1, 57.4)
    assert jnative.lib is None and native.lib is None
    _same(ttf.ImageChannelNormalize(*mean, *std)(img),
          jtf.ImageChannelNormalize(*mean, *std)(img))
    monkeypatch.setattr(native, "lib", built_lib)
    got = ttf.ImageChannelNormalize(*mean, *std)(img)
    want = (img.astype(np.float32) - np.float32(mean)) \
        * (np.float32(1) / np.float32(std))
    _same(got, want)


def test_bytes_to_mat_decodes_as_the_reference():
    import cv2

    img = _img()
    ok, buf = cv2.imencode(".png", img[:, :, ::-1])
    assert ok
    for order in ("RGB", "BGR"):
        _same(ttf.ImageBytesToMat(order)(buf.tobytes()),
              jtf.ImageBytesToMat(order)(buf.tobytes()))
    _same(ttf.ImagePixelBytesToMat(24, 32)(img.tobytes()),
          jtf.ImagePixelBytesToMat(24, 32)(img.tobytes()))
    for mod in (ttf, jtf):
        with pytest.raises(ValueError, match="undecodable"):
            mod.ImageBytesToMat()(b"not an image")


RANDOM = {
    "random_crop": lambda m: m.ImageRandomCrop(10, 12),
    "hflip": lambda m: m.ImageHFlip(),
    "brightness": lambda m: m.ImageBrightness(),
    "saturation": lambda m: m.ImageSaturation(),
    "hue": lambda m: m.ImageHue(),
    "expand": lambda m: m.ImageExpand(max_expand_ratio=2.0),
    "cropper_random": lambda m: m.ImageRandomCropper(12, 10),
    "cropper_center": lambda m: m.ImageRandomCropper(
        12, 10, mirror=True, cropper_method="center"),
    "random_preprocessing": lambda m: m.ImageRandomPreprocessing(
        m.ImageBrightness(), 0.5),
    "random_resize": lambda m: m.ImageRandomResize(10, 20),
    "crop_then_flip": lambda m: m.ImageRandomCrop(16, 16) >> m.ImageHFlip(),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_op_draws_as_the_reference(name, same_instances):
    """Built in the same order from the same instance count, each op's
    stream over six records is the reference's, record for record."""
    port, ref = RANDOM[name](ttf), RANDOM[name](jtf)
    for seed in range(6):
        img = _img(seed=seed)
        _same(port(img), ref(img))


def test_random_cropper_refuses_a_small_image():
    for mod in (ttf, jtf):
        with pytest.raises(ValueError, match="smaller than crop"):
            mod.ImageRandomCropper(40, 40)(_img())


def _crop_inputs():
    gen = np.random.default_rng(3)
    return [gen.integers(0, 256, (20 + i, 24 + 2 * i, 3), dtype=np.uint8)
            for i in range(5)]


def test_assemble_crop_batch_native_numpy_and_reference(monkeypatch,
                                                        built_lib):
    import analytics_zoo_tpu.native as jnative

    images = _crop_inputs()
    assert jnative.lib is None
    monkeypatch.setattr(native, "lib", built_lib)
    got = ttf.assemble_crop_batch(images, 16, 18,
                                  rng=np.random.default_rng(7))
    monkeypatch.setattr(native, "lib", None)
    plain = ttf.assemble_crop_batch(images, 16, 18,
                                    rng=np.random.default_rng(7))
    want = jtf.assemble_crop_batch(images, 16, 18,
                                   rng=np.random.default_rng(7))
    _same(got, plain)
    _same(plain, want)
    assert got.shape == (5, 16, 18, 3)
    fixed = dict(offsets=np.zeros((5, 2), np.int32), flips=[1, 0, 1, 0, 1])
    _same(ttf.assemble_crop_batch(images, 16, 18, **fixed),
          jtf.assemble_crop_batch(images, 16, 18, **fixed))


def test_assemble_crop_batch_errors_as_the_reference(monkeypatch,
                                                    built_lib):
    monkeypatch.setattr(native, "lib", built_lib)
    images = _crop_inputs()
    for mod in (ttf, jtf):
        with pytest.raises(ValueError, match="seeded rng"):
            mod.assemble_crop_batch(images, 16, 18)
        with pytest.raises(ValueError, match="out of bounds"):
            mod.assemble_crop_batch(
                images, 16, 18, offsets=np.full((5, 2), 9, np.int32),
                flips=np.zeros(5, bool))


def test_resize_batch_native_within_one_of_cv2(monkeypatch, built_lib):
    import analytics_zoo_tpu.native as jnative

    batch = np.stack([_img(30, 40, seed=s) for s in range(3)])
    monkeypatch.setattr(native, "lib", built_lib)
    got = ttf.resize_batch(batch, 17, 23)
    monkeypatch.setattr(native, "lib", None)
    assert jnative.lib is None
    plain = ttf.resize_batch(batch, 17, 23)
    _same(plain, jtf.resize_batch(batch, 17, 23))
    assert got.shape == plain.shape == (3, 17, 23, 3)
    assert np.abs(got.astype(int) - plain.astype(int)).max() <= 1
    with pytest.raises(ValueError, match="expected"):
        ttf.resize_batch(batch[0], 17, 23)


def test_native_crc32c_and_normalize(built_lib):
    from analytics_zoo_tpu.tensorboard import record as jrecord

    from analytics_zoo_tpu_torch.tensorboard import record

    gen = np.random.default_rng(5)
    for n in (0, 1, 7, 8, 9, 4097):
        data = gen.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert built_lib.crc32c(data) == record._crc32c_py(data) \
            == jrecord._crc32c_py(data)
        assert record.masked_crc(data) == jrecord.masked_crc(data)
    assert record.crc32c(b"123456789") == 0xE3069283  # the check value


def test_a_new_process_loads_the_built_library(built_lib):
    """The import loads a library already built into BUILD_DIR, as the
    reference's does: a process that never calls ``build_native`` takes
    the native paths."""
    import subprocess

    # the module alone, by its file (it imports no torch): a fresh import
    code = ("import importlib.util as u, sys; "
            "s = u.spec_from_file_location('native', sys.argv[1]); "
            "m = u.module_from_spec(s); s.loader.exec_module(m); "
            "print(m.lib.path if m.lib is not None else None)")
    out = subprocess.run([sys.executable, "-c", code, native.__file__],
                         check=True, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == native._SO == built_lib.path


def test_a_stale_library_is_rebuilt_to_a_unique_path(tmp_path, monkeypatch):
    """A library missing a symbol (an older source) in the build directory:
    the import-time load leaves ``lib`` None, ``build_native`` compiles to
    a unique path, loads it, and installs a fresh copy for later loads."""
    import subprocess

    stale_src = tmp_path / "stale.cpp"
    stale_src.write_text('extern "C" unsigned zoo_crc32c(const char*, '
                         'unsigned long n) { return 0; }\n')
    so = tmp_path / "libzoonative.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(so),
                    str(stale_src)], check=True)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setattr(native, "lib", None)
    lib = native.build_native()
    assert lib is not None and native.lib is lib
    assert os.path.dirname(lib.path) == str(tmp_path)
    assert lib.path != str(so)
    assert lib.crc32c(b"123456789") == 0xE3069283
    # the canonical copy is the fresh build now (a later process loads it)
    assert b"zoo_resize_bilinear_u8" in so.read_bytes()


def test_a_forced_rebuild_loads_the_new_build(tmp_path, monkeypatch,
                                              built_lib):
    """With a library loaded, ``build_native(force=True)`` builds to a
    unique path and loads that (the loader would hand back the mapping it
    holds for the canonical path), then installs a copy there."""
    so = tmp_path / "libzoonative.so"
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setattr(native, "lib", built_lib)
    lib = native.build_native(force=True)
    assert lib is not None and native.lib is lib and lib is not built_lib
    assert os.path.dirname(lib.path) == str(tmp_path)
    assert lib.path != str(so) and so.exists()
    assert lib.crc32c(b"123456789") == 0xE3069283


def test_no_compiler_leaves_the_numpy_paths(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "libzoonative.so"))
    monkeypatch.setattr(native, "lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    assert native.build_native() is None
    assert native.lib is None


def test_the_library_builds_outside_the_package():
    import analytics_zoo_tpu_torch

    pkg = os.path.dirname(analytics_zoo_tpu_torch.__file__)
    assert not native.BUILD_DIR.startswith(pkg)
    assert native.BUILD_DIR.endswith(os.path.join("build", "native"))


# ---------------------------------------------------------------------------
# ImageSet
# ---------------------------------------------------------------------------
def _image_tree(root):
    from PIL import Image

    for c, cls in enumerate(("cat", "dog")):
        os.makedirs(root / cls)
        for i in range(3):
            Image.fromarray(_img(8 + i, 10, seed=10 * c + i)).save(
                root / cls / f"{i}.png")
    np.save(root / "cat" / "extra.npy", _img(9, 10, seed=99))


def test_imageset_read_matches_the_reference(tmp_path):
    _image_tree(tmp_path)
    for kw in (dict(with_label=True), dict(with_label=True, max_images=4)):
        got = timage.ImageSet.read(str(tmp_path), **kw)
        want = jimage.ImageSet.read(str(tmp_path), **kw)
        assert got.labels == want.labels and got.paths == want.paths
        assert got.label_map == want.label_map
        for a, b in zip(got.images, want.images, strict=True):
            _same(a, b)
    got = timage.ImageSet.read(str(tmp_path / "cat"))
    want = jimage.ImageSet.read(str(tmp_path / "cat"))
    assert got.labels is None and len(got) == len(want) == 4
    for a, b in zip(got.images, want.images, strict=True):
        _same(a, b)


def test_imageset_without_pil_reads_npy_and_raises_otherwise(tmp_path,
                                                             monkeypatch):
    _image_tree(tmp_path)
    os.makedirs(tmp_path / "arrays")
    for i in range(2):
        np.save(tmp_path / "arrays" / f"{i}.npy", _img(5, 6, seed=i))
    monkeypatch.setitem(sys.modules, "PIL", None)
    for mod in (timage, jimage):
        with pytest.raises(RuntimeError, match="PIL unavailable"):
            mod.ImageSet.read(str(tmp_path / "cat"))
    got = timage.ImageSet.read(str(tmp_path / "arrays"))
    want = jimage.ImageSet.read(str(tmp_path / "arrays"))
    for a, b in zip(got.images, want.images, strict=True):
        _same(a, b)


def test_imageset_transform_and_feature_set(same_instances):
    images = [_img(20, 22, seed=s) for s in range(4)]
    chain_t = ttf.ImageRandomCrop(12, 12) >> ttf.ImageChannelNormalize(
        100, 110, 120, 50, 60, 70)
    chain_j = jtf.ImageRandomCrop(12, 12) >> jtf.ImageChannelNormalize(
        100, 110, 120, 50, 60, 70)
    got = timage.ImageSet.from_arrays(images, [0, 1, 0, 1]).transform(
        chain_t).to_feature_set()
    want = jimage.ImageSet.from_arrays(images, [0, 1, 0, 1]).transform(
        chain_j).to_feature_set()
    _same(got.xs[0], want.xs[0])
    _same(got.ys[0], want.ys[0])
    b1 = next(got.batches(2, seed=3, epoch=1))
    b2 = next(want.batches(2, seed=3, epoch=1))
    _same(b1["x"], b2["x"])


# ---------------------------------------------------------------------------
# ROI ops and the SSD pipelines
# ---------------------------------------------------------------------------
def _roi_records(n=6, seed=4):
    gen = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = 40 + 2 * i, 50 - i
        boxes = []
        for _ in range(2 + i % 2):
            x1, y1 = gen.uniform(0, w / 2), gen.uniform(0, h / 2)
            boxes.append([x1, y1, x1 + gen.uniform(5, w / 2),
                          y1 + gen.uniform(5, h / 2)])
        out.append({"image": gen.integers(0, 256, (h, w, 3), np.uint8),
                    "boxes": np.asarray(boxes, np.float32),
                    "classes": gen.integers(1, 5, len(boxes)).astype(
                        np.float32),
                    "difficult": (np.arange(len(boxes)) == 2).astype(
                        np.float32)})
    return out


@pytest.mark.parametrize("pipeline", ["ssd_train_set", "ssd_val_set"])
def test_ssd_pipelines_match_the_reference(pipeline):
    records = _roi_records()
    got = getattr(timage, pipeline)(records, resolution=32, max_boxes=4)
    want = getattr(jimage, pipeline)(records, resolution=32, max_boxes=4)
    assert got.num_samples == want.num_samples == len(records)
    for epoch in (1, 2):
        for a, b in zip(got.batches(4, seed=9, epoch=epoch,
                                    drop_last=False, pad_to_batch=4),
                        want.batches(4, seed=9, epoch=epoch,
                                     drop_last=False, pad_to_batch=4),
                        strict=True):
            assert sorted(a) == sorted(b)
            for k in a:
                _same(a[k], b[k])


def test_roi_set_reads_a_path_record_and_refuses_process_shard(tmp_path):
    from PIL import Image

    rec = _roi_records(1)[0]
    Image.fromarray(rec["image"]).save(tmp_path / "r.png")
    lazy = {k: v for k, v in rec.items() if k != "image"}
    lazy["path"] = str(tmp_path / "r.png")
    got = next(timage.ssd_val_set([lazy], resolution=16).batches(1))
    want = next(jimage.ssd_val_set([lazy], resolution=16).batches(1))
    _same(got["x"], want["x"])
    _same(got["y"], want["y"])
    with pytest.raises(NotImplementedError, match="item 13"):
        next(timage.ssd_val_set([rec], resolution=16).batches(
            1, process_shard=(0, 2)))


# ---------------------------------------------------------------------------
# 3D transforms
# ---------------------------------------------------------------------------
def _volume(seed=0, c=None):
    shape = (6, 7, 8) if c is None else (6, 7, 8, c)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


VOLUME_OPS = {
    "affine": lambda m: m.AffineTransform3D(
        m.rotation_matrix_3d(0.3, -0.2, 0.1), translation=(0.5, 0, -1)),
    "rotate": lambda m: m.Rotate3D(0.2, 0.4, -0.3),
    "warp": lambda m: m.Warp3D(np.random.default_rng(1).uniform(
        -1, 1, (3, 5, 6, 7)).astype(np.float32)),
    "warp_padding": lambda m: m.Warp3D(np.random.default_rng(2).uniform(
        -2, 2, (3, 4, 4, 4)), offset=True, clamp_mode="padding",
        pad_val=-1.0),
    "crop": lambda m: m.Crop3D((1, 2, 0), (3, 4, 5)),
    "center_crop": lambda m: m.CenterCrop3D((3, 3, 3)),
}


@pytest.mark.parametrize("name", sorted(VOLUME_OPS))
def test_volume_op_matches_the_reference(name):
    for vol in (_volume(), _volume(2, c=2)):
        _same(VOLUME_OPS[name](timage3d)(vol),
              VOLUME_OPS[name](jimage3d)(vol))


def test_random_volume_crop_draws_as_the_reference(same_instances):
    port, ref = timage3d.RandomCrop3D((3, 4, 5)), \
        jimage3d.RandomCrop3D((3, 4, 5))
    for seed in range(4):
        vol = _volume(seed)
        _same(port(vol), ref(vol))
