"""3D medical-image transforms (the port's own copy of
``analytics_zoo_tpu/feature/image3d/transforms.py``, numpy only).

Reference: feature/image3d/*.scala — ``AffineTransform3D`` (matrix warp with
trilinear resampling), ``Crop3D``/``CenterCrop3D``/``RandomCrop3D``, and
``Rotate3D`` (Euler-angle rotation about the volume center).  SURVEY.md §2.1
lists these as part of the data layer's capability contract.

Volumes are numpy (D, H, W) or (D, H, W, C); transforms are host-side
``Preprocessing`` stages (composable with ``>>``) like the 2D pipeline.
"""

from __future__ import annotations

import math

import numpy as np

from analytics_zoo_tpu_torch.feature.common import Preprocessing
from analytics_zoo_tpu_torch.feature.image.transforms import _RandomOp


def _as_volume(t):
    v = np.asarray(t)
    if v.ndim not in (3, 4):
        raise ValueError(f"expected (D,H,W[,C]) volume, got {v.shape}")
    return v


def trilinear_sample(vol: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Sample ``vol`` (D,H,W[,C]) at fractional ``coords`` (..., 3) in
    (d, h, w) order with trilinear interpolation; out-of-range reads clamp
    to the border."""
    squeeze = vol.ndim == 3
    if squeeze:
        vol = vol[..., None]
    d, h, w, c = vol.shape
    cd = np.clip(coords[..., 0], 0, d - 1)
    ch = np.clip(coords[..., 1], 0, h - 1)
    cw = np.clip(coords[..., 2], 0, w - 1)
    d0, h0, w0 = np.floor(cd).astype(int), np.floor(ch).astype(int), \
        np.floor(cw).astype(int)
    d1 = np.minimum(d0 + 1, d - 1)
    h1 = np.minimum(h0 + 1, h - 1)
    w1 = np.minimum(w0 + 1, w - 1)
    fd = (cd - d0)[..., None]
    fh = (ch - h0)[..., None]
    fw = (cw - w0)[..., None]
    vf = vol.astype(np.float32)
    out = (
        vf[d0, h0, w0] * (1 - fd) * (1 - fh) * (1 - fw)
        + vf[d1, h0, w0] * fd * (1 - fh) * (1 - fw)
        + vf[d0, h1, w0] * (1 - fd) * fh * (1 - fw)
        + vf[d0, h0, w1] * (1 - fd) * (1 - fh) * fw
        + vf[d1, h1, w0] * fd * fh * (1 - fw)
        + vf[d1, h0, w1] * fd * (1 - fh) * fw
        + vf[d0, h1, w1] * (1 - fd) * fh * fw
        + vf[d1, h1, w1] * fd * fh * fw
    )
    return out[..., 0] if squeeze else out


def rotation_matrix_3d(yaw: float = 0.0, pitch: float = 0.0,
                       roll: float = 0.0) -> np.ndarray:
    """Euler rotation (about volume axes d, h, w) -> 3x3 matrix."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    rz = np.array([[1, 0, 0], [0, cy, -sy], [0, sy, cy]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rx = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float64)


class AffineTransform3D(Preprocessing):
    """Resample through an affine map about the volume center
    (reference AffineTransform3D: out(x) = vol(A⁻¹(x - c) + c + t))."""

    def __init__(self, matrix: np.ndarray, translation=(0.0, 0.0, 0.0)):
        self.matrix = np.asarray(matrix, np.float64).reshape(3, 3)
        self.translation = np.asarray(translation, np.float64)

    def transform(self, vol):
        vol = _as_volume(vol)
        d, h, w = vol.shape[:3]
        center = (np.array([d, h, w], np.float64) - 1) / 2.0
        grid = np.stack(np.meshgrid(
            np.arange(d), np.arange(h), np.arange(w), indexing="ij"
        ), axis=-1).astype(np.float64)
        inv = np.linalg.inv(self.matrix)
        coords = (grid - center) @ inv.T + center + self.translation
        return trilinear_sample(vol, coords)


class Rotate3D(AffineTransform3D):
    """Reference Rotate3D: Euler-angle rotation, trilinear resample."""

    def __init__(self, yaw=0.0, pitch=0.0, roll=0.0):
        super().__init__(rotation_matrix_3d(yaw, pitch, roll))


class Warp3D(Preprocessing):
    """Dense flow-field warp (reference Warp.scala ``WarpTransformer``).

    ``flow_field``: (3, D', H', W') array of (flow_z, flow_y, flow_x); the
    output volume has the flow field's spatial shape.  With ``offset=True``
    the flow is added to the (1-based, matching the reference's Tensor
    indexing) target coordinate; with ``offset=False`` the flow IS the
    absolute source coordinate.  ``clamp_mode="clamp"`` clamps off-image
    samples to the border; ``"padding"`` writes ``pad_val`` instead.
    Interpolation is trilinear with the reference's exact border rule
    (ceil index saturates at the last voxel).  Vectorized numpy instead of
    the reference's per-voxel triple loop.
    """

    def __init__(self, flow_field, offset: bool = True,
                 clamp_mode: str = "clamp", pad_val: float = 0.0):
        self.flow = np.asarray(flow_field, np.float64)
        if self.flow.ndim != 4 or self.flow.shape[0] != 3:
            raise ValueError(
                f"flow_field must be (3, D, H, W), got {self.flow.shape}")
        if clamp_mode not in ("clamp", "padding"):
            raise ValueError(f"clamp_mode {clamp_mode!r}")
        self.offset = bool(offset)
        self.clamp_mode = clamp_mode
        self.pad_val = float(pad_val)

    def transform(self, vol):
        vol = _as_volume(vol)
        squeeze = vol.ndim == 3
        vf = (vol if not squeeze else vol[..., None]).astype(np.float32)
        sd, sh, sw = vf.shape[:3]
        _, dd, dh, dw = self.flow.shape
        # 1-based target grid, reference Tensor indexing
        z, y, x = np.meshgrid(np.arange(1, dd + 1), np.arange(1, dh + 1),
                              np.arange(1, dw + 1), indexing="ij")
        om = 1.0 if self.offset else 0.0
        iz = om * z + self.flow[0]
        iy = om * y + self.flow[1]
        ix = om * x + self.flow[2]
        off_image = ((iz < 1) | (iz > sd) | (iy < 1) | (iy > sh)
                     | (ix < 1) | (ix > sw))
        iz = np.clip(iz, 1, sd)
        iy = np.clip(iy, 1, sh)
        ix = np.clip(ix, 1, sw)
        iz0 = np.floor(iz).astype(int)
        iy0 = np.floor(iy).astype(int)
        ix0 = np.floor(ix).astype(int)
        iz1 = np.minimum(iz0 + 1, sd)
        iy1 = np.minimum(iy0 + 1, sh)
        ix1 = np.minimum(ix0 + 1, sw)
        wz = (iz - iz0)[..., None]
        wy = (iy - iy0)[..., None]
        wx = (ix - ix0)[..., None]
        g = lambda a, b, c: vf[a - 1, b - 1, c - 1]  # noqa: E731 (1-based)
        out = (
            (1 - wy) * (1 - wx) * (1 - wz) * g(iz0, iy0, ix0)
            + (1 - wy) * (1 - wx) * wz * g(iz1, iy0, ix0)
            + (1 - wy) * wx * (1 - wz) * g(iz0, iy0, ix1)
            + (1 - wy) * wx * wz * g(iz1, iy0, ix1)
            + wy * (1 - wx) * (1 - wz) * g(iz0, iy1, ix0)
            + wy * (1 - wx) * wz * g(iz1, iy1, ix0)
            + wy * wx * (1 - wz) * g(iz0, iy1, ix1)
            + wy * wx * wz * g(iz1, iy1, ix1)
        )
        if self.clamp_mode == "padding":
            out = np.where(off_image[..., None], self.pad_val, out)
        out = out.astype(np.float32)
        return out[..., 0] if squeeze else out


class Crop3D(Preprocessing):
    """Crop ``patch_size`` starting at ``start`` (reference Crop3D)."""

    def __init__(self, start, patch_size):
        self.start = tuple(int(s) for s in start)
        self.patch = tuple(int(s) for s in patch_size)

    def transform(self, vol):
        vol = _as_volume(vol)
        (d0, h0, w0), (pd, ph, pw) = self.start, self.patch
        if (d0 < 0 or h0 < 0 or w0 < 0 or d0 + pd > vol.shape[0]
                or h0 + ph > vol.shape[1] or w0 + pw > vol.shape[2]):
            raise ValueError(
                f"crop {self.start}+{self.patch} outside volume "
                f"{vol.shape[:3]}")
        return vol[d0:d0 + pd, h0:h0 + ph, w0:w0 + pw]


class CenterCrop3D(Preprocessing):
    def __init__(self, patch_size):
        self.patch = tuple(int(s) for s in patch_size)

    def transform(self, vol):
        vol = _as_volume(vol)
        start = [(s - p) // 2 for s, p in zip(vol.shape[:3], self.patch)]
        return Crop3D(start, self.patch)(vol)


class RandomCrop3D(_RandomOp):
    def __init__(self, patch_size):
        super().__init__()
        self.patch = tuple(int(s) for s in patch_size)

    def transform(self, vol):
        vol = _as_volume(vol)
        rng = self.next_rng()
        start = [int(rng.integers(0, s - p + 1))
                 for s, p in zip(vol.shape[:3], self.patch)]
        return Crop3D(start, self.patch)(vol)
