"""Camera models, stereo rigs, and rectification.

Replacement for the reference's Camera/StereoCamera
(reference include/Camera.h:54-107, src/Camera.cpp:46-119) and the driver's
``cv::initUndistortRectifyMap`` / ``cv::remap`` precompute
(reference src/VIOSlam.cpp:282-306). The rectify maps are computed once on
the host (NumPy, f64) and the per-frame remap is a batched bilinear gather
that runs on device as part of the input pipeline.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.utils.config import ConfigFile


@dataclasses.dataclass
class Camera:
    """Pinhole camera with plumb-bob distortion.

    Mirrors reference Camera (include/Camera.h:54-79): when the rig is
    rectified the fx/fy/cx/cy scalars are used directly; otherwise the
    D/K/R/P blocks define the undistort+rectify mapping and P provides the
    rectified intrinsics (reference src/Camera.cpp:65-119).
    """

    fx: float
    fy: float
    cx: float
    cy: float
    dist: np.ndarray  # (5,) k1 k2 p1 p2 k3
    K: np.ndarray | None = None  # (3,3) raw intrinsics (unrectified rigs)
    D: np.ndarray | None = None  # (5,) raw distortion
    R: np.ndarray | None = None  # (3,3) rectifying rotation
    P: np.ndarray | None = None  # (3,4) rectified projection
    T_body_cam: np.ndarray | None = None  # (4,4) body->camera extrinsic (T_bc1)

    @classmethod
    def from_config(cls, conf: ConfigFile, section: str) -> "Camera":
        fx = float(conf.get(section, "fx"))
        fy = float(conf.get(section, "fy"))
        cx = float(conf.get(section, "cx"))
        cy = float(conf.get(section, "cy"))
        dist = np.array(
            [float(conf.get(section, k, default=0.0)) for k in ("k1", "k2", "p1", "p2", "k3")]
        )
        K = conf.get_matrix(section, "K", default=None)
        D = conf.get_matrix(section, "D", default=None)
        R = conf.get_matrix(section, "R", default=None)
        P = conf.get_matrix(section, "P", default=None)
        if D is not None:
            D = D.reshape(-1)
        return cls(fx, fy, cx, cy, dist, K=K, D=D, R=R, P=P)

    @property
    def intrinsics(self) -> np.ndarray:
        """Rectified 3x3 K (from P when present)."""
        if self.P is not None:
            return self.P[:, :3].copy()
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )


@dataclasses.dataclass
class StereoCamera:
    """Stereo rig (reference include/Camera.h:81-107). The right camera sits
    at +baseline along x: extrinsics[0,3] = baseline
    (reference src/Camera.cpp:51-58)."""

    left: Camera
    right: Camera
    width: int
    height: int
    fps: float
    baseline: float
    extrinsics: np.ndarray  # (4,4) left->right camera transform

    @classmethod
    def from_config(cls, conf: ConfigFile) -> "StereoCamera":
        left = Camera.from_config(conf, "Camera_l")
        try:
            right = Camera.from_config(conf, "Camera_r")
        except KeyError:  # monocular configs may omit the right camera
            right = left
        width = int(conf.get("Camera", "width"))
        height = int(conf.get("Camera", "height"))
        fps = float(conf.get("Camera", "fps"))
        baseline = float(conf.get("Camera", "bl"))
        ext = np.eye(4)
        ext[0, 3] = baseline
        T_bc = conf.get_matrix("T_bc1", default=None)
        if T_bc is not None:
            left.T_body_cam = T_bc
            right.T_body_cam = T_bc.copy()
            right.T_body_cam[0, 3] += baseline  # right cam offset along x
        return cls(left, right, width, height, fps, baseline, ext)


def _distort_normalized(x: np.ndarray, y: np.ndarray, D: np.ndarray):
    """Apply plumb-bob distortion to normalized coords (k1 k2 p1 p2 k3)."""
    k1, k2, p1, p2, k3 = D[:5]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def init_undistort_rectify_map(
    K: np.ndarray,
    D: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    width: int,
    height: int,
) -> np.ndarray:
    """Compute the (H, W, 2) source-pixel map, semantics of
    cv::initUndistortRectifyMap as used at reference src/VIOSlam.cpp:282-287.

    For each rectified pixel (u, v): back-project through P, rotate by
    R^-1 into the raw camera, apply distortion, project through K.
    Returns float32 map of (x_src, y_src).
    """
    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    fxp, fyp = P[0, 0], P[1, 1]
    cxp, cyp = P[0, 2], P[1, 2]
    x = (u - cxp) / fxp
    y = (v - cyp) / fyp
    ones = np.ones_like(x)
    rays = np.stack([x, y, ones], axis=-1) @ np.linalg.inv(R).T
    xn = rays[..., 0] / rays[..., 2]
    yn = rays[..., 1] / rays[..., 2]
    xd, yd = _distort_normalized(xn, yn, D)
    map_x = K[0, 0] * xd + K[0, 2]
    map_y = K[1, 1] * yd + K[1, 2]
    return np.stack([map_x, map_y], axis=-1).astype(np.float32)


def remap_bilinear(image: jax.Array, src_map: jax.Array) -> jax.Array:
    """Device-side cv::remap(INTER_LINEAR, BORDER_CONSTANT=0).

    image: (H, W) float; src_map: (H, W, 2) of (x, y) source coords.
    Pure gather + lerp — fuses into the downstream pyramid build under jit.
    """
    H, W = image.shape
    x = src_map[..., 0]
    y = src_map[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def sample(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = image[jnp.clip(yi, 0, H - 1), jnp.clip(xi, 0, W - 1)]
        return jnp.where(valid, v, 0.0)

    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def project(K: jax.Array, pts_cam: jax.Array) -> jax.Array:
    """Pinhole projection of (..., 3) camera-frame points -> (..., 2) pixels."""
    z = pts_cam[..., 2:3]
    uv = pts_cam[..., :2] / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return jnp.stack([uv[..., 0] * fx + cx, uv[..., 1] * fy + cy], axis=-1)


def backproject(K: jax.Array, uv: jax.Array, depth: jax.Array) -> jax.Array:
    """Inverse of :func:`project`: pixels (..., 2) + depth (...) -> (..., 3)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return jnp.stack([x, y, depth], axis=-1)
