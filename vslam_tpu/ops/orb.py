"""ORB-style oriented BRIEF descriptors, batched over keypoints.

Replaces the reference's intensity-centroid orientation
(reference src/FeatureExtractor.cpp:315-340 with the umax circle table at
666-680) and 256-pair BRIEF sampling (268-313). The pair pattern is our
own deterministic BRIEF pattern (seeded isotropic Gaussian, BRIEF-paper
style, clipped to the 31-px patch) rather than the OpenCV learned table —
descriptors only ever match against descriptors produced by this module,
so only internal consistency matters.

All functions take a blurred level image and a fixed-size keypoint array
with a validity mask; outputs are packed (N, 8) uint32 descriptors plus a
(N, 256) +-1 int8 expansion used for matmul Hamming matching
(vslam_tpu/ops/hamming.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PATCH = 31
HALF = PATCH // 2  # 15
N_BITS = 256


@functools.lru_cache(maxsize=None)
def _umax_table() -> np.ndarray:
    """Circular-patch row extents for radius 15 (intensity centroid mask),
    computed the same way ORB does (symmetric Bresenham circle)."""
    umax = np.zeros(HALF + 2, dtype=np.int32)
    vmax = int(np.floor(HALF * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(HALF * HALF - v * v)))
    v0 = 0
    for v in range(HALF, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


@functools.lru_cache(maxsize=None)
def _centroid_masks():
    """(31, 31) boolean circular mask and dx, dy coordinate grids."""
    umax = _umax_table()
    dy, dx = np.mgrid[-HALF : HALF + 1, -HALF : HALF + 1]
    mask = np.abs(dx) <= umax[np.clip(np.abs(dy), 0, HALF)]
    return mask.astype(np.float32), dx.astype(np.float32), dy.astype(np.float32)


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) int32 sample-pair offsets (x1, y1, x2, y2), Gaussian
    sigma = patch/5, clipped so rotation by any angle stays inside the
    31-px patch (norm <= 13 like ORB's learned pattern extent)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(N_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    lim = 13.0
    scale = np.minimum(1.0, lim / np.maximum(norm, 1e-6))
    pts = np.round(pts * scale).astype(np.int32)
    return pts.reshape(N_BITS, 4)


def gather_patches(img: jax.Array, xy: jax.Array, size: int = PATCH) -> jax.Array:
    """(N, size, size) patches centered at integer keypoints (clamped)."""
    H, W = img.shape
    h = size // 2
    dy, dx = jnp.mgrid[-h : h + 1, -h : h + 1]
    ys = jnp.clip(xy[:, 1, None, None] + dy[None], 0, H - 1)
    xs = jnp.clip(xy[:, 0, None, None] + dx[None], 0, W - 1)
    return img[ys, xs]


def orientations(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Intensity-centroid angle (radians) per keypoint: atan2(m01, m10)
    over the circular 31-px patch (reference computeOrientation,
    src/FeatureExtractor.cpp:315-340)."""
    mask, dx, dy = _centroid_masks()
    patches = gather_patches(img, xy)  # (N, 31, 31)
    m = jnp.asarray(mask)
    m10 = jnp.sum(patches * m * jnp.asarray(dx), axis=(1, 2))
    m01 = jnp.sum(patches * m * jnp.asarray(dy), axis=(1, 2))
    return jnp.arctan2(m01, m10)


def orientation_from_patches(patches: jax.Array) -> jax.Array:
    """Intensity-centroid angle from pre-gathered (..., 31, 31) patches
    (same math as :func:`orientations`, one batched reduction)."""
    mask, dx, dy = _centroid_masks()
    m10 = jnp.sum(patches * (mask * dx), axis=(-2, -1))
    m01 = jnp.sum(patches * (mask * dy), axis=(-2, -1))
    return jnp.arctan2(m01, m10)


def _pack_bits(bits: jax.Array) -> tuple[jax.Array, jax.Array]:
    words = bits.reshape(*bits.shape[:-1], 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(words << shifts, axis=-1, dtype=jnp.uint32)
    signed = (bits.astype(jnp.int8) * 2 - 1).astype(jnp.int8)
    return packed, signed


def _rotated_pattern(angle: jax.Array):
    """Rounded in-patch sample coords for both pattern points, rotated by
    each keypoint's angle (reference rotates its pattern the same way,
    src/FeatureExtractor.cpp:268-313). Returns four (..., N, 256) int32."""
    pat = jnp.asarray(brief_pattern(), jnp.float32)  # (256, 4)
    ca = jnp.cos(angle)[..., None]
    sa = jnp.sin(angle)[..., None]
    x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]

    def rot(px, py):
        rx = jnp.round(px * ca - py * sa).astype(jnp.int32)
        ry = jnp.round(px * sa + py * ca).astype(jnp.int32)
        return jnp.clip(rx + HALF, 0, PATCH - 1), jnp.clip(ry + HALF, 0, PATCH - 1)

    r1x, r1y = rot(x1, y1)
    r2x, r2y = rot(x2, y2)
    return r1x, r1y, r2x, r2y


def brief_from_patches(
    patches: jax.Array, angle: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Rotated BRIEF sampled INSIDE pre-gathered 31x31 patches via
    FACTORIZED ONE-HOT MATMULS (row one-hot contraction, then a masked
    column reduction). Bit-exact vs the gather form
    (:func:`brief_from_patches_gather`): the row contraction has exactly
    one nonzero term per output, so there is no accumulation error.

    patches: (..., N, 31, 31); angle: (..., N). Returns (packed (..., N, 8)
    uint32, signed (..., N, 256) int8).
    """
    r1x, r1y, r2x, r2y = _rotated_pattern(angle)
    ar = jnp.arange(PATCH)

    def sample(rx, ry):
        RY = (ry[..., None] == ar).astype(jnp.float32)  # (..., N, 256, P)
        tmp = jnp.einsum(
            "...nkr,...nrc->...nkc",
            RY,
            patches,
            precision=jax.lax.Precision.HIGHEST,
        )
        CX = (rx[..., None] == ar).astype(jnp.float32)
        return jnp.sum(tmp * CX, axis=-1)  # (..., N, 256)

    i1 = sample(r1x, r1y)
    i2 = sample(r2x, r2y)
    return _pack_bits((i1 < i2).astype(jnp.uint32))


def brief_from_patches_gather(
    patches: jax.Array, angle: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Gather-based oracle for :func:`brief_from_patches` (same bits; used
    in parity tests and host-side debugging)."""
    r1x, r1y, r2x, r2y = _rotated_pattern(angle)
    flat = patches.reshape(*patches.shape[:-2], PATCH * PATCH)
    idx1 = r1y * PATCH + r1x
    idx2 = r2y * PATCH + r2x
    i1 = jnp.take_along_axis(flat, idx1, axis=-1)
    i2 = jnp.take_along_axis(flat, idx2, axis=-1)
    return _pack_bits((i1 < i2).astype(jnp.uint32))


def brief_descriptors(
    blurred: jax.Array, xy: jax.Array, angle: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Rotated-BRIEF bits for each keypoint.

    blurred: the gaussian-blurred level image; xy: (N, 2) int32 level
    coords; angle: (N,) radians. Returns (packed (N, 8) uint32 bits,
    signed (N, 256) int8 in {-1, +1}).

    Sampling matches the reference scheme (src/FeatureExtractor.cpp:268-313):
    offsets rotated by the keypoint angle, rounded to integer pixels, read
    from the blurred image; bit = I(p + o1) < I(p + o2).
    """
    pat = jnp.asarray(brief_pattern(), jnp.float32)  # (256, 4)
    ca = jnp.cos(angle)[:, None]  # (N, 1)
    sa = jnp.sin(angle)[:, None]
    x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]

    def rot(px, py):
        rx = jnp.round(px[None] * ca - py[None] * sa).astype(jnp.int32)
        ry = jnp.round(px[None] * sa + py[None] * ca).astype(jnp.int32)
        return rx, ry  # (N, 256)

    H, W = blurred.shape
    r1x, r1y = rot(x1, y1)
    r2x, r2y = rot(x2, y2)
    gx1 = jnp.clip(xy[:, 0:1] + r1x, 0, W - 1)
    gy1 = jnp.clip(xy[:, 1:2] + r1y, 0, H - 1)
    gx2 = jnp.clip(xy[:, 0:1] + r2x, 0, W - 1)
    gy2 = jnp.clip(xy[:, 1:2] + r2y, 0, H - 1)
    i1 = blurred[gy1, gx1]
    i2 = blurred[gy2, gx2]
    bits = (i1 < i2).astype(jnp.uint32)  # (N, 256)

    # pack into 8 uint32 words
    words = bits.reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)
    signed = (bits.astype(jnp.int8) * 2 - 1).astype(jnp.int8)
    return packed, signed
