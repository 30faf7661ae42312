"""Full multi-level ORB extraction: pyramid -> FAST -> ANMS -> orientation
-> BRIEF, one fused jit per image size.

Equivalent of reference FeatureExtractor::extractKeysNew
(src/FeatureExtractor.cpp:481-533): geometric per-level feature quotas
(648-659), detection per level, keypoints rescaled to level-0 coordinates
(523-524). Output is a fixed-size structure-of-arrays (the TrackedKeys
analog, include/FeatureExtractor.h:18-50) with a validity mask.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.ops import fast, orb, patches, pyramid


class Keys(NamedTuple):
    """Fixed-size keypoint SoA (the TrackedKeys analog)."""

    xy: jax.Array  # (N, 2) f32 level-0 pixel coords
    octave: jax.Array  # (N,) int32
    response: jax.Array  # (N,) f32
    valid: jax.Array  # (N,) bool
    desc: jax.Array  # (N, 256) int8 +-1 (matmul form)
    packed: jax.Array  # (N, 8) uint32 (bit-packed form)
    angle: jax.Array  # (N,) f32 radians


def level_quotas(total: int, n_levels: int, scale: float) -> list[int]:
    """Geometric per-level quotas summing to `total` (reference
    src/FeatureExtractor.cpp:648-659)."""
    inv = 1.0 / scale
    first = total * (1.0 - inv) / (1.0 - inv**n_levels)
    quotas = [int(round(first * inv**l)) for l in range(n_levels - 1)]
    quotas.append(max(total - sum(quotas), 0))
    return quotas


def extract_batch(
    imgs: jax.Array,
    n_levels: int = 8,
    scale: float = 1.2,
    total: int = 2048,
    cell: int = 35,
    edge_margin: int = 19,
    fast_hi: float = 20.0,
    fast_lo: float = 7.0,
) -> Keys:
    """Batched extraction over (B, H, W) images (e.g. a stereo pair as one
    program). Detection runs per pyramid level (static shapes differ);
    each level's 31x31 patches are then gathered around the keypoints
    (ops/patches.extract_windows). Orientation + BRIEF are computed from
    the patches. All Keys fields carry a leading batch dim."""
    B, H, W = imgs.shape
    shapes = pyramid.level_shapes(H, W, n_levels, scale)
    quotas = level_quotas(total, n_levels, scale)

    P = orb.PATCH
    half = P // 2
    dlt = jnp.arange(-half, half + 1, dtype=jnp.int32)

    cur = imgs
    xs, resps, valids, patch_parts = [], [], [], []
    slot_level: list[int] = []
    for l in range(n_levels):
        h, w = shapes[l]
        if l > 0:
            cur = pyramid.resize_bilinear_batch(cur, h, w)
        quota = quotas[l]
        if quota <= 0:
            continue
        blurred = pyramid.gaussian_blur_batch(cur)
        margin = min(edge_margin, min(h, w) // 4)
        # ANMS cell adapted to the level quota (trace-time static): with
        # fewer cells than quota the coverage-first selection cannot
        # spread past one-corner-per-cell, so the cell shrinks until the
        # grid has at least `quota` cells — the role SSC's adaptive
        # suppression radius plays in the reference
        # (src/FeatureExtractor.cpp:368-468; tests/test_anms_ssc.py).
        cell_l = max(8, min(cell, int((h * w / max(quota, 1)) ** 0.5)))
        xy, resp, valid = jax.vmap(
            lambda im: fast.detect(
                im,
                threshold_hi=fast_hi,
                threshold_lo=fast_lo,
                cell=min(cell_l, max(h, w)),
                max_keypoints=quota,
                edge_margin=margin,
            )
        )(cur)
        xs.append(xy)
        resps.append(resp)
        valids.append(valid)
        slot_level += [l] * quota

        # patch extraction for this level's keypoints (ops/patches.py, a
        # gather). Exact for interior keypoints (the edge margin >= P/2
        # guarantees interiority of every valid key; border pad slots get
        # a shifted window, which only ever feeds masked-invalid
        # descriptors).
        x0 = jnp.clip(xy[:, :, 0] - half, 0, w - P)
        y0 = jnp.clip(xy[:, :, 1] - half, 0, h - P)
        patch_parts.append(patches.extract_windows(blurred, x0, y0, P, P))

    xy_lvl = jnp.concatenate(xs, axis=1)  # (B, N, 2) int32 level coords
    resp = jnp.concatenate(resps, axis=1)
    valid = jnp.concatenate(valids, axis=1)
    N = xy_lvl.shape[1]
    lvl = jnp.asarray(np.array(slot_level, np.int32))
    patch_all = jnp.concatenate(patch_parts, axis=1)  # (B, N, P, P)

    angle = orb.orientation_from_patches(patch_all)
    packed, signed = orb.brief_from_patches(patch_all, angle)

    sf = jnp.asarray(np.array([scale**l for l in slot_level], np.float32))
    return Keys(
        xy=xy_lvl.astype(jnp.float32) * sf[None, :, None],
        octave=jnp.broadcast_to(lvl[None], (B, N)),
        response=resp,
        valid=valid,
        desc=signed,
        packed=packed,
        angle=angle,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_levels",
        "scale",
        "total",
        "cell",
        "edge_margin",
        "fast_hi",
        "fast_lo",
    ),
)
def extract(
    img: jax.Array,
    n_levels: int = 8,
    scale: float = 1.2,
    total: int = 2048,
    cell: int = 35,
    edge_margin: int = 19,
    fast_hi: float = 20.0,
    fast_lo: float = 7.0,
) -> Keys:
    """Single-image extraction (extract_batch with B=1)."""
    keys = extract_batch(
        img[None],
        n_levels=n_levels,
        scale=scale,
        total=total,
        cell=cell,
        edge_margin=edge_margin,
        fast_hi=fast_hi,
        fast_lo=fast_lo,
    )
    return jax.tree.map(lambda a: a[0], keys)


def scale_factors(n_levels: int = 8, scale: float = 1.2) -> np.ndarray:
    return np.array([scale**l for l in range(n_levels)], np.float32)


def inv_sigma2(octave: jax.Array, n_levels: int = 8, scale: float = 1.2) -> jax.Array:
    """Per-octave information weight 1/sigma^2 with sigma = scale^octave
    (the reference's per-octave isotropic sigmas,
    src/FeatureTracker.cpp:239-240)."""
    sf = jnp.asarray(scale_factors(n_levels, scale))
    s = sf[jnp.clip(octave, 0, n_levels - 1)]
    return 1.0 / (s * s)
