"""Projection-guided landmark-to-keypoint matching (masked matmul reductions).

Replaces the reference's grid-index projection matchers
(FeatureMatcher::matchByProjectionRPred src/FeatureMatcher.cpp:254-389,
matchByProjectionRPredLBA 66-252, matchByProjectionMono 391-456,
matchByRadius 458-526, over the 64-wide cell grid built at
src/FeatureTracker.cpp:28-54). Here the grid index is unnecessary: the
full (M landmarks x N keys) Hamming matrix is one matmul, and the
spatial/octave/radius gates are elementwise masks on it.

Contracts preserved:
- search radius scales with the landmark's predicted octave
  (radius * scale^oct),
- candidate octave within [pred_oct - 1, pred_oct + 1],
- descriptor distance threshold (100 tracking / 50 LBA,
  include/FeatureMatcher.h:27-30),
- best/second-best ratio test (0.8 tracking / 0.6 LBA),
- one-to-one: each key keeps only its best landmark claimant
  (`matchedIdxsL` claiming semantics).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vslam_tpu.ops import hamming


@functools.partial(jax.jit, static_argnames=())
def match_by_projection(
    mp_pred: jax.Array,  # (M, 2) predicted pixel positions
    mp_oct: jax.Array,  # (M,) predicted octave
    mp_desc: jax.Array,  # (M, 256) int8 +-1
    mp_valid: jax.Array,  # (M,) bool
    k_xy: jax.Array,  # (N, 2) keypoint positions (level-0 coords)
    k_oct: jax.Array,  # (N,)
    k_desc: jax.Array,  # (N, 256)
    k_valid: jax.Array,  # (N,)
    radius: jax.Array,  # () dynamic search radius in px (octave-scaled)
    scale_factors: jax.Array,  # (n_levels,)
    desc_thr: jax.Array,  # () e.g. 100.0
    ratio: jax.Array,  # () e.g. 0.8
):
    """Returns (match_idx (M,) int32 into keys or -1, dist (M,) f32)."""
    d = hamming.hamming_matrix(mp_desc, k_desc, mp_valid, k_valid)  # (M, N)

    r = radius * scale_factors[jnp.clip(mp_oct, 0, scale_factors.shape[0] - 1)]
    diff = mp_pred[:, None, :] - k_xy[None, :, :]
    dist2 = jnp.sum(diff * diff, axis=-1)
    spatial_ok = dist2 <= (r * r)[:, None]
    oct_ok = jnp.abs(k_oct[None, :] - mp_oct[:, None]) <= 1
    d = jnp.where(spatial_ok & oct_ok, d, hamming.INVALID)

    best = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best[:, None], 1)[:, 0]
    # second best for the ratio test
    d2 = d.at[jnp.arange(d.shape[0]), best].set(hamming.INVALID)
    second_d = jnp.min(d2, axis=1)
    ok = (best_d <= desc_thr) & (best_d < ratio * second_d) & mp_valid

    # one-to-one: each key keeps the lowest-distance landmark claimant
    N = k_xy.shape[0]
    claim = jnp.where(ok, best_d, hamming.INVALID)
    min_per_key = jnp.full((N,), hamming.INVALID).at[best].min(claim)
    ok = ok & (claim <= min_per_key[best] + 1e-6)

    return jnp.where(ok, best, -1), jnp.where(ok, best_d, hamming.INVALID)


def predict_and_cull(
    T_wc: jax.Array,  # (4,4) predicted camera pose (left, cam-to-world)
    pts_w: jax.Array,  # (M, 3)
    mp_valid: jax.Array,  # (M,)
    K: jax.Array,
    baseline: jax.Array,
    width: int,
    height: int,
    max_dist: jax.Array,  # (M,) per-landmark max scale distance
    min_dist: jax.Array,  # (M,) min scale distance
    n_levels: int = 8,
    log_scale: float = 0.1823215568,  # ln(1.2)
):
    """Project active landmarks into the predicted frame; cull out-of-frame
    or out-of-scale-band points and predict the pyramid octave.

    Semantics of reference removeOutOfFrameMPs + worldToFrame +
    MapPoint::predictScale (src/FeatureTracker.cpp:685-741, 910-939;
    src/Map.cpp:91-96). Returns dict with pred_l (M,2), pred_r (M,2),
    in_l/in_r (M,) bool, pred_oct (M,) int32.
    """
    from vslam_tpu.geometry import se3 as _se3

    T_cw = _se3.inverse(T_wc)
    pc = _se3.transform_points(T_cw, pts_w)
    z = pc[..., 2]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u_l = fx * pc[..., 0] / zs + cx
    v_l = fy * pc[..., 1] / zs + cy
    u_r = fx * (pc[..., 0] - baseline) / zs + cx

    dist = jnp.linalg.norm(pc, axis=-1)
    in_front = z > 0.0
    in_bounds_l = (u_l >= 0) & (u_l < width) & (v_l >= 0) & (v_l < height)
    in_bounds_r = (u_r >= 0) & (u_r < width) & (v_l >= 0) & (v_l < height)
    # scale band: the distance range where this landmark's octave is valid
    band_ok = (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
    in_l = mp_valid & in_front & in_bounds_l & band_ok
    in_r = mp_valid & in_front & in_bounds_r & band_ok

    # predictScale: octave = ceil(log(maxDist / dist) / log(scale))
    ratio = jnp.maximum(max_dist, 1e-6) / jnp.maximum(dist, 1e-6)
    oct_f = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-6)) / log_scale)
    pred_oct = jnp.clip(oct_f, 0, n_levels - 1).astype(jnp.int32)

    return {
        "pred_l": jnp.stack([u_l, v_l], axis=-1),
        "pred_r": jnp.stack([u_r, v_l], axis=-1),
        "in_l": in_l,
        "in_r": in_r,
        "pred_oct": pred_oct,
        "depth": z,
    }
