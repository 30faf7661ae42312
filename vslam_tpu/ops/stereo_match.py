"""Batched stereo matching with sub-pixel disparity refinement.

Re-expression of reference FeatureMatcher::findStereoMatchesORB2R
(src/FeatureMatcher.cpp:528-708). Instead of row-bucket candidate lists and
scalar loops, we compute the full (N_left x N_right) masked Hamming matrix
as one matmul and reduce:

- row gate: |y_l - y_r| <= row_radius * scale^octave_r (replaces the
  destributeRightKeys row buckets at 728-752 — with correct bounds, fixing
  the unclamped-index quirk noted in SURVEY.md),
- octave gate: |oct_l - oct_r| <= 1 (reference line 581),
- disparity gate: 0 < u_l - u_r <= max_disparity (the reference's intent
  at 557-578; its y/x mixup quirk is documented, not reproduced),
- descriptor threshold 75 (include/FeatureMatcher.h:25),
- one-to-one: each right key keeps only its best left claimant,
- SAD refinement (radius-5 window slid +-5) + parabolic sub-pixel
  (reference 606-643), depth = fx * baseline / disparity (651-654),
- `close` split at depth < close_factor * baseline (40x, 661-665),
- statistical prunes: nearest-1%-of-depth and SAD > 1.5 * 1.4 * median
  (679-705).

All arrays are fixed-size with validity masks; the whole function jits to
one fused program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vslam_tpu.ops import hamming

DESC_THR = 75.0
SAD_RADIUS = 5
SAD_SLIDE = 5


def _gather_patch_rows(img, xc, yc, half_h, half_w):
    """(N, 2*half_h+1, 2*half_w+1) patches at integer centers.

    Row strips come from per-key dynamic_slices (rows are contiguous);
    columns are selected with a one-hot einsum (exact: one nonzero term
    per output). Keypoints closer than the window half-size to the border
    get a shifted (not clamped) window — the extractor's edge margin keeps
    every valid key interior."""
    H, W = img.shape
    Ph = 2 * half_h + 1
    dx = jnp.arange(-half_w, half_w + 1)
    y0 = jnp.clip(yc - half_h, 0, H - Ph)
    strips = jax.vmap(
        lambda y: jax.lax.dynamic_slice(img, (y, 0), (Ph, W))
    )(y0)  # (N, Ph, W)
    xs = jnp.clip(xc[:, None] + dx[None, :], 0, W - 1)  # (N, Pw)
    cols = (xs[..., None] == jnp.arange(W)[None, None]).astype(jnp.float32)
    return jnp.einsum(
        "npw,nqw->npq", strips, cols, precision=jax.lax.Precision.HIGHEST
    )


@functools.partial(jax.jit, static_argnames=("close_factor",))
def match_stereo(
    left_img: jax.Array,
    right_img: jax.Array,
    kl_xy: jax.Array,  # (N, 2) f32 level-0 coords
    kl_oct: jax.Array,  # (N,) int32
    kl_desc: jax.Array,  # (N, 256) int8 +-1
    kl_valid: jax.Array,  # (N,) bool
    kr_xy: jax.Array,
    kr_oct: jax.Array,
    kr_desc: jax.Array,
    kr_valid: jax.Array,
    fx: jax.Array,
    baseline: jax.Array,
    scale_factors: jax.Array,  # (n_levels,) scale^l
    close_factor: float = 40.0,
):
    """Returns a dict with per-left-key stereo results:
    ``idx_r`` (N,) int32 matched right index or -1, ``disparity`` (N,) f32
    sub-pixel, ``depth`` (N,) f32, ``matched``/``close`` (N,) bool,
    ``est_right_x`` (N,) f32 refined right-image x.
    """
    N = kl_xy.shape[0]
    d = hamming.hamming_matrix(kl_desc, kr_desc, kl_valid, kr_valid)  # (N, M)

    row_tol = 2.0 * scale_factors[jnp.clip(kr_oct, 0, scale_factors.shape[0] - 1)]
    dy = jnp.abs(kl_xy[:, 1:2] - kr_xy[None, :, 1])
    row_ok = dy <= row_tol[None, :]
    oct_ok = jnp.abs(kl_oct[:, None] - kr_oct[None, :]) <= 1
    disp = kl_xy[:, 0:1] - kr_xy[None, :, 0]
    max_disp = fx * baseline / 0.3  # depth >= 0.3 m
    disp_ok = (disp > 0.0) & (disp <= max_disp)
    mask = row_ok & oct_ok & disp_ok
    d = jnp.where(mask, d, hamming.INVALID)

    best = jnp.argmin(d, axis=1)  # (N,)
    best_d = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
    matched = best_d <= DESC_THR

    # one-to-one: a right key keeps only the left claimant with least distance
    M = kr_xy.shape[0]
    claim_d = jnp.where(matched, best_d, hamming.INVALID)
    min_per_right = jnp.full((M,), hamming.INVALID).at[best].min(claim_d)
    keep = matched & (claim_d <= min_per_right[best] + 1e-6)
    matched = keep

    # ---- SAD refinement + parabolic sub-pixel (reference 606-643) ----
    xl = jnp.round(kl_xy[:, 0]).astype(jnp.int32)
    yl = jnp.round(kl_xy[:, 1]).astype(jnp.int32)
    xr = jnp.round(kr_xy[best, 0]).astype(jnp.int32)
    yr = jnp.round(kr_xy[best, 1]).astype(jnp.int32)
    lp = _gather_patch_rows(left_img, xl, yl, SAD_RADIUS, SAD_RADIUS)  # (N,11,11)
    rp = _gather_patch_rows(right_img, xr, yr, SAD_RADIUS, SAD_RADIUS + SAD_SLIDE)
    # normalize by center intensity like the reference (IL - cl vs IR - cr)
    lc = lp[:, SAD_RADIUS, SAD_RADIUS][:, None, None]
    lpn = lp - lc
    sads = []
    for s in range(2 * SAD_SLIDE + 1):
        win = jax.lax.dynamic_slice_in_dim(rp, s, 2 * SAD_RADIUS + 1, axis=2)
        cc = win[:, SAD_RADIUS, SAD_RADIUS][:, None, None]
        sads.append(jnp.sum(jnp.abs(lpn - (win - cc)), axis=(1, 2)))
    sad = jnp.stack(sads, axis=1)  # (N, 11) offsets -5..+5
    best_off = jnp.argmin(sad, axis=1)
    best_sad = jnp.take_along_axis(sad, best_off[:, None], 1)[:, 0]
    # parabola over (prev, best, next); clamp interior
    off_c = jnp.clip(best_off, 1, 2 * SAD_SLIDE - 1)
    s_m = jnp.take_along_axis(sad, (off_c - 1)[:, None], 1)[:, 0]
    s_0 = jnp.take_along_axis(sad, off_c[:, None], 1)[:, 0]
    s_p = jnp.take_along_axis(sad, (off_c + 1)[:, None], 1)[:, 0]
    denom = s_m - 2.0 * s_0 + s_p
    delta = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (s_m - s_p) / denom, 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    sub = off_c.astype(jnp.float32) + delta - SAD_SLIDE  # signed refinement of xr
    est_right_x = kr_xy[best, 0] + sub
    disparity = kl_xy[:, 0] - est_right_x
    interior = (best_off >= 1) & (best_off <= 2 * SAD_SLIDE - 1)
    good_disp = disparity > 0.05
    matched = matched & good_disp & interior

    depth = jnp.where(matched, fx * baseline / jnp.maximum(disparity, 1e-6), 0.0)

    # ---- statistical prunes (reference 679-705) ----
    n_match = jnp.maximum(jnp.sum(matched), 1)
    # nearest 1% of depths pruned: depth below the 1st percentile of matched
    sort_depth = jnp.sort(jnp.where(matched, depth, jnp.inf))
    k1 = jnp.clip((n_match * 1) // 100, 0, N - 1)
    depth_cut = sort_depth[k1]
    # SAD > 1.5 * 1.4 * median pruned
    sort_sad = jnp.sort(jnp.where(matched, best_sad, jnp.inf))
    med_sad = sort_sad[jnp.clip(n_match // 2, 0, N - 1)]
    sad_ok = best_sad <= 1.5 * 1.4 * med_sad + 1e-6
    matched = matched & (depth >= depth_cut) & sad_ok

    close = matched & (depth < close_factor * baseline) & (depth > 0)
    idx_r = jnp.where(matched, best, -1)
    depth = jnp.where(matched, depth, 0.0)
    return {
        "idx_r": idx_r,
        "disparity": jnp.where(matched, disparity, 0.0),
        "depth": depth,
        "matched": matched,
        "close": close,
        "est_right_x": jnp.where(matched, est_right_x, 0.0),
        "desc_dist": best_d,
    }
