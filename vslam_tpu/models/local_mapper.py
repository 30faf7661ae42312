"""Local mapping backend: window assembly, 2-round local BA, write-back.

Replaces reference LocalMapper (include/OptimizationBA.h:32-90,
src/OptimizationBA.cpp): the 20 ms polling thread + mutex protocol
(955-982) becomes an explicit call on map snapshots — the tracker hands
over a KF slot, the mapper assembles the covisibility window
(lastKF + <= 10 covisible, 963-967), runs the Schur-complement LM
(vslam_tpu/ops/schur.py) for 5 iterations, sweeps chi-squared outliers
(788-871), runs 10 more iterations, and scatters results back
(875-938). The caller may run it synchronously per KF or on a background
thread (device execution is async either way; see models/system.py).
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.geometry import se3, triangulate
from vslam_tpu.models import map_state
from vslam_tpu.ops import extract, hamming, schur
from vslam_tpu.utils import metrics as metrics_mod

WINDOW = 12  # last KF + <=10 covisible + 1 pad (static shape)
ANCHORS = 8  # fixed out-of-window observer KFs: the reference adds EVERY
#              non-window KF observing a window landmark as a gauge-fixed
#              pose WITH its observations (src/OptimizationBA.cpp:445-516)
#              — those residuals anchor window landmarks to the rest of the
#              map; without them the window drifts as a rigid block
WTOT = WINDOW + ANCHORS  # total pose slots in a BA problem (static shape)


def _round_cap(n: int, lo: int, hi: int) -> int:
    """Smallest power-of-two multiple of `lo` >= n, clamped to [lo, hi].

    Used ONLY by offline paths (run_global): the live mapper pins ONE
    (obs_cap, L_cap) shape per instance instead — round 2 let these caps
    step mid-run as the map grew, and every threshold crossing recompiled
    the fused 2-round BA + _assemble_device inside the timed frame loop
    (multi-second compiles that regressed the bench ~10x)."""
    c = lo
    while c < n and c < hi:
        c *= 2
    return min(c, hi)
LM_SLOTS = 4096  # landmark slots per BA problem (static shape)
SPAWN_TRI = 512  # new-landmark budget per triangulation pass (static shape)


@functools.partial(
    jax.jit, static_argnames=("lm_capacity", "n_levels", "scale", "obs_cap")
)
def _assemble_device(
    m: map_state.MapArrays,
    kf_slots: jax.Array,  # (WTOT,) int32 — [window | fixed anchors | pad]
    kf_valid: jax.Array,  # (WTOT,) bool
    lm_ids: jax.Array,  # (LM_SLOTS,) int32 sorted, sentinel-padded
    lm_pad_valid: jax.Array,  # (LM_SLOTS,) bool
    fixed: jax.Array,  # (WTOT,) bool
    odo_mask: jax.Array,  # (WTOT-1,) bool — links inside the temporally-
    #                        sorted window prefix only (anchors are not
    #                        temporally adjacent; a bogus between-residual
    #                        would pollute the LM error)
    K: jax.Array,
    baseline,
    lm_capacity: int,
    n_levels: int,
    scale: float,
    obs_cap: int,
):
    """All device-side BA-problem construction as ONE program: window
    gathers, the observation->local-landmark mapping (device searchsorted —
    sees in-flight triangulation updates the host mirrors do not), the
    odometry chain from the device poses (reference 750-768), and
    observation-row COMPACTION: the raw [Wb*K | Wb*Kr] table is ~80-90%
    padding (key slots with no landmark), and every BA iteration pays
    O(rows) Jacobian + scatter-assembly work — a stable argsort moves the
    live rows to an obs_cap-slot prefix (12x fewer rows at bench scale).
    Returns (problem, lm_safe, take) where take[i] is the original flat
    row index of compacted row i (needed to map kill flags back to
    observation-table coordinates)."""
    Wb = kf_slots.shape[0]
    K_keys = m.obs_lm.shape[1]
    lm_safe = jnp.clip(lm_ids, 0, lm_capacity - 1)

    poses = m.kf_pose[kf_slots]
    pts = m.lm_pos[lm_safe]
    pt_valid = lm_pad_valid & m.lm_valid[lm_safe]

    obs_kf = jnp.repeat(jnp.arange(Wb, dtype=jnp.int32), K_keys)
    flat = m.obs_lm[kf_slots].reshape(-1)
    row_ok = jnp.repeat(kf_valid, K_keys)
    local = jnp.clip(
        jnp.searchsorted(lm_ids, jnp.maximum(flat, 0)), 0, lm_ids.shape[0] - 1
    )
    hit = (flat >= 0) & (lm_ids[local] == flat) & row_ok
    obs_lm = jnp.where(hit, local, 0).astype(jnp.int32)

    obs_uv = m.obs_uv[kf_slots].reshape(-1, 3)
    obs_oct = m.obs_oct[kf_slots].reshape(-1)
    obs_stereo = m.obs_stereo[kf_slots].reshape(-1)
    obs_w = jnp.sqrt(extract.inv_sigma2(obs_oct, n_levels, scale))

    # right-camera-only observation rows appended after the left rows
    # (reference right-branch projection factors,
    # src/OptimizationBA.cpp:592-740)
    Kr = m.obs_r_lm.shape[1]
    obs_kf_r = jnp.repeat(jnp.arange(Wb, dtype=jnp.int32), Kr)
    flat_r = m.obs_r_lm[kf_slots].reshape(-1)
    row_ok_r = jnp.repeat(kf_valid, Kr)
    local_r = jnp.clip(
        jnp.searchsorted(lm_ids, jnp.maximum(flat_r, 0)), 0, lm_ids.shape[0] - 1
    )
    hit_r = (flat_r >= 0) & (lm_ids[local_r] == flat_r) & row_ok_r
    obs_lm_r = jnp.where(hit_r, local_r, 0).astype(jnp.int32)
    uv_r = m.obs_r_uv[kf_slots].reshape(-1, 2)
    obs_uv_r = jnp.concatenate([uv_r, jnp.zeros((uv_r.shape[0], 1))], axis=-1)
    oct_r = m.obs_r_oct[kf_slots].reshape(-1)
    obs_w_r = jnp.sqrt(extract.inv_sigma2(oct_r, n_levels, scale))

    odo_rel = jax.vmap(lambda a, b: se3.inverse(a) @ b)(poses[:-1], poses[1:])
    odo_valid = kf_valid[:-1] & kf_valid[1:] & odo_mask

    all_hit = jnp.concatenate([hit, hit_r])
    # stable: live rows keep their original relative order; ties broken by
    # row index, so overflow (more live rows than obs_cap) drops the LAST
    # right-camera rows rather than scrambling. n_live travels back to the
    # host so truncation is OBSERVABLE (a counter + log), never silent.
    take = jnp.argsort(~all_hit)[:obs_cap].astype(jnp.int32)
    ok = all_hit[take]
    n_live = jnp.sum(all_hit).astype(jnp.int32)
    p = schur.BAProblem(
        poses=poses,
        fixed=fixed,
        pose_valid=kf_valid,
        pts=pts,
        pt_valid=pt_valid,
        obs_kf=jnp.concatenate([obs_kf, obs_kf_r])[take],
        obs_lm=jnp.concatenate([obs_lm, obs_lm_r])[take],
        obs_uv=jnp.concatenate([obs_uv, obs_uv_r])[take],
        obs_stereo=jnp.concatenate(
            [obs_stereo, jnp.zeros_like(hit_r)]
        )[take],
        obs_right=jnp.concatenate([jnp.zeros_like(hit), hit_r])[take],
        obs_w=jnp.concatenate([obs_w, obs_w_r])[take],
        obs_valid=ok,
        K=K,
        baseline=baseline,
        odo_rel=odo_rel,
        odo_valid=odo_valid,
    )
    return p, lm_safe, take, n_live


@functools.partial(jax.jit, static_argnames=("n_levels", "scale"))
def _triangulate_new_points(
    m: map_state.MapArrays,
    window_slots: jax.Array,  # (V,) int32, newest LAST
    window_valid: jax.Array,  # (V,) bool
    spawn_slots: jax.Array,  # (SPAWN_TRI,) preallocated landmark slots
    spawn_avail: jax.Array,  # (SPAWN_TRI,) bool
    K: jax.Array,
    baseline: jax.Array,
    n_levels: int = 8,
    scale: float = 1.2,
):
    """Multi-view triangulation of new landmarks (reference findNewPoints,
    src/OptimizationBA.cpp:340-391): unmatched stereo keys of the newest KF
    are projected into the covisibility window, matched by projection
    (rad 4, thr 50, ratio 0.6 — matchByProjectionRPredLBA semantics,
    src/FeatureMatcher.cpp:66-252), triangulated by batched DLT over all
    observing views + the newest stereo pair, and validated with >= 3 views
    and the chi-squared gate (checkReprojError, 14-88)."""
    V = window_slots.shape[0]
    newest = window_slots[V - 1]
    Kk = m.obs_uv.shape[1]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    sf = jnp.asarray([scale**l for l in range(n_levels)], jnp.float32)

    uv_n = m.obs_uv[newest]  # (Kk, 3)
    oct_n = m.obs_oct[newest]
    st_n = m.obs_stereo[newest]
    lm_n = m.obs_lm[newest]
    desc_n = hamming.unpack_signed(m.obs_desc[newest])
    valid_n = m.obs_valid[newest]
    pose_n = m.kf_pose[newest]

    disp = uv_n[:, 0] - uv_n[:, 2]
    cand = valid_n & st_n & (lm_n < 0) & (disp > 0.05)
    depth = fx * baseline / jnp.maximum(disp, 1e-6)
    pc = jnp.stack(
        [(uv_n[:, 0] - cx) / fx * depth, (uv_n[:, 1] - cy) / fy * depth, depth],
        axis=-1,
    )
    pts_w0 = se3.transform_points(pose_n, pc)  # initial candidate positions

    # --- match candidates into each older window KF (left camera) ---
    def match_one_view(v):
        slot = window_slots[v]
        ok_view = window_valid[v] & (slot != newest)
        pose_v = m.kf_pose[slot]
        T_cw = se3.inverse(pose_v)
        p_cam = se3.transform_points(T_cw, pts_w0)
        z = p_cam[:, 2]
        zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        pu = fx * p_cam[:, 0] / zs + cx
        pv = fy * p_cam[:, 1] / zs + cy

        keys_uv = m.obs_uv[slot][:, :2]
        keys_oct = m.obs_oct[slot]
        keys_desc = hamming.unpack_signed(m.obs_desc[slot])
        keys_free = m.obs_valid[slot] & (m.obs_lm[slot] < 0)

        d = hamming.hamming_matrix(desc_n, keys_desc, cand & (z > 0.0), keys_free)
        rad = 4.0 * sf[jnp.clip(oct_n, 0, n_levels - 1)]
        du = pu[:, None] - keys_uv[None, :, 0]
        dv = pv[:, None] - keys_uv[None, :, 1]
        dist2 = du * du + dv * dv
        gate = (dist2 <= (rad * rad)[:, None]) & (
            jnp.abs(keys_oct[None, :] - oct_n[:, None]) <= 1
        )
        d = jnp.where(gate & ok_view, d, hamming.INVALID)
        best = jnp.argmin(d, axis=1)
        best_d = jnp.take_along_axis(d, best[:, None], 1)[:, 0]
        # ratio-test second excludes <3 px neighbors of the best (multi-
        # octave duplicate detections; see mono variant)
        best_uv = keys_uv[best]
        near_best = (keys_uv[None, :, 0] - best_uv[:, 0:1]) ** 2 + (
            keys_uv[None, :, 1] - best_uv[:, 1:2]
        ) ** 2 < 9.0
        second = jnp.min(jnp.where(near_best, hamming.INVALID, d), axis=1)
        okm = (best_d <= 50.0) & (best_d < 0.6 * second)
        # one-to-one per view
        claim = jnp.where(okm, best_d, hamming.INVALID)
        min_per_key = jnp.full((Kk,), hamming.INVALID).at[best].min(claim)
        okm = okm & (claim <= min_per_key[best] + 1e-6)
        uv_m = keys_uv[best]
        return (
            jnp.where(okm[:, None], uv_m, 0.0),
            jnp.where(okm, best, -1),
        )

    # vmap, not lax.map: the 11 per-view matches are one batched program
    # (one (V-1)*Kk x Kk Hamming matmul) instead of 11 serial
    # dispatches
    uv_views, key_views = jax.vmap(match_one_view)(jnp.arange(V - 1))
    # (V-1, Kk, 2), (V-1, Kk)

    # --- assemble triangulation problem: V-1 older views + newest L + newest R
    P_l = triangulate.projection_matrices(m.kf_pose[window_slots], K)  # (V,3,4)
    P_r = triangulate.projection_matrices(
        pose_n[None], K, baseline_shift=jnp.asarray([baseline])
    )  # (1,3,4)
    P_all = jnp.concatenate([P_l[:-1], P_l[-1:], P_r], axis=0)  # (V+1,3,4)

    uv_all = jnp.concatenate(
        [
            jnp.swapaxes(uv_views, 0, 1),  # (Kk, V-1, 2)
            uv_n[:, None, :2],  # newest left
            jnp.stack([uv_n[:, 2], uv_n[:, 1]], axis=-1)[:, None, :],  # newest right
        ],
        axis=1,
    )  # (Kk, V+1, 2)
    mask = jnp.concatenate(
        [
            jnp.swapaxes(key_views >= 0, 0, 1),
            cand[:, None],
            cand[:, None],
        ],
        axis=1,
    )
    pts_tri = triangulate.triangulate_dlt(P_all, uv_all, mask)
    pts_tri = triangulate.refine_triangulation(pts_tri, P_all, uv_all, mask)
    inv_s2 = extract.inv_sigma2(oct_n, n_levels, scale)[:, None]
    ok_tri, _ = triangulate.validate_triangulation(
        pts_tri, P_all, uv_all, mask, jnp.broadcast_to(inv_s2, mask.shape),
        chi2_thr=7.815, min_views=3,
    )
    # conditioning gate (the analog of gtsam::triangulatePoint3's degeneracy
    # exceptions, which the reference catches and skips at
    # src/OptimizationBA.cpp:184-196): reprojection chi2 cannot see error
    # ALONG the ray, so a low-parallax candidate passes validation with
    # arbitrarily wrong depth — depth sigma ~ z^2 / (f * B) amplifies any
    # keyframe-pose noise ~50x and destabilizes the tracking<->mapping
    # feedback loop. Require depth < 40 x the widest observing baseline
    # (the stereo close-point rule, include/FeatureMatcher.h:36, extended
    # to the multi-view case).
    centers = m.kf_pose[window_slots][:, :3, 3]  # (V, 3)
    base_v = jnp.linalg.norm(centers - pose_n[:3, 3][None], axis=-1)  # (V,)
    bl_views = jnp.where(key_views >= 0, base_v[: V - 1][:, None], 0.0)
    max_bl = jnp.maximum(jnp.max(bl_views, axis=0), baseline)  # (Kk,)
    T_nw = se3.inverse(pose_n)
    z_new = se3.transform_points(T_nw, pts_tri)[:, 2]
    conditioned = (z_new > 0.0) & (z_new < 40.0 * max_bl)
    ok = ok_tri & cand & conditioned

    # --- compact to the spawn budget and assign slots ---
    order = jnp.argsort(~ok)  # ok candidates first (stable)
    take = order[:SPAWN_TRI]
    take_ok = ok[take] & spawn_avail
    slot_of_cand = jnp.full((Kk + 1,), -1, jnp.int32)
    slot_of_cand = slot_of_cand.at[jnp.where(take_ok, take, Kk)].set(
        jnp.where(take_ok, spawn_slots, -1)
    )[:Kk]

    dist = jnp.linalg.norm(
        pts_tri - pose_n[:3, 3][None, :], axis=-1
    )
    sfo = sf[jnp.clip(oct_n, 0, n_levels - 1)]
    maxdist = dist * sfo
    mindist = maxdist / (scale ** (n_levels - 1))

    return {
        "spawn_pos": pts_tri[take],
        "spawn_desc": desc_n[take],
        "spawn_maxdist": maxdist[take],
        "spawn_mindist": mindist[take],
        "spawn_valid": take_ok,
        "slot_of_cand": slot_of_cand,  # (Kk,) landmark slot per newest-KF key or -1
        "key_views": key_views,  # (V-1, Kk) matched key idx per older view
        "n_new": jnp.sum(take_ok),
        # single packed fetch for the host (one device->host round trip
        # instead of three): [slot_of_cand | key_views | n_new]
        "host_blob": jnp.concatenate(
            [
                slot_of_cand.astype(jnp.float32),
                key_views.astype(jnp.float32).reshape(-1),
                jnp.sum(take_ok).astype(jnp.float32)[None],
            ]
        ),
    }


@functools.partial(jax.jit, static_argnames=("n_levels", "scale"))
def _triangulate_new_points_mono(
    m: map_state.MapArrays,
    window_slots: jax.Array,  # (V,) int32, newest LAST
    window_valid: jax.Array,  # (V,) bool
    spawn_slots: jax.Array,  # (SPAWN_TRI,)
    spawn_avail: jax.Array,  # (SPAWN_TRI,) bool
    K: jax.Array,
    radius: jax.Array,  # match radius in px (reference mono 120/1200,
    #                      src/FeatureTracker.cpp:1400, 1518)
    min_parallax_px: jax.Array,  # pixel-parallax gate (reference 10 px,
    #                      include/Conversions.h:140-144)
    n_levels: int = 8,
    scale: float = 1.2,
):
    """Mono multi-view triangulation (reference addMappointsMono /
    calculateMPFromMono, src/FeatureTracker.cpp:1497-1684): unmatched keys
    of the newest KF are matched into the window by RADIUS around their own
    pixel (matchByRadius semantics, src/FeatureMatcher.cpp:458-526) with a
    pixel-parallax gate, then DLT-triangulated over >= 2 observing views
    (reference monoKFsToMP minimum, include/FeatureTracker.h:55)."""
    V = window_slots.shape[0]
    newest = window_slots[V - 1]
    Kk = m.obs_uv.shape[1]
    sf = jnp.asarray([scale**l for l in range(n_levels)], jnp.float32)

    uv_n = m.obs_uv[newest][:, :2]
    oct_n = m.obs_oct[newest]
    lm_n = m.obs_lm[newest]
    desc_n = hamming.unpack_signed(m.obs_desc[newest])
    valid_n = m.obs_valid[newest]
    pose_n = m.kf_pose[newest]

    cand = valid_n & (lm_n < 0)
    K_inv = jnp.linalg.inv(K)
    xh_n = jnp.concatenate([uv_n, jnp.ones((Kk, 1))], axis=-1)  # (Kk, 3)

    def match_one_view(v):
        slot = window_slots[v]
        ok_view = window_valid[v] & (slot != newest)
        pose_v = m.kf_pose[slot]
        keys_uv = m.obs_uv[slot][:, :2]
        keys_oct = m.obs_oct[slot]
        keys_desc = hamming.unpack_signed(m.obs_desc[slot])
        keys_free = m.obs_valid[slot] & (m.obs_lm[slot] < 0)

        d = hamming.hamming_matrix(desc_n, keys_desc, cand, keys_free)
        rad = radius * sf[jnp.clip(oct_n, 0, n_levels - 1)]
        du = uv_n[:, None, 0] - keys_uv[None, :, 0]
        dv = uv_n[:, None, 1] - keys_uv[None, :, 1]
        dist2 = du * du + dv * dv

        # epipolar gate: the candidate has no depth, but the keyframe poses
        # are known (IMU dead-reckoned), so its match in view v must lie
        # near the epipolar line l = F x. This is what makes the ratio test
        # meaningful on self-similar texture — candidates compete only
        # along the line, not across the whole search disk.
        T_nv = se3.inverse(pose_v) @ pose_n  # newest-cam -> view-cam
        E = se3.hat(T_nv[:3, 3]) @ T_nv[:3, :3]
        F = K_inv.T @ E @ K_inv
        l = xh_n @ F.T  # (Kk, 3) lines in view v
        num = jnp.abs(
            l[:, None, 0] * keys_uv[None, :, 0]
            + l[:, None, 1] * keys_uv[None, :, 1]
            + l[:, None, 2]
        )
        den = jnp.sqrt(l[:, 0] ** 2 + l[:, 1] ** 2 + 1e-12)[:, None]
        epi_ok = num <= 4.0 * sf[jnp.clip(oct_n, 0, n_levels - 1)][:, None] * den

        # TRUE pixel parallax = offset from the INFINITE-DEPTH transfer
        # point (rotation-only warp of the newest key into view v), not
        # from the raw key pixel: raw pixel distance conflates
        # rotation-induced shift (which carries no depth information)
        # with parallax, and under forward-dominant motion it sits below
        # the gate for almost every TRUE match — which silently excluded
        # the true correspondences and let only large-offset aliases
        # through (the broken-mono-init root cause).
        x_inf = (K @ (T_nv[:3, :3] @ (K_inv @ xh_n.T))).T  # (Kk, 3)
        z_inf = x_inf[:, 2:3]
        uv_inf = jnp.where(
            z_inf > 1e-6, x_inf[:, :2] / jnp.maximum(z_inf, 1e-6), uv_n
        )
        pu = uv_inf[:, None, 0] - keys_uv[None, :, 0]
        pv = uv_inf[:, None, 1] - keys_uv[None, :, 1]
        par2 = pu * pu + pv * pv

        gate = (
            (dist2 <= (rad * rad)[:, None])
            & (par2 >= (min_parallax_px * min_parallax_px))
            & epi_ok
            & (jnp.abs(keys_oct[None, :] - oct_n[:, None]) <= 1)
        )
        d = jnp.where(gate & ok_view, d, hamming.INVALID)
        best = jnp.argmin(d, axis=1)
        best_d = jnp.take_along_axis(d, best[:, None], 1)[:, 0]
        # second-best for the ratio test EXCLUDING keys within 3 px of the
        # best — multi-octave duplicates of the same corner carry
        # near-identical descriptors and would veto every true match
        best_uv = keys_uv[best]
        near_best = (keys_uv[None, :, 0] - best_uv[:, 0:1]) ** 2 + (
            keys_uv[None, :, 1] - best_uv[:, 1:2]
        ) ** 2 < 9.0
        second = jnp.min(jnp.where(near_best, hamming.INVALID, d), axis=1)
        # mono thresholds relaxed by +50/+0.1 (reference matchByProjectionMono
        # quirk, src/FeatureMatcher.cpp:442-447)
        okm = (best_d <= 100.0) & (best_d < 0.7 * second)
        claim = jnp.where(okm, best_d, hamming.INVALID)
        min_per_key = jnp.full((Kk,), hamming.INVALID).at[best].min(claim)
        okm = okm & (claim <= min_per_key[best] + 1e-6)
        uv_m = keys_uv[best]
        return (
            jnp.where(okm[:, None], uv_m, 0.0),
            jnp.where(okm, best, -1),
        )

    uv_views, key_views = jax.vmap(match_one_view)(jnp.arange(V - 1))

    P_l = triangulate.projection_matrices(m.kf_pose[window_slots], K)  # (V,3,4)
    uv_all = jnp.concatenate(
        [jnp.swapaxes(uv_views, 0, 1), uv_n[:, None, :]], axis=1
    )  # (Kk, V, 2)
    mask = jnp.concatenate(
        [jnp.swapaxes(key_views >= 0, 0, 1), cand[:, None]], axis=1
    )
    pts_tri = triangulate.triangulate_dlt(P_l, uv_all, mask)
    pts_tri = triangulate.refine_triangulation(pts_tri, P_l, uv_all, mask)
    inv_s2 = extract.inv_sigma2(oct_n, n_levels, scale)[:, None]
    ok_tri, _ = triangulate.validate_triangulation(
        pts_tri, P_l, uv_all, mask, jnp.broadcast_to(inv_s2, mask.shape),
        chi2_thr=7.815, min_views=2,
    )
    # triangulation-angle conditioning: the rays from at least one
    # observing pair must subtend >= ~1 deg (cos 0.99985, the ORB-SLAM
    # init criterion) — with short forward baselines a 2-view DLT is
    # near-degenerate and reprojection chi2 alone accepts arbitrary
    # near-camera junk (measured: 96 'landmarks' at 0.03-3 m in a
    # 2-15 m scene)
    centers = m.kf_pose[window_slots][:, :3, 3]  # (V, 3)
    rays = pts_tri[:, None, :] - centers[None, :, :]  # (Kk, V, 3)
    rays = rays / jnp.maximum(
        jnp.linalg.norm(rays, axis=-1, keepdims=True), 1e-9
    )
    cos_n = jnp.sum(rays * rays[:, -1:, :], axis=-1)  # vs newest view
    cos_min = jnp.min(
        jnp.where(mask[:, :-1], cos_n[:, :-1], 1.0), axis=-1
    )
    ok = ok_tri & cand & (cos_min <= 0.99985)

    order = jnp.argsort(~ok)
    take = order[:SPAWN_TRI]
    take_ok = ok[take] & spawn_avail
    slot_of_cand = jnp.full((Kk + 1,), -1, jnp.int32)
    slot_of_cand = slot_of_cand.at[jnp.where(take_ok, take, Kk)].set(
        jnp.where(take_ok, spawn_slots, -1)
    )[:Kk]

    dist = jnp.linalg.norm(pts_tri - pose_n[:3, 3][None, :], axis=-1)
    sfo = sf[jnp.clip(oct_n, 0, n_levels - 1)]
    maxdist = dist * sfo
    mindist = maxdist / (scale ** (n_levels - 1))

    return {
        "spawn_pos": pts_tri[take],
        "spawn_desc": desc_n[take],
        "spawn_maxdist": maxdist[take],
        "spawn_mindist": mindist[take],
        "spawn_valid": take_ok,
        "slot_of_cand": slot_of_cand,
        "key_views": key_views,
        "n_new": jnp.sum(take_ok),
        "host_blob": jnp.concatenate(
            [
                slot_of_cand.astype(jnp.float32),
                key_views.astype(jnp.float32).reshape(-1),
                jnp.sum(take_ok).astype(jnp.float32)[None],
            ]
        ),
    }


@jax.jit
def _apply_triangulation(
    m: map_state.MapArrays,
    window_slots: jax.Array,  # (V,)
    slot_of_cand: jax.Array,  # (Kk,)
    key_views: jax.Array,  # (V-1, Kk)
):
    """Write new landmark ids into the newest KF's and the older views'
    observation tables, AND fold each older view's key descriptor into the
    landmark's majority accumulator (lm_bitsum/lm_nobs): every observation
    that enters a landmark's set must contribute to the bit-sum, because
    writeback_ba SUBTRACTS it again when a chi-squared kill severs the
    observation — without the fold here, killing a triangulated view
    subtracted a never-added descriptor, drifting lm_nobs negative and the
    majority away from the true observation-set median over long runs.
    (The newest KF's own view is already folded: scatter_landmarks seeds
    lm_bitsum with the spawn descriptor = that key's descriptor.)"""
    V = window_slots.shape[0]
    newest = window_slots[V - 1]
    Kk = slot_of_cand.shape[0]
    P = m.lm_pos.shape[0]
    # newest KF: candidate key j -> its own slot
    has = slot_of_cand >= 0
    new_row = jnp.where(has, slot_of_cand, m.obs_lm[newest])
    obs_lm = m.obs_lm.at[newest].set(new_row)

    # older views: key_views[v, j] observes slot_of_cand[j]
    def body(v, carry):
        obs_lm, bitsum, nobs = carry
        slot = window_slots[v]
        kv = key_views[v]
        okv = (kv >= 0) & has
        tgt_key = jnp.where(okv, kv, Kk)  # index Kk is out of bounds -> drop
        obs_lm = obs_lm.at[slot, tgt_key].set(
            jnp.where(okv, slot_of_cand, -1), mode="drop"
        )
        d16 = hamming.unpack_signed(
            m.obs_desc[slot, jnp.where(okv, kv, 0)]
        ).astype(jnp.int16)
        tgt_lm = jnp.where(okv, slot_of_cand, P)
        bitsum = bitsum.at[tgt_lm].add(d16, mode="drop")
        nobs = nobs.at[tgt_lm].add(1, mode="drop")
        return obs_lm, bitsum, nobs

    obs_lm, bitsum, nobs = jax.lax.fori_loop(
        0, V - 1, body, (obs_lm, m.lm_bitsum, m.lm_nobs)
    )
    # refresh the representative descriptor of the spawned slots to the
    # new multi-view majority (ties keep the spawn descriptor)
    tgt = jnp.where(has, slot_of_cand, P)
    safe = jnp.where(has, slot_of_cand, 0)
    bs = bitsum[safe]
    maj = jnp.where(
        bs > 0, 1, jnp.where(bs < 0, -1, m.lm_desc[safe])
    ).astype(jnp.int8)
    lm_desc = m.lm_desc.at[tgt].set(maj, mode="drop")
    return dataclasses.replace(
        m, obs_lm=obs_lm, lm_bitsum=bitsum, lm_nobs=nobs, lm_desc=lm_desc
    )


def pending_ready(pending: dict) -> bool:
    """True once a prefetched pending handle's result blobs have landed
    in host memory (consume will not block). Without a prefetch this is
    conservatively False: readiness comes from the prefetch Future, not
    from jax.Array.is_ready."""
    fut = pending.get("fetch")
    return fut is not None and fut.done()


@dataclasses.dataclass
class LocalMapperConfig:
    max_covisible: int = 10  # reference window size
    min_covis_weight: int = 15
    iters_round1: int = 5  # reference src/OptimizationBA.cpp:772-777
    iters_round2: int = 10
    n_levels: int = 8
    scale: float = 1.2
    # PINNED problem shapes for the live local-BA path (one compiled
    # program per LocalMapper instance — a per-size shape menu recompiles
    # mid-run, each a multi-second compile inside the frame loop).
    # None -> obs_cap defaults to min(16384, full window rows) and lm_cap
    # to LM_SLOTS. Overflow beyond obs_cap is counted + logged, not silent.
    obs_cap: int | None = None
    lm_cap: int | None = None


class LocalMapper:
    def __init__(
        self,
        world: map_state.WorldMap,
        K,
        baseline,
        config: LocalMapperConfig | None = None,
        mesh=None,
    ):
        """`mesh`: an optional jax.sharding.Mesh. With >1 device the
        2-round local BA runs sharded over it (observation rows + the
        Schur reduction's landmark slabs; see vslam_tpu.parallel.sharded_ba)
        — the scaling dimension the reference's single GTSAM thread never
        had (SURVEY.md §5)."""
        self.world = world
        self.K = jnp.asarray(K, jnp.float32)
        self.baseline = jnp.float32(baseline)
        self.cfg = config or LocalMapperConfig()
        self.ba_count = 0
        # per-stage timers + counters (SURVEY.md §5 observability; read by
        # bench.py for the local-BA solves/s metric)
        self.metrics = metrics_mod.StageTimer()
        self.counters = metrics_mod.Counters()
        # pinned problem shapes: ONE compiled (obs_cap, L_cap) per instance.
        # The default obs_cap tracks the MEASURED live-row plateau — a
        # mature 12-KF window at 1024 features carries ~4.3k live
        # observation rows (bench EuRoC trace), and every BA iteration
        # pays O(obs_cap) linearization work on padding beyond that (the
        # old flat 16384 was ~4x the live rows).
        # 6x keys_per_kf leaves ~40% headroom over the plateau; overflow
        # beyond it is counted + logged, never silent.
        full_rows = WTOT * (world.keys_per_kf + world.right_obs_per_kf)
        self._obs_cap = self.cfg.obs_cap or min(6 * world.keys_per_kf, full_rows)
        self._lm_cap = self.cfg.lm_cap or LM_SLOTS
        self.mesh = mesh
        # one background fetch thread: np.asarray on a jax.Array releases
        # the GIL while awaiting the device chain + copy, so the result
        # blobs land in host numpy WHILE tracking continues, and
        # Future.done() gives the readiness-polling consume its signal
        self._fetch_pool = None
        self._sharded = None
        self._sharded_cache: dict[int, object] = {}
        if mesh is not None and mesh.devices.size > 1:
            from vslam_tpu.parallel import sharded_ba

            n = mesh.devices.size
            if self._lm_cap % n or self._obs_cap % n:
                raise ValueError(
                    f"mesh size {n} must divide landmark slots "
                    f"{self._lm_cap} and observation rows {self._obs_cap}"
                )
            self._sharded = sharded_ba.sharded_two_rounds(
                mesh, iters1=self.cfg.iters_round1, iters2=self.cfg.iters_round2
            )
            self._sharded_cache[1] = self._sharded

    def _get_sharded(self, n_slabs: int):
        """Sharded 2-round BA variant with the Schur reduction chunked
        over `n_slabs` landmark slabs per shard (map-scale global BA);
        variants are cached per slab count (log2-bounded set)."""
        if n_slabs not in self._sharded_cache:
            from vslam_tpu.parallel import sharded_ba

            self._sharded_cache[n_slabs] = sharded_ba.sharded_two_rounds(
                self.mesh, iters1=self.cfg.iters_round1,
                iters2=self.cfg.iters_round2, n_slabs=n_slabs,
            )
        return self._sharded_cache[n_slabs]

    # ------------------------------------------------------------------
    def find_new_points(self, kf_slot: int, mono: bool = False) -> np.ndarray:
        """Triangulate new multi-view landmarks for the newest KF's window
        (reference LocalMapper::findNewPoints, src/OptimizationBA.cpp:340-391;
        mono: addMappointsMono, src/FeatureTracker.cpp:1497-1684) and insert
        them into the map. Returns the new landmark slots."""
        pend = self._dispatch_triangulation(kf_slot, mono=mono)
        if pend is None:
            return np.zeros(0, np.int64)
        return self._finish_triangulation(pend)

    def _dispatch_triangulation(self, kf_slot: int, mono: bool = False):
        """Dispatch the triangulation + map scatters (device-side state is
        fully updated once these execute) WITHOUT blocking on any fetch.
        Returns a pending handle for :meth:`_finish_triangulation`, or None
        if there is no window to triangulate against."""
        w = self.world
        cfg = self.cfg
        covis = w.covisible_kfs(kf_slot, cfg.max_covisible, cfg.min_covis_weight)
        older = np.unique(covis[covis != kf_slot]).astype(np.int64)
        older = np.sort(older)[-(WINDOW - 1):]
        if len(older) == 0 and kf_slot > 0:
            # no covisibility yet (e.g. mono bootstrap KFs share no
            # landmarks) — use the most recent preceding KFs instead
            older = np.arange(max(0, kf_slot - (WINDOW - 1)), kf_slot, dtype=np.int64)
        if len(older) == 0:
            return None
        pad = WINDOW - 1 - len(older)
        slots = np.concatenate([np.zeros(pad, np.int64), older, [kf_slot]])
        valid = np.concatenate([np.zeros(pad, bool), np.ones(len(older) + 1, bool)])

        spawn = w.alloc_landmarks(SPAWN_TRI)
        pad_s = SPAWN_TRI - len(spawn)
        spawn_dev = jnp.asarray(
            np.concatenate([spawn, np.zeros(pad_s, np.int64)]), jnp.int32
        )
        avail = jnp.asarray(np.arange(SPAWN_TRI) < len(spawn))
        slots_dev = jnp.asarray(slots, jnp.int32)

        if mono:
            # radius 120 px (reference matchByRadius init radius,
            # src/FeatureTracker.cpp:1518); parallax floor 3 px of
            # ROTATION-COMPENSATED offset — the raw 10 px of the
            # reference's pixel gate (include/Conversions.h:140-144)
            # excluded nearly every true match under forward-dominant
            # motion once the rotation component is removed
            r = _triangulate_new_points_mono(
                w.arrays,
                slots_dev,
                jnp.asarray(valid),
                spawn_dev,
                avail,
                self.K,
                jnp.float32(120.0),
                jnp.float32(3.0),
                n_levels=cfg.n_levels,
                scale=cfg.scale,
            )
        else:
            r = _triangulate_new_points(
                w.arrays,
                slots_dev,
                jnp.asarray(valid),
                spawn_dev,
                avail,
                self.K,
                self.baseline,
                n_levels=cfg.n_levels,
                scale=cfg.scale,
            )
        r["host_blob"].copy_to_host_async()  # overlap the fetch with scatters
        with w.update_lock:
            w.arrays = map_state.scatter_landmarks(
                w.arrays,
                spawn_dev,
                r["spawn_pos"],
                r["spawn_desc"],
                r["spawn_maxdist"],
                r["spawn_mindist"],
                r["spawn_valid"],
            )
            w.arrays = _apply_triangulation(
                w.arrays, slots_dev, r["slot_of_cand"], r["key_views"]
            )
        return {
            "kf_slot": kf_slot,
            "blob": r["host_blob"],
            "spawn": spawn,
            "slots": slots,
            "valid": valid,
        }

    def _finish_triangulation(self, pend: dict) -> np.ndarray:
        """Consume the triangulation blob (ONE packed device->host fetch —
        each separate np.asarray is its own device->host sync) to update the
        host observation mirrors and the landmark allocator. Returns the new
        landmark slots."""
        w = self.world
        kf_slot, spawn = pend["kf_slot"], pend["spawn"]
        slots, valid = pend["slots"], pend["valid"]
        Kk = w.keys_per_kf
        blob = np.asarray(pend["blob"])
        soc = blob[:Kk].astype(np.int64)
        kv = blob[Kk : Kk + (WINDOW - 1) * Kk].reshape(WINDOW - 1, Kk).astype(np.int64)
        n_new = int(blob[-1])
        has = soc >= 0
        with w.update_lock:
            w.kf_obs_lm[kf_slot][has] = soc[has]
            for v in range(WINDOW - 1):
                if valid[v]:
                    okv = (kv[v] >= 0) & has
                    w.kf_obs_lm[slots[v]][kv[v][okv]] = soc[okv]
        # unused tail of the spawn budget goes back to the allocator
        w.release_landmarks(spawn[n_new:])
        return spawn[:n_new]

    # ------------------------------------------------------------------
    def _assemble(self, kf_slot, extra_ids=None):
        """Build a fixed-shape BAProblem for the covisibility window of
        `kf_slot`.

        The observation->landmark mapping is computed ON DEVICE from
        m.obs_lm (device searchsorted over the sorted candidate id list), so
        a just-dispatched triangulation is visible to the BA problem without
        the host ever fetching its results — `extra_ids` carries the
        speculatively-allocated spawn slots (unused ones have lm_valid False
        on device and drop out via pt_valid). Returns
        (problem, kf_slots, kf_valid, lm_slots_dev)."""
        w = self.world
        cfg = self.cfg
        covis = w.covisible_kfs(kf_slot, cfg.max_covisible, cfg.min_covis_weight)
        window = np.unique(np.concatenate([[kf_slot], covis])).astype(np.int64)
        window = np.sort(window)[-WINDOW:]  # temporal order; newest kept
        wn = len(window)

        # candidate landmarks: window observations (host mirror, may lag an
        # in-flight triangulation) + the speculative spawn slots
        obs_tbl = w.kf_obs_lm[window]  # (wn, K)
        base = obs_tbl[obs_tbl >= 0]

        # fixed anchor KFs: out-of-window observers of window landmarks,
        # included as gauge-fixed poses WITH their observations (reference
        # src/OptimizationBA.cpp:445-516) — they tie the window landmarks to
        # the rest of the map so the window cannot drift as a rigid block
        anchors = w.observers_of(np.unique(base), exclude=window, max_n=ANCHORS)
        anchors = np.sort(anchors)
        an = len(anchors)

        pad_w = WTOT - wn - an
        kf_slots = np.concatenate([window, anchors, np.zeros(pad_w, np.int64)])
        kf_valid = np.concatenate(
            [np.ones(wn + an, bool), np.zeros(pad_w, bool)]
        )
        # gauge: anchors are fixed AND the oldest window KF stays fixed (the
        # anchors' shared-observation counts can be weak — a handful of
        # low-parallax residuals is not a gauge; the oldest window KF is).
        # KF 0 additionally fixed whenever in the window (world origin).
        fixed = np.zeros(WTOT, bool)
        fixed[wn : wn + an] = True
        fixed[0] = True
        if 0 in window:
            fixed[np.where(window == 0)[0][0]] = True
        # odometry chain only along the temporally-sorted window prefix
        odo_mask = np.zeros(WTOT - 1, bool)
        odo_mask[: wn - 1] = True

        if extra_ids is not None and len(extra_ids):
            base = np.concatenate([base, np.asarray(extra_ids, np.int64)])
        ids = np.unique(base)
        # PINNED shapes (see LocalMapperConfig.obs_cap): the per-run caps
        # never move, so _assemble_device + the fused 2-round BA compile
        # exactly once per LocalMapper instance. Truncation is logged.
        L_cap = self._lm_cap
        obs_cap = self._obs_cap
        if len(ids) > L_cap:
            self.counters.inc("lm_slots_truncated", len(ids) - L_cap)
            print(
                f"[local_mapper] WARNING: window has {len(ids)} landmarks, "
                f"truncating to lm_cap={L_cap} (newest kept)"
            )
            ids = ids[-L_cap:]  # keep the newest landmarks (still sorted)
        n_ids = len(ids)
        sentinel = w.lm_capacity  # > any slot: keeps the padded list sorted
        lm_ids = np.concatenate(
            [ids, np.full(L_cap - n_ids, sentinel, np.int64)]
        )
        lm_pad_valid = np.arange(L_cap) < n_ids

        # everything device-side fused into ONE program (each separate jnp op
        # is its own dispatch with its own host overhead)
        p, lm_safe, take, n_live = _assemble_device(
            w.arrays,
            jnp.asarray(kf_slots, jnp.int32),
            jnp.asarray(kf_valid),
            jnp.asarray(lm_ids, jnp.int32),
            jnp.asarray(lm_pad_valid),
            jnp.asarray(fixed),
            jnp.asarray(odo_mask),
            self.K,
            self.baseline,
            lm_capacity=w.lm_capacity,
            n_levels=cfg.n_levels,
            scale=cfg.scale,
            obs_cap=obs_cap,
        )
        return p, kf_slots, kf_valid, lm_safe, take, n_live

    # ------------------------------------------------------------------
    def run(self, kf_slot: int, mono: bool = False) -> dict:
        """Full local BA for the window around `kf_slot`; writes results
        into the map. Returns re-anchoring info for the tracker.

        mono=True also runs local BA — an improvement over the reference,
        whose mono mode has no LocalMapper at all (src/System.cpp:11-20).

        Synchronous form of :meth:`run_async` + :meth:`finish` — the fetch
        blocks behind the full device queue plus the copy, so
        prefer the split form whenever a frame of other work can run in
        between (the reference runs its LocalMapper on a thread for the same
        reason, src/System.cpp:18-19)."""
        return self.finish(self.run_async(kf_slot, mono=mono))

    def run_async(self, kf_slot: int, mono: bool = False) -> dict:
        """Dispatch the COMPLETE local-mapping pipeline for `kf_slot` —
        triangulation, window assembly, fused 2-round BA, map write-back —
        as device programs without fetching anything. The device-resident
        map is fully updated once the queue drains; the returned pending
        handle carries the in-flight host copies for :meth:`finish`."""
        pending = self.run_async_staged(kf_slot, mono=mono)
        while "stage1" in pending or "stage2" in pending:
            pending = self.advance(pending)
        return pending

    def run_async_staged(self, kf_slot: int, mono: bool = False) -> dict:
        """Phase A of the async pipeline: dispatch triangulation + window
        assembly ONLY, deferring the 2-round BA + write-back to
        :meth:`advance`. Splitting lets the caller enqueue a frame's
        tracking program BETWEEN the two phases: the whole chain,
        enqueued as one block at a keyframe, would delay the next frames'
        result fetches by its full device time — the caller-visible p90
        tail. The
        BA consumes the problem tensors gathered HERE, so interleaved
        tracking steps do not change its result."""
        t0 = time.perf_counter()
        # triangulation is DISPATCHED but not fetched: _assemble sees its
        # device-side effects (obs mapping + spawn positions) directly, so
        # the assembly is enqueued back-to-back with the triangulation —
        # zero host round trips between them
        pend = self._dispatch_triangulation(kf_slot, mono=mono)
        extra = pend["spawn"] if pend is not None else None
        stage1 = self._assemble(kf_slot, extra_ids=extra)
        return {
            "stage1": stage1,
            "kf_slot": kf_slot,
            "mono": mono,
            "tri": pend,
            "t0": t0,
        }

    def advance(self, pending: dict) -> dict:
        """Advance a :meth:`run_async_staged` handle by ONE dispatch
        phase (call once per tracked frame):

        - stage1 -> dispatch BA round 1 + chi-squared sweep;
        - stage2 -> dispatch round 2 + write-back, start the prefetch.

        Splitting the rounds keeps every enqueued block smaller, so the
        tracking steps interleaved between phases stall less (the fused 2-round program was the largest single
        block in the queue — the dominant p90 term). The mesh-sharded
        path keeps the fused program (one shard_map dispatch).
        Idempotent on fully-advanced handles."""
        if "stage1" in pending:
            p, kf_slots, kf_valid, lm_slots_dev, take, n_live = pending.pop(
                "stage1"
            )
            if self._sharded is not None:
                out = self._dispatch_problem(
                    p, kf_slots, kf_valid, lm_slots_dev, take, n_live,
                    pending["kf_slot"], pending["mono"], pending["tri"],
                    pending["t0"],
                )
                return self.prefetch(out)
            p1 = schur.local_ba_round1(p, iters1=self.cfg.iters_round1)
            pending["stage2"] = (
                p, p1, kf_slots, kf_valid, lm_slots_dev, take, n_live
            )
            return pending
        if "stage2" in pending:
            p, p1, kf_slots, kf_valid, lm_slots_dev, take, n_live = (
                pending.pop("stage2")
            )
            p2, err, kill = schur.local_ba_round2(
                p1, iters2=self.cfg.iters_round2
            )
            out = self._writeback_dispatch(
                p, p2, err, kill, kf_slots, kf_valid, lm_slots_dev, take,
                n_live, pending["kf_slot"], pending["mono"],
                pending["tri"], pending["t0"],
            )
            if "early_lm_ids" in pending:  # triangulation consumed early
                out["early_lm_ids"] = pending["early_lm_ids"]
            return self.prefetch(out)
        return pending

    def _dispatch_problem(
        self, p, kf_slots, kf_valid, lm_slots_dev, take, n_live, kf_slot, mono,
        pend, t0, n_slabs: int = 1,
    ) -> dict:
        """Dispatch the fused 2-round BA + write-back for an assembled
        problem (any W — the local window or the whole map for
        :meth:`run_global`) and return the pending handle."""
        cfg = self.cfg
        # round 1 -> chi2 sweep -> round 2 -> final kill mask, ONE device
        # program (reference 543-873; fused to avoid per-stage dispatch
        # RTTs); sharded over the mesh when one is configured — INCLUDING
        # the slab-chunked global-BA path (mesh sharding composes with
        # slab chunking since round 4; the mesh pays off most exactly at
        # map scale). The LIVE async path splits the rounds across two
        # dispatch phases instead (see :meth:`advance`).
        if self._sharded is not None:
            from vslam_tpu.parallel import sharded_ba

            p2, err, kill = sharded_ba.run_problem(
                self._get_sharded(n_slabs), p
            )
            self.counters.inc("ba_sharded")
        else:
            p2, err, kill = schur.local_ba_two_rounds(
                p, iters1=cfg.iters_round1, iters2=cfg.iters_round2,
                n_slabs=n_slabs,
            )
        return self._writeback_dispatch(
            p, p2, err, kill, kf_slots, kf_valid, lm_slots_dev, take,
            n_live, kf_slot, mono, pend, t0,
        )

    def _writeback_dispatch(
        self, p, p2, err, kill, kf_slots, kf_valid, lm_slots_dev, take,
        n_live, kf_slot, mono, pend, t0,
    ) -> dict:
        """Pack the result blob, start its device->host copy, and dispatch
        the map write-back scatters for a solved BA problem."""
        w = self.world
        Wb = len(kf_slots)
        old_last_pose = w.kf_poses_host[kf_slot].copy()
        # take rides as a BITCAST int32 (not a float cast — f32 is exact
        # only to 2^24, and at >=8192 grown keyframes the flat row indices
        # exceed that, silently severing the wrong observations on decode)
        host_pack = jnp.concatenate(
            [
                p2.poses.reshape(-1),
                kill.astype(jnp.float32),
                jax.lax.bitcast_convert_type(take, jnp.float32),
                jnp.stack([err, n_live.astype(jnp.float32)]),
            ]
        )
        host_pack.copy_to_host_async()  # overlap with the writeback dispatch

        # ---- write back (snapshot scatter; reference 875-938) ----
        # kill coordinates decode from the compaction map: row take[i] of
        # the full [Wb*K | Wb*Kr] table, all on device
        K_keys = w.keys_per_kf
        Kr = w.right_obs_per_kf
        n_left_full = Wb * K_keys
        kf_slots_dev = jnp.asarray(kf_slots, jnp.int32)
        is_right_row = take >= n_left_full
        row_kf = kf_slots_dev[p.obs_kf]
        key_left = jnp.where(is_right_row, 0, take % K_keys).astype(jnp.int32)
        rem = jnp.maximum(take - n_left_full, 0)
        key_right = jnp.where(is_right_row, rem % Kr, 0).astype(jnp.int32)
        with w.update_lock:
            w.arrays = map_state.writeback_ba(
                w.arrays,
                kf_slots_dev,
                jnp.asarray(kf_valid),
                p2.poses,
                lm_slots_dev,
                p.pt_valid,
                p2.pts,
                row_kf,
                key_left,
                kill & ~is_right_row,
                row_kf,
                key_right,
                kill & is_right_row,
            )
        self.metrics.record("ba_dispatch", time.perf_counter() - t0)
        return {
            "kf_slot": kf_slot,
            "mono": mono,
            "tri": pend,
            "host_pack": host_pack,
            "kf_slots": kf_slots,
            "kf_valid": kf_valid,
            "old_pose": old_last_pose,
            "obs_cap": int(take.shape[0]),
        }

    # Hpl slab memory budget for the chunked global-BA Schur reduction:
    # one (Wg, L_cap/n_slabs, 6, 3) f32 block must fit comfortably next
    # to the (6Wg)^2 reduced system
    GLOBAL_SLAB_BYTES = 256 << 20
    # landmark-slab floor: chunking below this trades away matmul
    # efficiency for memory that is no longer scarce
    GLOBAL_MIN_SLAB = 1024

    def run_global(self, max_landmarks: int = 1 << 17) -> dict | None:
        """GLOBAL bundle adjustment: one 2-round Schur LM over EVERY valid
        keyframe and every landmark they observe.

        The reference's GTSAM window BA cannot grow past ~11 keyframes in
        its 20 ms budget (reference src/OptimizationBA.cpp:963-967); here
        the same fused kernel scales to the whole trajectory — the Schur
        reduction is a sum of per-landmark blocks, so on a device mesh the
        landmark slabs shard with one psum of the (6W)^2 reduced system
        per iteration (SURVEY.md §5 "long-context": window growth via
        keyframe/landmark-block sharding instead of windowing), and on ONE
        device the same slab math runs memory-chunked (n_slabs picked so
        an Hpl slab stays under GLOBAL_SLAB_BYTES — at KITTI-00 scale the
        dense (W, L, 6, 3) block would be multi-GB). Landmark truncation
        at `max_landmarks` is LOGGED and counted, never silent. Typical
        use: a final map refinement after a sequence (driver --global-ba),
        or periodic full-map polish. Returns re-anchoring info like
        :meth:`finish`, or None with fewer than 2 keyframes."""
        t0 = time.perf_counter()
        w = self.world
        n = w.n_keyframes
        if n < 2:
            return None
        window = np.arange(n, dtype=np.int64)
        Wg = _round_cap(n, 4, w.kf_capacity)
        kf_slots = np.concatenate([window, np.zeros(Wg - n, np.int64)])
        kf_valid = np.concatenate([np.ones(n, bool), np.zeros(Wg - n, bool)])
        # gauge: the world origin only — everything else floats
        fixed = np.zeros(Wg, bool)
        fixed[0] = True
        odo_mask = np.zeros(max(Wg - 1, 1), bool)
        odo_mask[: n - 1] = True

        tbl = w.kf_obs_lm[:n]
        tbl_r = w.kf_obs_r_lm[:n]
        ids = np.unique(np.concatenate([tbl[tbl >= 0], tbl_r[tbl_r >= 0]]))
        if len(ids) > max_landmarks:
            self.counters.inc("global_lm_truncated", len(ids) - max_landmarks)
            print(
                f"[local_mapper] WARNING: global BA truncating "
                f"{len(ids)} -> {max_landmarks} landmarks (oldest kept; "
                f"raise max_landmarks to cover the full map)"
            )
            ids = ids[:max_landmarks]
        n_ids = len(ids)
        if n_ids == 0:
            return None
        L_cap = _round_cap(n_ids, 1024, max(max_landmarks, 1024))
        sentinel = w.lm_capacity
        lm_ids = np.concatenate([ids, np.full(L_cap - n_ids, sentinel, np.int64)])
        lm_pad_valid = np.arange(L_cap) < n_ids

        n_obs = int((tbl >= 0).sum()) + int((tbl_r >= 0).sum())
        full_rows = Wg * (w.keys_per_kf + w.right_obs_per_kf)
        obs_cap = _round_cap(n_obs + 1024, 4096, full_rows)
        if self._sharded is not None:
            # the sharded kernel slices obs rows as O // mesh_size per shard
            # (schur._obs_slice) — a non-divisible obs_cap would silently
            # exclude the last O % n rows from linearization. Round UP to a
            # multiple of the mesh size (extra rows are dead padding).
            n_mesh = self.mesh.devices.size
            obs_cap = -(-obs_cap // n_mesh) * n_mesh
            if L_cap % n_mesh:
                L_cap = -(-L_cap // n_mesh) * n_mesh
                lm_ids = np.concatenate(
                    [ids, np.full(L_cap - n_ids, sentinel, np.int64)]
                )
                lm_pad_valid = np.arange(L_cap) < n_ids

        # memory guard: chunk the Schur reduction so one Hpl slab fits the
        # budget (n_slabs divides L_cap; both are powers of two)
        hpl_bytes = Wg * L_cap * 18 * 4
        n_slabs = 1
        while (
            hpl_bytes // n_slabs > self.GLOBAL_SLAB_BYTES
            and n_slabs < L_cap // self.GLOBAL_MIN_SLAB
        ):
            n_slabs *= 2
        if self._sharded is not None and n_slabs > 1:
            # the composed sharded+slabbed kernel psum_scatters each slab
            # into mesh-size sub-slabs: L_cap must divide by n_slabs * mesh
            n_mesh = self.mesh.devices.size
            q = n_slabs * n_mesh
            if L_cap % q:
                L_cap = -(-L_cap // q) * q
                lm_ids = np.concatenate(
                    [ids, np.full(L_cap - n_ids, sentinel, np.int64)]
                )
                lm_pad_valid = np.arange(L_cap) < n_ids
        if n_slabs > 1:
            print(
                f"[local_mapper] global BA: W={n} L={n_ids} -> Schur "
                f"reduction chunked over {n_slabs} landmark slabs "
                f"({hpl_bytes >> 20} MiB dense Hpl)"
                + (
                    f", sharded over {self.mesh.devices.size} devices"
                    if self._sharded is not None
                    else ""
                )
            )

        cfg = self.cfg
        p, lm_safe, take, n_live = _assemble_device(
            w.arrays,
            jnp.asarray(kf_slots, jnp.int32),
            jnp.asarray(kf_valid),
            jnp.asarray(lm_ids, jnp.int32),
            jnp.asarray(lm_pad_valid),
            jnp.asarray(fixed),
            jnp.asarray(odo_mask),
            self.K,
            self.baseline,
            lm_capacity=w.lm_capacity,
            n_levels=cfg.n_levels,
            scale=cfg.scale,
            obs_cap=obs_cap,
        )
        pending = self._dispatch_problem(
            p, kf_slots, kf_valid, lm_safe, take, n_live, int(n - 1), False,
            None, t0, n_slabs=n_slabs,
        )
        return self.finish(pending)

    def consume_triangulation(self, pending: dict) -> np.ndarray:
        """Consume ONLY the triangulation blob of a pending handle (its
        device->host copy started at phase-A dispatch, so by the time the
        caller polls it the bytes have landed): updates the host
        observation mirrors + allocator and returns the new landmark
        slots so the tracker can publish them to its active set WITHOUT
        waiting for the BA result — the staged 3-phase dispatch otherwise
        delays new-landmark publication ~2 extra frames, which starves
        tracking through low-texture stretches (measured: the 1000-frame
        adversarial ATE regressed 0.07 -> 0.12 before this early
        consume). Idempotent; finish() returns these ids."""
        if pending.get("tri") is None:
            return pending.get("early_lm_ids", np.zeros(0, np.int64))
        ids = self._finish_triangulation(pending["tri"])
        pending["tri"] = None
        pending["early_lm_ids"] = ids
        return ids

    def prefetch(self, pending: dict) -> dict:
        """Start a background-thread fetch of a pending handle's result
        blobs. After this, ``pending_ready(pending)`` reports true once
        the blobs are in host memory and :meth:`finish` consumes them
        without blocking. Idempotent."""
        if "fetch" in pending:
            return pending
        if self._fetch_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._fetch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ba-fetch"
            )
        blobs = [pending["host_pack"]]
        if pending["tri"] is not None:
            blobs.append(pending["tri"]["blob"])
        pending["fetch"] = self._fetch_pool.submit(
            lambda bs=blobs: [np.asarray(b) for b in bs]
        )
        return pending

    def finish(self, pending: dict) -> dict:
        """Consume a :meth:`run_async` handle: fetch the packed result blobs
        (they have been copying while other work ran) and update the host
        mirrors. Returns re-anchoring info for the tracker."""
        t0 = time.perf_counter()
        while "stage1" in pending or "stage2" in pending:
            pending = self.advance(pending)  # force-drain staged phases
        fut = pending.pop("fetch", None)
        if fut is not None:
            arrs = fut.result()  # usually already done (pending_ready)
            pending["host_pack"] = arrs[0]
            if pending["tri"] is not None:
                pending["tri"]["blob"] = arrs[1]
        w = self.world
        kf_slots, kf_valid = pending["kf_slots"], pending["kf_valid"]
        Wb = len(kf_slots)
        O_cap = pending["obs_cap"]
        K_keys = w.keys_per_kf
        Kr = w.right_obs_per_kf
        n_left_full = Wb * K_keys
        with w.update_lock:
            # consume the triangulation blob first (its copy started before
            # the BA was dispatched, so it lands first); this also updates
            # the host observation mirrors and the allocator
            new_lm_ids = (
                self._finish_triangulation(pending["tri"])
                if pending["tri"] is not None
                else pending.get("early_lm_ids", np.zeros(0, np.int64))
            )
            # host mirrors: ONE packed fetch [poses | kill | take | err, n_live]
            blob = np.asarray(pending["host_pack"])
            new_poses = blob[: Wb * 16].reshape(Wb, 4, 4)
            kill = blob[Wb * 16 : Wb * 16 + O_cap] > 0.5
            take = (
                blob[Wb * 16 + O_cap : Wb * 16 + 2 * O_cap]
                .view(np.int32)  # bitcast back (exact for any int32 index)
                .astype(np.int64)
            )
            err = float(blob[-2])
            n_live = int(blob[-1])
            if n_live > O_cap:
                self.counters.inc("obs_rows_truncated", n_live - O_cap)
                print(
                    f"[local_mapper] WARNING: {n_live} live observation rows "
                    f"> obs_cap={O_cap}; {n_live - O_cap} rows (last "
                    f"right-camera rows first) excluded from this BA"
                )
            for i, (slot, v) in enumerate(zip(kf_slots, kf_valid)):
                if v:
                    w.kf_poses_host[slot] = new_poses[i]
            # kill coordinates decode from the compaction map (take[i] is a
            # row of the full [Wb*K | Wb*Kr] table)
            kill_host = kill & (take < n_left_full)
            kill_r_host = kill & (take >= n_left_full)
            if kill_host.any():
                t = take[kill_host]
                w.kf_obs_lm[kf_slots[t // K_keys], t % K_keys] = -1
            if kill_r_host.any():
                t = take[kill_r_host] - n_left_full
                w.kf_obs_r_lm[kf_slots[t // Kr], t % Kr] = -1
            self.ba_count += 1
        self.metrics.record("ba_finish", time.perf_counter() - t0)
        self.counters.inc("ba_solves")

        return {
            "kf_slot": pending["kf_slot"],
            "old_pose": pending["old_pose"],
            "new_pose": w.kf_poses_host[pending["kf_slot"]].copy(),
            "error": float(err),
            "n_killed": int(kill_host.sum()),
            "window": kf_slots[kf_valid].tolist(),
            "new_lm_ids": new_lm_ids,
        }
