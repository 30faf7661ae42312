"""Per-frame tracking frontend (stereo and stereo-inertial).

Re-design of reference FeatureTracker::TrackImage
(src/FeatureTracker.cpp:1108-1278). The whole tracked frame is ONE fused
device program (`_track_step`): batched L+R extraction, stereo matching,
IMU or constant-velocity prediction, the adaptive-radius projection-match +
motion-only-LM retry loop, landmark aging — with ALL cross-frame state
(pose, velocity, bias, active landmark set, miss ages) device-resident in a
donated pytree. The host runs ONE frame behind (depth-1 pipeline): it
dispatches frame N asynchronously, then reads frame N-1's already-computed
64 KB result blob — so no host-device sync ever waits on pending compute,
and the host's per-frame bookkeeping overlaps the device's compute.

The keyframe policy therefore acts with one frame of latency (new landmarks
spawned by KF N become visible to matching at frame N+2 instead of N+1) —
behaviorally equivalent to the reference's asynchronous LocalMapper, which
also publishes new landmarks a frame late.

Contracts kept (SURVEY.md §2 row 9 constants):
- adaptive match radius 10 -> +30 (<= 3 retries), first frame 120,
  refine pass radius 4,
- chi2 outlier threshold 7.815 with per-octave information,
- KF policy: (nStereo < 80 OR every 5th frame) AND tracked inliers <
  0.9 x lastKFTracked (0.7 when > 350 keys), min inliers 50
  (src/FeatureTracker.cpp:1262),
- <= 100 new close-stereo landmarks per KF (maxAddedStereo spawn budget),
- constant-velocity next-pose prediction (updatePoses, 1699-1708),
- landmark outlier aging after 20 missed frames (setActiveOutliers,
  1016-1034),
- BA-result re-anchoring of the current pose (changePosesLCA, 884-908).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.geometry import se3
from vslam_tpu.models import map_state
from vslam_tpu.ops import extract, imu as imu_ops, lm, project_match, stereo_match
from vslam_tpu.utils import metrics as metrics_mod


@dataclasses.dataclass
class ImuConfig:
    """IMU noise model + extrinsics (reference IMU YAML block,
    config/config_MH_01.yaml:18-24, and T_bc1 at 112-115)."""

    gyro_noise: float  # rad/s/sqrt(Hz)
    accel_noise: float  # m/s^2/sqrt(Hz)
    gyro_walk: float
    accel_walk: float
    hz: float
    T_bc: np.ndarray  # (4,4) body-to-cam
    gravity_w: np.ndarray  # (3,) world-frame gravity (measured-gravity init,
    #                         reference src/VIOSlam.cpp:274)
    max_samples: int = 64  # static per-frame sample capacity


@dataclasses.dataclass
class TrackerParams:
    n_features: int = 2048
    n_levels: int = 8
    scale: float = 1.2
    fast_hi: float = 20.0
    fast_lo: float = 7.0
    edge_margin: int = 19
    active_size: int = 4096
    spawn_per_kf: int = 256
    max_spawn_close: int = 100  # reference maxAddedStereo budget per KF
    radius_schedule: tuple = (10.0, 40.0, 70.0, 100.0)
    first_frame_radius: float = 120.0
    refine_radius: float = 4.0
    desc_thr: float = 100.0
    ratio: float = 0.8
    # --- mono steady-state re-acquisition. The reference runs the mono
    # projection matcher with a hardcoded 1200 px radius and +50/+0.1
    # relaxed thresholds (src/FeatureTracker.cpp:1400,
    # src/FeatureMatcher.cpp:391-456, 442-447): without this, under
    # IMU-degraded prediction the stereo schedule's 120 px ceiling is
    # ~12x narrower than the reference's re-acquisition range.
    # None -> derived: the adaptive schedule escalates
    # to the reference's 1200 px ceiling; thresholds relaxed by the
    # reference's +50/+0.1 (ratio capped at 0.95 so the second-best
    # test keeps teeth on self-similar texture). ---
    mono_radius_schedule: tuple | None = None
    mono_first_frame_radius: float | None = None
    mono_desc_thr: float | None = None
    mono_ratio: float | None = None
    min_inliers: int = 50
    kf_min_stereo: int = 80
    kf_min_mono: int = 80  # mono KF trigger: few tracked mono landmarks
    #                        (reference 1470-1484 fires on a low mono MP
    #                        count; its own knob, not kf_min_stereo reused)
    kf_every: int = 5
    # absolute stereo-inlier floor that bypasses the tracked-ratio AND of
    # the KF policy; None -> 4/5 of kf_min_stereo (=64 at the default 80).
    # A/B with the clustered-corner ANMS: 40 -> EuRoC ATE 0.020 / KITTI
    # 0.335 (late endgame collapse), 64 -> 0.008 / 0.026, 80 -> KITTI
    # 0.033. A/B after the coverage-first ANMS (tools/ab_kf_policy.py):
    # EuRoC prefers a LOWER floor (56 -> ATE 0.0061 vs 64 -> 0.0067 /
    # 17 KFs) but KITTI's forward motion COLLAPSES below 64
    # (56 -> ATE 2.65 via a mid-run tracking failure + reseed; 64 ->
    # 0.0089) — the floor's job is exactly that scene's depth turnover,
    # so the default stays at the scene-robust 4/5 and per-rig configs
    # may lower it explicitly.
    kf_critical_stereo: int | None = None
    kf_tracked_ratio: float = 0.9
    kf_tracked_ratio_many: float = 0.7
    # hard ceiling on the keyframe GAP (frames): when tracking is healthy
    # the reference's ratio-gated policy can stall keyframes for 50+
    # frames, which starves everything keyframe-driven — loop-closure
    # detection runs per inserted KF, so a revisit can pass entirely
    # between keyframes; relocalization anchors + covisibility thin out
    # too. ORB-SLAM keeps the same temporal ceiling for the same reason.
    # MEASURED (tools/ab_kf_policy.py at crit=48): 30, 60 and off give
    # identical ATE (0.0075) on the bench scene because the
    # critical-stereo trigger fires first; the ceiling binds only on long
    # healthy stretches, exactly where its KF cadence keeps loop
    # detection alive. Kept at 30.
    kf_max_interval: int = 30
    many_keys: int = 350
    outlier_age: int = 20
    # consecutive lost (refused-solve) frames before the tracker re-seeds
    # the map: it inserts a keyframe at the dead-reckoned pose with the
    # spawn cap waived, so fresh stereo-depth landmarks re-anchor tracking
    # (SURVEY.md §5: the reference has NO recovery — sustained occlusion
    # dead-reckons forever)
    reseed_after: int = 3
    close_factor: float = 40.0
    # representative landmark descriptor policy: True = observation-set
    # per-bit majority (the reference's median, src/Map.cpp:145-210),
    # False = newest-view refresh. A/B'd in tests/test_tracking.py.
    desc_majority: bool = True
    # dispatch pipeline depth: 1 = host processes frame N-1 while the device
    # computes frame N (hides the host<->device handshake); 0 = synchronous
    # depth 2: the result blob of frame f is fetched while frames f+1, f+2
    # are in flight — the device->host copy (which can only START once
    # frame f's compute finishes) gets a full frame of compute to land
    # behind, so the blocking fetch does not gate every frame
    pipeline_depth: int = 2


@functools.partial(jax.jit, static_argnames=("params_static",))
def _frontend(left, right, fx, baseline, scale_factors, params_static):
    """Extraction on both images + stereo matching — one fused program.
    Accepts uint8 inputs (4x cheaper host->device upload) and casts on
    device."""
    nf, nl, sc, hi, lo, edge, close_factor = params_static
    LR = jnp.stack([left, right]).astype(jnp.float32)
    keys2 = extract.extract_batch(
        LR, n_levels=nl, scale=sc, total=nf, edge_margin=edge, fast_hi=hi, fast_lo=lo
    )
    kl = jax.tree.map(lambda a: a[0], keys2)
    kr = jax.tree.map(lambda a: a[1], keys2)
    st = stereo_match.match_stereo(
        LR[0],
        LR[1],
        kl.xy,
        kl.octave,
        kl.desc,
        kl.valid,
        kr.xy,
        kr.octave,
        kr.desc,
        kr.valid,
        fx,
        baseline,
        scale_factors,
        close_factor=close_factor,
    )
    return kl, st


@functools.partial(
    jax.jit,
    static_argnames=(
        "params_static",
        "width",
        "height",
        "n_levels",
        "min_inliers",
        "mono",
        "has_imu",
    ),
    # NOT donated: `outputs` leaves like midx/inliers/in_frame have the same
    # byte size as state members (miss_age, valid), so under donation XLA
    # aliases them into the donated buffers and the NEXT frame's dispatch
    # overwrites them before the depth-1 pipeline's deferred KF insertion
    # consumes them (silent map corruption).
)
def _track_step(
    LR,  # (2, H, W) stacked left/right, or (1, H, W) mono (uint8; cast on device)
    state,  # device-resident tracker state pytree
    imu_samples,  # (S, 7) [dt, gyro, accel] rows (dt==0 pads) — ignored if not has_imu
    imu_const,  # (gravity_w (3,), T_bc (4,4), ImuParams) — dummies if not has_imu
    radii,  # (R,) adaptive radius schedule (reference 1191-1233)
    refine_radius,
    desc_thr,
    ratio,
    K,
    baseline,
    scale_factors,
    params_static,
    width: int,
    height: int,
    n_levels: int,
    min_inliers: int,
    mono: bool = False,
    has_imu: bool = False,
):
    """ONE device program for a whole tracked frame: batched extraction,
    stereo matching, motion prediction, the adaptive-radius projection-match
    + motion-only-LM retry loop (reference src/FeatureTracker.cpp:1191-1233)
    as a lax.while_loop, the radius-4 refine pass (1236-1241), and landmark
    miss-aging (setActiveOutliers, 1016-1034). Returns (new_state, outputs)
    where outputs carry the per-frame device arrays a keyframe insertion
    needs, plus a single packed f32 blob for the one host fetch per frame.

    mono=True drops the right image + stereo matching (reference
    TrackImageMonoIMU, src/FeatureTracker.cpp:1280-1495)."""
    nf, nl, sc, hi, lo, edge, close_factor = params_static
    active = state["active"]
    # previous frame's solved pose at entry, re-projected onto SE(3):
    # without this a refused-solve (dead-reckon) streak composes the pose
    # with itself each frame and any accumulated rotation-scale drift
    # squares per frame — a doubling-exponent runaway (see
    # se3.orthonormalize)
    pose_prev = se3.orthonormalize(state["pose"])
    prev_prev = se3.orthonormalize(state["prev_pose"])

    imgs = LR.astype(jnp.float32)
    keysb = extract.extract_batch(
        imgs, n_levels=nl, scale=sc, total=nf, edge_margin=edge, fast_hi=hi, fast_lo=lo
    )
    kl = jax.tree.map(lambda a: a[0], keysb)
    if mono:
        N = kl.xy.shape[0]
        st = {
            "matched": jnp.zeros((N,), bool),
            "close": jnp.zeros((N,), bool),
            "depth": jnp.zeros((N,), jnp.float32),
            "est_right_x": jnp.full((N,), -1.0, jnp.float32),
        }
    else:
        kr = jax.tree.map(lambda a: a[1], keysb)
        st = stereo_match.match_stereo(
            imgs[0],
            imgs[1],
            kl.xy,
            kl.octave,
            kl.desc,
            kl.valid,
            kr.xy,
            kr.octave,
            kr.desc,
            kr.valid,
            K[0, 0],
            baseline,
            scale_factors,
            close_factor=close_factor,
        )
    keys = kl

    # constant-velocity prediction (reference updatePoses, 1699-1708)
    vel_T = pose_prev @ se3.inverse(prev_prev)
    T_pred = vel_T @ pose_prev

    # IMU prediction + preintegration (reference PredictNextPoseIMU,
    # src/FeatureTracker.cpp:1036-1106): overrides the constant-velocity
    # prediction whenever real samples are present.
    if has_imu:
        gravity_w, T_bc, imu_params = imu_const
        v_prev = state["vel"]
        bias_prev = state["bias"]
        T_cb = se3.inverse(T_bc)
        pre = imu_ops.preintegrate(imu_samples, bias_prev, imu_params)
        T_prev_wb = pose_prev @ T_cb
        T_pred_wb, v_pred = imu_ops.predict(
            T_prev_wb, v_prev, pre, bias_prev, bias_prev, gravity_w
        )
        T_pred = jnp.where(pre.dt > 0, T_pred_wb @ T_bc, T_pred)

    def attempt(T_base, v_base, b_base, radius, do_right=True):
        """Projection matching at `radius` + motion-only LM from T_base.
        Landmarks unmatched in the left image but projecting into the right
        are matched against the right keys at pred_r (reference predR path,
        src/FeatureMatcher.cpp:310, src/FeatureTracker.cpp:274-287) and
        contribute right-camera projection residuals. Right matching runs
        only in the refine pass (do_right) — the adaptive-radius retry loop
        needs only the left inlier count, and the reference too matches
        right once per frame after the pose is stable."""
        proj = project_match.predict_and_cull(
            T_base,
            active["pos"],
            active["valid"],
            K,
            baseline,
            width,
            height,
            active["maxdist"],
            active["mindist"],
            n_levels=n_levels,
        )
        midx, _ = project_match.match_by_projection(
            proj["pred_l"],
            proj["pred_oct"],
            active["desc"],
            active["valid"] & proj["in_l"],
            keys.xy,
            keys.octave,
            keys.desc,
            keys.valid,
            radius,
            scale_factors,
            desc_thr,
            ratio,
        )
        matched = midx >= 0
        A_ = midx.shape[0]
        if not mono and do_right:
            midx_r, _ = project_match.match_by_projection(
                proj["pred_r"],
                proj["pred_oct"],
                active["desc"],
                active["valid"] & proj["in_r"] & ~matched,
                kr.xy,
                kr.octave,
                kr.desc,
                kr.valid,
                radius,
                scale_factors,
                desc_thr,
                ratio,
            )
        else:
            midx_r = jnp.full((A_,), -1, jnp.int32)
        matched_r = midx_r >= 0
        safe = jnp.where(matched, midx, 0)
        obs_l = jnp.stack(
            [keys.xy[safe, 0], keys.xy[safe, 1], st["est_right_x"][safe]], axis=-1
        )
        if not mono and do_right:
            safe_r = jnp.where(matched_r, midx_r, 0)
            obs_r3 = jnp.stack(
                [kr.xy[safe_r, 0], kr.xy[safe_r, 1], jnp.full((A_,), -1.0)],
                axis=-1,
            )
            obs = jnp.where(matched_r[:, None], obs_r3, obs_l)
            oct_obs = jnp.where(matched_r, kr.octave[safe_r], keys.octave[safe])
            r_uv = kr.xy[safe_r]
            r_oct = kr.octave[safe_r]
        else:
            obs = obs_l
            oct_obs = keys.octave[safe]
            r_uv = jnp.zeros((A_, 2), jnp.float32)
            r_oct = jnp.zeros((A_,), jnp.int32)
        matched = matched | matched_r
        is_stereo = (midx >= 0) & st["matched"][safe]
        w = extract.inv_sigma2(oct_obs, n_levels, sc)
        if not has_imu:
            # MULTI-START: solve from the constant-velocity prediction AND
            # from the previous frame's (unextrapolated) pose, keep the
            # better solution. The reprojection cost on a drifting map can
            # hold a spurious local minimum near the extrapolated prediction
            # (prediction error is 2e_t - e_{t-1}, twice the tracking
            # error); the previous pose is only e_t away and stays in the
            # true basin, so the selection breaks the exponential
            # drift-confirmation feedback loop. Selection: most final
            # inliers, then lowest final cost.
            def solve_from(T0):
                return lm.motion_only_ba(
                    T0,
                    active["pos"],
                    obs,
                    w,
                    is_stereo,
                    matched_r,
                    matched,
                    K,
                    baseline,
                    max_iters=100,
                )

            # both starts solved as ONE batched LM (vmap over the initial
            # pose): the while_loop iterations of the two solves run in
            # lockstep lanes, so the serial depth is max(iters_a, iters_b)
            # instead of their sum
            Ts, chi2s, inls, sts, rs = jax.vmap(solve_from)(
                jnp.stack([T_base, pose_prev])
            )
            na, nb = jnp.sum(inls[0]), jnp.sum(inls[1])
            use_b = (nb > na) | ((nb == na) & (rs.error[1] < rs.error[0]))
            T_opt = jnp.where(use_b, Ts[1], Ts[0])
            chi2 = jnp.where(use_b, chi2s[1], chi2s[0])
            inl = jnp.where(use_b, inls[1], inls[0])
            st_out = jnp.where(use_b, sts[1], sts[0])
            v_opt, b_opt = v_base, b_base
        else:
            T_opt, v_opt, b_opt, chi2, inl, st_out, _ = lm.motion_only_ba_imu(
                T_base,
                v_base,
                bias_prev,
                T_prev_wb,
                v_prev,
                pre,
                gravity_w,
                imu_params,
                T_bc,
                active["pos"],
                obs,
                w,
                is_stereo,
                matched_r,
                matched,
                K,
                baseline,
                max_iters=100,
            )
        inliers = matched & inl
        return (
            T_opt,
            v_opt,
            b_opt,
            midx,
            inliers,
            jnp.sum(matched),
            jnp.sum(inliers),
            jnp.sum(st_out & inliers),
            active["valid"] & (proj["in_l"] | proj["in_r"]),
            proj["pred_l"],
            midx_r,
            st_out,
            r_uv,
            r_oct,
        )

    A = active["pos"].shape[0]
    if has_imu:
        v0, b0 = v_pred, bias_prev
    else:
        v0 = state["vel"]
        b0 = state["bias"]
    init = (
        jnp.int32(0),  # schedule index
        T_pred,
        v0,
        b0,
        jnp.full((A,), -1, jnp.int32),  # midx
        jnp.zeros((A,), bool),  # inliers
        jnp.int32(0),  # n_matched
        jnp.int32(0),  # n_inliers
        jnp.int32(0),  # n_stereo_inliers
    )

    def cond(c):
        return (c[0] < radii.shape[0]) & (c[7] < min_inliers)

    def body(c):
        i = c[0]
        T_opt, v_opt, b_opt, midx, inliers, n_m, n_i, n_st = attempt(
            T_pred, v0, b0, radii[i], do_right=False
        )[:8]
        return (i + 1, T_opt, v_opt, b_opt, midx, inliers, n_m, n_i, n_st)

    _, T_opt, v_opt, b_opt, _, _, _, _, _ = jax.lax.while_loop(cond, body, init)

    # refine pass at the small radius from the optimized pose
    (
        T_opt, v_opt, b_opt, midx, inliers, n_m, n_i, n_st, in_frame,
        lm_pred, midx_r, st_flags, r_uv, r_oct,
    ) = attempt(T_opt, v_opt, b_opt, refine_radius)

    # ---- tracking-failure gate (SURVEY.md §5: the reference has NO
    # failure recovery — lost tracking just corrupts its map). When the
    # retry loop has grown the match radius on a degraded frame
    # (occlusion + photometric noise), the LM solve can converge in a
    # WRONG basin with >= min_inliers self-consistent spurious matches;
    # the signature is a solution implausibly far from the motion
    # prediction, or a threadbare inlier set. Such a solve is REFUSED:
    # the frame dead-reckons on the prediction, its matches are voided
    # (so no wrong observations reach the keyframe table), and after
    # `reseed_after` consecutive lost frames the host inserts a RE-SEED
    # keyframe from fresh stereo depth at the dead-reckoned pose
    # (StereoTracker._process), restoring a trackable map.
    pred_step = jnp.linalg.norm(T_pred[:3, 3] - pose_prev[:3, 3])
    sol_jump = jnp.linalg.norm(T_opt[:3, 3] - T_pred[:3, 3])
    # the absolute floor scales with the SCENE (median active-landmark
    # match distance ~ median landmark depth), not a hardcoded meter
    # count: in mono mode the map scale is arbitrary, so a fixed 1.0
    # either mis-fires on valid solves or never fires
    scene = jnp.nanmedian(jnp.where(active["valid"], active["maxdist"], jnp.nan))
    scene = jnp.where(jnp.isfinite(scene), scene, 20.0)
    # the relative 10x-prediction term alone is unstable: one bad-but-
    # accepted solve inflates the next frame's prediction step, raising
    # its own floor 10x per frame — an exponential runaway that reached
    # 1e19 m on the circuit scene in ~20 frames. The scene-scale ceiling
    # (no camera moves half the median landmark depth in one frame)
    # breaks the feedback loop; the scene-scale floor keeps small true
    # motions from being refused.
    t_floor = jnp.clip(10.0 * pred_step, 0.05 * scene, 0.5 * scene)
    # rotation-jump term: a wrong-basin solve that is mostly rotational
    # has a tiny translation jump — compare geodesic angles too
    R_rel = T_pred[:3, :3].T @ T_opt[:3, :3]
    ang_jump = jnp.arccos(jnp.clip((jnp.trace(R_rel) - 1.0) * 0.5, -1.0, 1.0))
    R_step = pose_prev[:3, :3].T @ T_pred[:3, :3]
    pred_ang = jnp.arccos(jnp.clip((jnp.trace(R_step) - 1.0) * 0.5, -1.0, 1.0))
    lost = (
        (n_i < min_inliers // 2)
        | (sol_jump > t_floor)
        # rotation floor capped at 1 rad for the same runaway reason
        | (ang_jump > jnp.clip(10.0 * pred_ang, 0.35, 1.0))
        # non-finite backstop: a diverged LM yields NaN, and NaN > floor
        # is False — without this explicit check a NaN solve would pass
        # the jump gates and poison the state pose (observed on the
        # pre-hardening circuit scene: one NaN keyframe pose NaN'd the
        # entire pose graph)
        | ~jnp.all(jnp.isfinite(T_opt))
        | ~jnp.all(jnp.isfinite(v_opt))
    )
    T_opt = jnp.where(lost, T_pred, T_opt)
    v_opt = jnp.where(lost, v0, v_opt)
    b_opt = jnp.where(lost, b0, b_opt)
    inliers = inliers & ~lost
    midx = jnp.where(lost, -1, midx)
    midx_r = jnp.where(lost, -1, midx_r)
    n_m = jnp.where(lost, 0, n_m)
    n_i = jnp.where(lost, 0, n_i)
    n_st = jnp.where(lost, 0, n_st)

    # outlier aging: only landmarks that projected into this frame but were
    # not matched accrue age (reference setActiveOutliers, 1016-1034)
    miss_age = jnp.where(
        inliers, 0, state["miss_age"] + (in_frame & ~inliers).astype(jnp.int32)
    )

    new_state = {
        "pose": T_opt,
        "prev_pose": pose_prev,
        "vel": v_opt,
        "bias": b_opt,
        "active": active,
        "miss_age": miss_age,
    }

    stats = jnp.concatenate(
        [
            jnp.stack([n_m, n_i, n_st]).astype(jnp.float32),
            jnp.stack(
                [jnp.sum(keys.valid), jnp.sum(st["matched"])]
            ).astype(jnp.float32),
            # failure-gate diagnostics (SURVEY.md §5 observability): why a
            # frame was refused is host-visible without extra fetches
            jnp.stack([sol_jump, ang_jump, t_floor]),
            # the device's own refusal decision: the host counts THIS bit
            # toward lost_streak, so jump-type refusals (healthy inlier
            # count, implausible solution) trigger relocalization/reseed
            # the same way inlier starvation does
            lost.astype(jnp.float32)[None],
        ]
    )
    # the ONE device->host transfer per frame:
    # [pose 16 | vel 3 | bias 6 | stats 9 | miss_age A]
    blob = jnp.concatenate(
        [
            T_opt.reshape(-1),
            v_opt,
            b_opt,
            stats,
            miss_age.astype(jnp.float32),
        ]
    )
    outputs = {
        "keys": keys,
        "st": st,
        "lm_pred": lm_pred,
        "midx": midx,
        "inliers": inliers,
        "in_frame": in_frame,
        "midx_r": midx_r,
        "st_flags": st_flags,
        "r_uv": r_uv,
        "r_oct": r_oct,
        "blob": blob,
    }
    return new_state, outputs


@functools.partial(
    jax.jit,
    static_argnames=("spawn", "n_levels", "scale", "width", "height", "n_right"),
)
def _prepare_keyframe(
    T_kf,
    keys: extract.Keys,
    st_depth,
    st_right_x,
    st_matched,
    st_close,
    match_idx,  # (A,) per-active-landmark key index or -1
    inliers,  # (A,)
    active_ids,  # (A,) global landmark slots (layout match_idx refers to)
    spawn_slots,  # (spawn,) preallocated global slots
    spawn_avail,  # (spawn,) bool — slots actually granted by the allocator
    m: map_state.MapArrays,  # current world snapshot (for spawn suppression)
    sup_ids,  # (A,) CURRENT active landmark ids incl. the last KF's spawns
    lm_pred,  # (A, 2) the tracked frame's own predicted landmark pixels
    lm_in_frame,  # (A,) bool — in-frame mask for lm_pred
    match_r_idx,  # (A,) per-landmark RIGHT-image key index or -1
    r_uv,  # (A, 2) right-image pixel of the matched right key
    r_oct,  # (A,) its octave
    lm_stereo,  # (A,) final stereo flag after the solver's stereo->mono
    #              demotion (reference findOutliersR) — False for demoted
    K,
    spawn: int,
    max_close: int,
    n_levels: int,
    scale: float,
    width: int,
    height: int,
    n_right: int,
):
    """Build the KF observation table + spawn new close-stereo landmarks
    (reference insertKeyFrame, src/FeatureTracker.cpp:743-842)."""
    N = keys.xy.shape[0]
    # per-key landmark id from per-landmark match idx
    key_lm = jnp.full((N,), -1, jnp.int32)
    ok = (match_idx >= 0) & inliers
    tgt = jnp.where(ok, match_idx, N)  # out-of-range drops
    key_lm = jnp.zeros((N + 1,), jnp.int32).at[:].set(-1).at[tgt].set(
        jnp.where(ok, active_ids, -1)
    )[:N]
    # demotion-aware per-key stereo flags: a key whose matched landmark had
    # its right-x row demoted records a MONO observation here
    clear_st = jnp.zeros((N + 1,), bool).at[tgt].set(ok & ~lm_stereo)[:N]

    # right-camera-only observations, compacted to the Kr-slot table
    ok_r = (match_r_idx >= 0) & inliers
    order_r = jnp.argsort(~ok_r)
    take_r = order_r[:n_right]
    take_r_ok = ok_r[take_r]
    obs_r_lm = jnp.where(take_r_ok, active_ids[take_r], -1).astype(jnp.int32)
    obs_r_uv = jnp.where(take_r_ok[:, None], r_uv[take_r], 0.0)
    obs_r_oct = jnp.where(take_r_ok, r_oct[take_r], 0)

    # spawn candidates: close stereo keys not matched to a landmark AND not
    # within the suppression radius of any existing active landmark
    # projected into THIS keyframe — otherwise every ratio-test near-miss
    # (and, under the dispatch pipeline, every landmark spawned by the
    # previous keyframe that this frame never saw) re-spawns a duplicate of
    # an existing landmark, and the map degrades into ambiguous clones that
    # the ratio test then rejects wholesale (the reference is protected by
    # its unMatchedF bookkeeping, include/KeyFrame.h:29-30; this is the
    # masked-tensor equivalent). The suppression set is gathered from the
    # CURRENT world snapshot, so back-to-back keyframes see each other's
    # spawns even though the tracked frame itself did not.
    sup_safe = jnp.where(sup_ids >= 0, sup_ids, 0)
    sup_valid = (sup_ids >= 0) & m.lm_valid[sup_safe]
    sup_proj = project_match.predict_and_cull(
        T_kf,
        m.lm_pos[sup_safe],
        sup_valid,
        K,
        jnp.float32(0.0),
        width,
        height,
        m.lm_maxdist[sup_safe],
        m.lm_mindist[sup_safe],
        n_levels=n_levels,
    )
    world_pred = sup_proj["pred_l"]
    # only landmarks MATCHABLE in this keyframe suppress spawns: in-frame
    # AND inside their scale band (predict_and_cull's in_l). A landmark
    # that merely projects here but can no longer be matched (out of its
    # scale band under forward motion) must NOT block its replacement —
    # that starves the map.
    world_in = sup_proj["in_l"]
    sup_all = jnp.concatenate([lm_pred, world_pred], axis=0)
    sup_in = jnp.concatenate([lm_in_frame, world_in], axis=0)
    diff = keys.xy[:, None, :] - sup_all[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(sup_in[None, :], d2, jnp.inf)
    near_existing = jnp.min(d2, axis=1) < (8.0 * 8.0)
    # close stereo keys only, ascending depth (reference spawns close-only,
    # src/FeatureTracker.cpp:743-842 — far stereo depths are too uncertain
    # to anchor the map; multi-view triangulation covers them once the
    # window offers real baselines)
    cand = keys.valid & st_close & (key_lm < 0) & ~near_existing & (st_depth > 0)
    # INTENTIONAL DEVIATION from the reference: its insertKeyFrame sorts
    # spawn candidates by ASCENDING DEPTH and exempts close keys from the
    # maxAddedStereo cap (src/FeatureTracker.cpp:802-809, 830-833); here
    # candidates rank in SCAN ORDER (key index). Rationale: depth-first
    # ranking concentrates the whole spawn budget on the nearest
    # structure, and near occlusion boundaries the nearest "corners" are
    # view-dependent T-junctions whose stereo depth is fictitious; scan
    # order keeps the spawns spatially spread.
    order = jnp.argsort(jnp.where(cand, jnp.arange(cand.shape[0], dtype=jnp.float32), jnp.inf))
    take = order[:spawn]
    take_valid = cand[take] & spawn_avail
    # cap to the reference's per-KF budget (maxAddedStereo = 100,
    # include/FeatureTracker.h:46), applied in the same scan order: the
    # first max_close candidates win, the rest of the preallocated slot
    # block is released by the caller
    rank = jnp.cumsum(take_valid.astype(jnp.int32)) - 1
    take_valid = take_valid & (rank < max_close)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    kxy = keys.xy[take]
    kz = st_depth[take]
    x = (kxy[:, 0] - cx) / fx * kz
    y = (kxy[:, 1] - cy) / fy * kz
    pc = jnp.stack([x, y, kz], axis=-1)
    pw = se3.transform_points(T_kf, pc)
    dist = jnp.linalg.norm(pc, axis=-1)
    sf = scale ** keys.octave[take].astype(jnp.float32)
    maxdist = dist * sf
    mindist = maxdist / (scale ** (n_levels - 1))
    new_desc = keys.desc[take]

    # write spawned ids into the key->lm table so the KF observes them
    key_lm = key_lm.at[jnp.where(take_valid, take, N)].set(
        jnp.where(take_valid, spawn_slots, -1), mode="drop"
    )

    # refreshed descriptors for matched inlier landmarks (the reference
    # recomputes a robust median descriptor per observation set,
    # src/Map.cpp:145-210; refreshing to the newest view keeps matching
    # robust under viewpoint/scale drift)
    ok_desc = (match_idx >= 0) & inliers
    desc_src = keys.desc[jnp.where(ok_desc, match_idx, 0)]

    obs_uv = jnp.stack([keys.xy[:, 0], keys.xy[:, 1], st_right_x], axis=-1)
    return {
        "key_lm": key_lm,
        "refresh_ids": jnp.where(ok_desc, active_ids, -1),
        "refresh_desc": desc_src,
        "obs_uv": obs_uv,
        "obs_oct": keys.octave,
        "obs_stereo": st_matched & keys.valid & ~clear_st,
        "obs_r_lm": obs_r_lm,
        "obs_r_uv": obs_r_uv,
        "obs_r_oct": obs_r_oct,
        "spawn_pos": pw,
        "spawn_desc": new_desc,
        "spawn_maxdist": maxdist,
        "spawn_mindist": mindist,
        "spawn_valid": take_valid,
        "n_close": jnp.sum(st_close & keys.valid),
        # single packed host fetch: [key_lm (N) | obs_r_lm (Kr) |
        # n_spawned (1)] — separate np.asarray calls would each pay a
        # device->host sync, so everything the host needs travels in one
        # blob
        "host_blob": jnp.concatenate(
            [
                key_lm.astype(jnp.float32),
                obs_r_lm.astype(jnp.float32),
                jnp.sum(take_valid).astype(jnp.float32)[None],
            ]
        ),
    }


@functools.partial(
    jax.jit,
    static_argnames=(
        "spawn", "n_levels", "scale", "width", "height", "n_right",
        "desc_majority",
    ),
)
def _prepare_and_commit(
    kf_slot,
    T_kf,
    keys: extract.Keys,
    st_depth,
    st_right_x,
    st_matched,
    st_close,
    match_idx,
    inliers,
    active_ids,
    spawn_slots,
    spawn_avail,
    m: map_state.MapArrays,
    sup_ids,
    lm_pred,
    lm_in_frame,
    match_r_idx,
    r_uv,
    r_oct,
    st_flags,
    K,
    spawn: int,
    max_close,
    n_levels: int,
    scale: float,
    width: int,
    height: int,
    n_right: int,
    desc_majority: bool = True,
):
    """_prepare_keyframe + the three map scatters as ONE device program
    (one dispatch instead of four, each of which the KF frame would pay
    inline as tail latency). Returns (new MapArrays,
    host_blob)."""
    data = _prepare_keyframe(
        T_kf, keys, st_depth, st_right_x, st_matched, st_close, match_idx,
        inliers, active_ids, spawn_slots, spawn_avail, m, sup_ids, lm_pred,
        lm_in_frame, match_r_idx, r_uv, r_oct, st_flags, K,
        spawn=spawn, max_close=max_close, n_levels=n_levels, scale=scale,
        width=width, height=height, n_right=n_right,
    )
    m2 = map_state.scatter_landmarks(
        m, spawn_slots, data["spawn_pos"], data["spawn_desc"],
        data["spawn_maxdist"], data["spawn_mindist"], data["spawn_valid"],
    )
    m2 = map_state.refresh_descriptors(
        m2, data["refresh_ids"], data["refresh_desc"], majority=desc_majority
    )
    m2 = map_state.scatter_keyframe(
        m2, kf_slot, T_kf, data["obs_uv"], data["obs_oct"],
        data["obs_stereo"], data["key_lm"], keys.packed, keys.valid,
        data["obs_r_uv"], data["obs_r_oct"], data["obs_r_lm"],
    )
    return m2, data["host_blob"]


@functools.partial(jax.jit, static_argnames=("params_static",))
def _frontend_mono(img, params_static):
    """Extraction only (bootstrap frames of the mono pipeline)."""
    nf, nl, sc, hi, lo, edge, _ = params_static
    return extract.extract(
        img.astype(jnp.float32), n_levels=nl, scale=sc, total=nf,
        edge_margin=edge, fast_hi=hi, fast_lo=lo,
    )


@jax.jit
def _imu_predict(samples, T_prev_wc, v_prev, bias_prev, gravity_w, T_bc, imu_params):
    """Host-callable IMU dead-reckoning step (reference PredictNextPoseIMU,
    src/FeatureTracker.cpp:1036-1106). Returns (T_pred_wc, v_pred)."""
    T_cb = se3.inverse(T_bc)
    pre = imu_ops.preintegrate(samples, bias_prev, imu_params)
    T_prev_wb = T_prev_wc @ T_cb
    T_pred_wb, v_pred = imu_ops.predict(
        T_prev_wb, v_prev, pre, bias_prev, bias_prev, gravity_w
    )
    keep = pre.dt > 0
    return jnp.where(keep, T_pred_wb @ T_bc, T_prev_wc), jnp.where(keep, v_pred, v_prev)


@jax.jit
def _apply_delta(state, delta):
    """Premultiply the device-state poses by a BA re-anchoring delta
    (reference changePosesLCA, src/FeatureTracker.cpp:884-908)."""
    return {
        **state,
        "pose": delta @ state["pose"],
        "prev_pose": delta @ state["prev_pose"],
    }


def _map_ages(targets: np.ndarray, layout: np.ndarray, ages: np.ndarray) -> np.ndarray:
    """Look up each target landmark id's miss age in a (layout, ages) pair
    from a possibly older active-set layout; ids not present age 0."""
    out = np.zeros(len(targets), np.int64)
    src = layout >= 0
    lay = layout[src]
    ag = ages[src]
    if len(lay) == 0:
        return out
    order = np.argsort(lay)
    lay_s = lay[order]
    ag_s = ag[order]
    pos = np.searchsorted(lay_s, targets)
    pos_c = np.clip(pos, 0, len(lay_s) - 1)
    hit = (targets >= 0) & (lay_s[pos_c] == targets)
    out[hit] = ag_s[pos_c[hit]]
    return out


def sufficient_motion(T_a: np.ndarray, T_b: np.ndarray, min_baseline: float = 0.1, min_angle_deg: float = 5.0) -> bool:
    """Reference checkSufficientMovement (include/Conversions.h:112-137):
    enough baseline OR rotation between two poses to attempt mono init."""
    d = np.linalg.norm(T_a[:3, 3] - T_b[:3, 3])
    R = T_a[:3, :3].T @ T_b[:3, :3]
    angle = np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))
    return d > min_baseline or angle > min_angle_deg


class StereoTracker:
    """Host orchestration of the per-frame loop (reference TrackImage).

    Runs a depth-1 pipeline: `track()` dispatches the frame asynchronously
    and processes the PREVIOUS frame's results (pose bookkeeping, KF policy,
    KF insertion). `flush()` drains the pipeline; `trajectory()` flushes
    automatically. `self.pose` always reflects the newest PROCESSED frame.
    """

    def __init__(
        self,
        K: np.ndarray,
        baseline: float,
        width: int,
        height: int,
        world: map_state.WorldMap,
        params: TrackerParams | None = None,
        imu_cfg: ImuConfig | None = None,
    ):
        self.params = params or TrackerParams()
        self.imu_cfg = imu_cfg
        if imu_cfg is not None:
            self._imu_const = (
                jnp.asarray(imu_cfg.gravity_w, jnp.float32),
                jnp.asarray(imu_cfg.T_bc, jnp.float32),
                imu_ops.ImuParams(
                    gyro_noise=jnp.float32(imu_cfg.gyro_noise),
                    accel_noise=jnp.float32(imu_cfg.accel_noise),
                    gyro_walk=jnp.float32(imu_cfg.gyro_walk),
                    accel_walk=jnp.float32(imu_cfg.accel_walk),
                ),
            )
        else:
            # static dummies so the jit signature stays stable
            self._imu_const = (
                jnp.zeros(3, jnp.float32),
                jnp.eye(4, dtype=jnp.float32),
                imu_ops.ImuParams(
                    gyro_noise=jnp.float32(1e-4),
                    accel_noise=jnp.float32(1e-3),
                    gyro_walk=jnp.float32(1e-5),
                    accel_walk=jnp.float32(1e-3),
                ),
            )
        self.velocity = np.zeros(3, np.float32)  # world-frame body velocity
        self.bias = np.zeros(6, np.float32)  # [ba, bg]
        self.K = jnp.asarray(K, jnp.float32)
        self.baseline = jnp.float32(baseline)
        self.width = width
        self.height = height
        self.world = world
        # per-stage wall-clock + counters (the observability layer the
        # reference never had — SURVEY.md §5; consumed by bench.py and the
        # dataset driver)
        self.metrics = metrics_mod.StageTimer()
        self.counters = metrics_mod.Counters()
        p = self.params
        self.scale_factors = jnp.asarray(extract.scale_factors(p.n_levels, p.scale))
        self._static = (
            p.n_features,
            p.n_levels,
            p.scale,
            p.fast_hi,
            p.fast_lo,
            p.edge_margin,
            p.close_factor,
        )
        self._radii = jnp.asarray(list(p.radius_schedule), jnp.float32)
        self._radii_first = jnp.full(
            (len(p.radius_schedule),), p.first_frame_radius, jnp.float32
        )
        # per-instance matcher thresholds (MonoTracker overrides with the
        # reference's relaxed mono set)
        self._desc_thr = float(p.desc_thr)
        self._ratio = float(p.ratio)
        self._imu_dummy = jnp.zeros(
            ((imu_cfg.max_samples if imu_cfg else 1), 7), jnp.float32
        )

        self.frame_idx = 0
        self.pose = np.eye(4, dtype=np.float32)  # newest PROCESSED cam-to-world
        self.prev_pose = np.eye(4, dtype=np.float32)
        self.last_kf_tracked = 0
        self.last_kf_frame = 0
        self.last_kf_slot = -1
        self.lost_streak = 0  # consecutive refused-solve frames (recovery)
        self._last_n_used = 0  # spawn count of the last completed KF commit
        self.last_stats = {}
        # host active-set bookkeeping (layout for the NEXT dispatch)
        self.active_ids = np.full(p.active_size, -1, np.int64)
        self.miss_age = np.zeros(p.active_size, np.int64)
        # per-frame trajectory: (ref KF slot, relative pose) records
        self.frame_records: list[tuple[int, np.ndarray]] = []
        self.new_kf_slots: list[int] = []
        self._mono = False
        self._state = None  # device state pytree (set after frame 0)
        self._pending = collections.deque()  # unprocessed (frame, outputs, layout, D)
        # background fetch thread for keyframe result blobs: a blocking
        # np.asarray on a worker thread releases the GIL, so the copy
        # overlaps the main thread's dispatching without relying on
        # copy_to_host_async landing the bytes early — the same
        # mechanism LocalMapper.prefetch uses. Consumption points are
        # unchanged (fixed frames), so trajectories stay deterministic;
        # only the waiting overlaps.
        self._fetch_pool = None
        # deferred keyframe commit: the blob fetch of a just-prepared KF
        # (landmark ids, spawn count) rides behind the NEXT frame's device
        # compute instead of blocking inside the KF frame (which would
        # make KF frames the latency tail)
        self._kf_pending = None
        # cumulative BA re-anchoring delta: blobs of frames dispatched BEFORE
        # a reanchor carry the old anchor and are corrected at process time
        self._D = np.eye(4, dtype=np.float32)
        # optional per-frame diagnostic callback (frame_idx, pose, outputs,
        # stats) — e.g. utils.debug_view.make_tracker_hook writes tracked-
        # keypoint overlay PNGs (the reference's drawKeys window,
        # src/FeatureTracker.cpp:1686-1697, headless)
        self.debug_hook = None

    def set_gravity(self, gravity_w: np.ndarray):
        """Install the measured-gravity vector (reference computes it from
        the first accel sample at src/VIOSlam.cpp:274, after construction)."""
        if self.imu_cfg is None:
            return
        self.imu_cfg.gravity_w = np.asarray(gravity_w, np.float32)
        _, T_bc, prm = self._imu_const
        self._imu_const = (jnp.asarray(self.imu_cfg.gravity_w), T_bc, prm)

    # ------------------------------------------------------------------
    def _submit_fetch(self, arr):
        """Start a background-thread blocking fetch of a device array;
        returns a Future whose result() is the numpy copy (see the
        _fetch_pool comment)."""
        if self._fetch_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._fetch_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="trk-fetch"
            )
        return self._fetch_pool.submit(np.asarray, arr)

    def _gather_active_dev(self):
        ids = jnp.asarray(self.active_ids, jnp.int32)
        return map_state.gather_active(
            self.world.arrays, ids, self.params.active_size
        )

    def _fresh_state(self, pose: np.ndarray):
        # pose and prev_pose must be DISTINCT buffers: the state is donated
        # to _track_step, and XLA rejects donating one buffer twice
        return {
            "pose": jnp.asarray(np.asarray(pose), jnp.float32),
            "prev_pose": jnp.asarray(np.asarray(pose).copy(), jnp.float32),
            "vel": jnp.asarray(self.velocity),
            "bias": jnp.asarray(self.bias),
            "active": self._gather_active_dev(),
            "miss_age": jnp.asarray(self.miss_age, jnp.int32),
        }

    def _refresh_active(self, new_ids: np.ndarray, layout: np.ndarray, ages: np.ndarray):
        """Merge newly-observed landmark ids into the CURRENT active set,
        dropping aged-out landmarks (reference activeMapPoints maintenance +
        setActiveOutliers aging). `layout`/`ages` describe the frame whose
        blob produced the ages — they may LAG the current layout when an
        async BA inserted landmarks between that frame's dispatch and now;
        merging from `layout` instead of `self.active_ids` would silently
        drop those BA landmarks and starve the map."""
        cur = self.active_ids
        cur_age = _map_ages(cur, layout, ages)
        alive = (cur >= 0) & (cur_age <= self.params.outlier_age)
        keep = cur[alive]
        keep_age = cur_age[alive]
        merged = np.unique(np.concatenate([keep, new_ids[new_ids >= 0]]))
        # ages aligned to merged (new ids start at 0)
        m_age = np.zeros(len(merged), np.int64)
        if len(keep):
            order = np.argsort(keep)
            pos = np.searchsorted(merged, keep[order])
            inside = (pos < len(merged)) & (merged[np.clip(pos, 0, len(merged) - 1)] == keep[order])
            m_age[pos[inside]] = keep_age[order][inside]
        A = self.params.active_size
        if len(merged) > A:
            # evict by STALENESS, newest-id tiebreak: keep currently-
            # tracked landmarks (miss-age 0) over stale ones; a plain
            # newest-id policy evicted proven tracked landmarks for
            # fresh unproven spawns as soon as the map outgrew the
            # active size
            sel = np.sort(np.lexsort((-merged, m_age))[:A])
            merged = merged[sel]
            m_age = m_age[sel]
        out = np.full(A, -1, np.int64)
        out[: len(merged)] = merged
        new_age = np.zeros(A, np.int64)
        new_age[: len(merged)] = m_age
        self.active_ids = out
        self.miss_age = new_age
        # splice the refreshed active arrays + ages into the next dispatch
        if self._state is not None:
            self._state = {
                **self._state,
                "active": self._gather_active_dev(),
                "miss_age": jnp.asarray(self.miss_age, jnp.int32),
            }

    # ------------------------------------------------------------------
    def track(self, left: np.ndarray, right: np.ndarray | None = None, imu: np.ndarray | None = None):
        """Dispatch one rectified stereo pair (or mono frame); processes the
        previous frame's results and returns the newest PROCESSED pose."""
        with self.metrics.stage("track"):
            self.counters.inc("frames")
            return self._track_frame(left, right, imu)

    def _track_frame(self, left, right, imu):
        p = self.params
        if right is None and getattr(left, "ndim", 2) == 3:
            # pre-stacked (2, H, W) device array — an input pipeline that
            # staged the pair on device ahead of time (prefetcher overlap)
            # skips the per-frame host->device upload entirely
            LR = jnp.asarray(left)
        else:
            LR = jnp.asarray(
                np.stack([left, right]) if right is not None else left[None]
            )

        if self.frame_idx == 0:
            kl, st = _frontend(
                LR[0], LR[1], self.K[0, 0], self.baseline, self.scale_factors, self._static
            )
            self._initialize_map(kl, st)
            self._state = self._fresh_state(self.pose)
            self.frame_idx += 1
            return self.pose.copy()

        has_imu = imu is not None and self.imu_cfg is not None
        if has_imu:
            S = self.imu_cfg.max_samples
            samples = np.zeros((S, 7), np.float32)
            rows = np.asarray(imu, np.float32)[:S]
            samples[: len(rows)] = rows  # [dt, gyro, accel]; dt==0 pads are no-ops
            imu_dev = jnp.asarray(samples)
        else:
            imu_dev = self._imu_dummy

        radii = self._radii_first if self.frame_idx == 1 else self._radii
        self._state, outputs = _track_step(
            LR,
            self._state,
            imu_dev,
            self._imu_const,
            radii,
            jnp.float32(p.refine_radius),
            jnp.float32(self._desc_thr),
            jnp.float32(self._ratio),
            self.K,
            self.baseline,
            self.scale_factors,
            self._static,
            self.width,
            self.height,
            p.n_levels,
            p.min_inliers,
            mono=self._mono,
            has_imu=self.imu_cfg is not None,
        )
        # start the result blob's device->host copy immediately: by the
        # time _process pops this frame (pipeline_depth frames later) the
        # bytes have usually landed, so the blocking fetch is short.
        # Per-frame blobs use this plain async copy + direct fetch; the
        # thread fetch is reserved for the KEYFRAME commit blob
        # (_commit_keyframe), which is consumed one frame later.
        outputs["blob"].copy_to_host_async()
        self._pending.append(
            (self.frame_idx, outputs, self.active_ids.copy(), self._D.copy())
        )
        self.frame_idx += 1
        while len(self._pending) > self.params.pipeline_depth:
            self._process(*self._pending.popleft())
        return self.pose.copy()

    def flush(self):
        """Drain the pipeline (process all dispatched-but-unprocessed
        frames)."""
        while self._pending:
            self._process(*self._pending.popleft())
        self._finish_kf_commit()

    # ------------------------------------------------------------------
    def _process(self, frame_idx: int, outputs: dict, layout: np.ndarray, D_dispatch: np.ndarray):
        """Host-side completion of a tracked frame: ONE fetch of the packed
        blob, pose bookkeeping, KF policy, KF insertion. Any BA re-anchoring
        applied since this frame was dispatched is re-applied to its blob."""
        p = self.params
        # complete the previous frame's deferred KF commit first: its blob
        # copy has had a full frame of compute to land, so this is short
        # (and the mirrors are live before any KF/BA decision below)
        self._finish_kf_commit()
        blob = np.asarray(outputs["blob"])
        A = p.active_size
        corr = self._D @ np.linalg.inv(D_dispatch)
        pose = (corr @ blob[:16].reshape(4, 4)).astype(np.float32)
        self.prev_pose = self.pose
        self.pose = pose
        self.velocity = (corr[:3, :3] @ blob[16:19]).astype(np.float32)
        self.bias = blob[19:25].astype(np.float32)
        n_m, n_inl, n_stereo_inl, n_keys, n_stereo_keys = (
            int(x) for x in blob[25:30]
        )
        ages = blob[34 : 34 + A].astype(np.int64)
        self.last_stats = {
            "n_matched": n_m,
            "n_inliers": n_inl,
            "n_stereo_inliers": n_stereo_inl,
            "n_keys": n_keys,
            "n_stereo_keys": n_stereo_keys,
            "sol_jump": float(blob[30]),
            "ang_jump": float(blob[31]),
            "gate_floor": float(blob[32]),
            "lost": bool(blob[33] > 0.5),
        }
        if self.debug_hook is not None:
            self.debug_hook(frame_idx, pose, outputs, self.last_stats)

        # lost-tracking recovery (the reference has nothing here —
        # SURVEY.md §5: sustained occlusion dead-reckons forever). After
        # `reseed_after` consecutive refused solves:
        # 1. RELOCALIZE: retrieve the best-matching keyframe by a global
        #    descriptor sweep and re-anchor tracking on the OLD map
        #    (models/reloc.py) — preserves the original world frame;
        # 2. else RE-SEED (stereo only): a keyframe at the dead-reckoned
        #    pose whose close-stereo spawns are uncapped (like frame-0
        #    map init) starts a rigidly-offset fresh map.
        # the device's lost bit covers BOTH refusal modes — inlier
        # starvation AND translation/rotation-jump refusals with a healthy
        # inlier count (the latter dead-reckon with voided matches; a
        # sustained streak of them needs relocalization just as much)
        lost = self.last_stats["lost"]
        self.lost_streak = self.lost_streak + 1 if lost else 0
        reseed = False
        recovery_due = (
            self.lost_streak >= p.reseed_after
            # frames dispatched before the previous recovery's landmarks
            # went live cannot have matched them — don't stack a second
            # recovery (near-duplicate landmarks make the ratio test
            # reject everything) on their artifact-low counts; the extra
            # reseed_after spacing gives the fresh anchor time to prove
            # itself before it is declared failed again
            and frame_idx - self.last_kf_frame > p.pipeline_depth + p.reseed_after
        )
        if recovery_due:
            if self._relocalize(frame_idx, outputs):
                return  # re-anchored on the old map; no keyframe this frame
            reseed = not self._mono and n_stereo_keys >= p.kf_min_stereo
        if reseed or self._kf_decision(frame_idx, n_keys, n_inl, n_stereo_inl):
            # back-to-back keyframes: the previous deferred commit must
            # complete before a new one is stashed
            self._finish_kf_commit()
            # normal KF inserts DEFER the host-mirror fetch one frame
            # (reseeds block: recovery needs the fresh active set NOW, and
            # last_kf_tracked must become the actual spawn count)
            n_used = self._insert_keyframe(
                frame_idx, pose, outputs, layout, ages, reseed=reseed,
                defer=not reseed,
            )
            # a re-seed KF tracks nothing; its spawn count is the new
            # tracked baseline (exactly how frame-0 init seeds it)
            self.last_kf_tracked = n_used if reseed else n_inl
            self.last_kf_frame = frame_idx
            self.lost_streak = 0
        else:
            # non-KF record: pose relative to the last KF (reference addFrame)
            ref = self.world.kf_poses_host[self.last_kf_slot]
            rel = np.linalg.inv(ref) @ self.pose
            self.frame_records.append((self.last_kf_slot, rel.astype(np.float32)))
            # ages advance on device; keep the host mirror (remapped if the
            # layout moved since this frame was dispatched) for checkpoints
            if np.array_equal(layout, self.active_ids):
                self.miss_age = ages
            else:
                self.miss_age = _map_ages(self.active_ids, layout, ages)

    def _relocalize(self, frame_idx: int, outputs: dict) -> bool:
        """Global relocalization (models/reloc.py): retrieve the keyframe
        whose observation descriptors best match the current frame, reset
        the pose there with zero velocity, and reload the active set with
        that keyframe's (+ covisible neighbors') landmarks so the normal
        wide-radius matching re-acquires on the ORIGINAL map. Returns
        False when no keyframe clears the vote floor (the caller then
        falls back to the map re-seed)."""
        from vslam_tpu.models import reloc

        w = self.world
        if w.n_keyframes == 0:
            return False
        p = self.params
        best, votes, T_opt = reloc.retrieve(
            w, outputs["keys"], w.n_keyframes, K=self.K,
            baseline=float(self.baseline),
            min_inliers=max(p.min_inliers // 2, 20),
        )
        if best < 0:
            return False
        ids = w.kf_obs_lm[best]
        ids = ids[ids >= 0]
        covis = w.covisible_kfs(best)
        if len(covis):
            more = w.kf_obs_lm[covis]
            ids = np.unique(np.concatenate([ids, more[more >= 0]]))
        A = p.active_size
        out = np.full(A, -1, np.int64)
        out[: min(len(ids), A)] = ids[:A]
        self.active_ids = out
        self.miss_age = np.zeros(A, np.int64)
        # the geometrically-verified solve gives the actual camera pose
        # (the retrieved KF's pose is only its initialization)
        pose = np.asarray(T_opt, np.float32)
        self.pose = pose.copy()
        self.prev_pose = pose.copy()  # zero velocity restart
        self.velocity = np.zeros(3, np.float32)
        # rebuild the device state at the retrieved pose; frames already
        # in the dispatch pipeline were computed pre-relocalization and
        # will process as lost — the recovery grace period absorbs them
        self._state = self._fresh_state(self.pose)
        self.lost_streak = 0
        self.last_kf_frame = frame_idx
        self.last_kf_slot = best
        rel = np.linalg.inv(w.kf_poses_host[best]) @ pose
        self.frame_records.append((best, rel.astype(np.float32)))
        self.last_kf_tracked = max(votes, 1)
        self.counters.inc("relocalizations")
        return True

    def _kf_decision(self, frame_idx: int, n_keys: int, n_inl: int, n_stereo_inl: int) -> bool:
        """Keyframe policy — the reference's boolean structure
        (src/FeatureTracker.cpp:1262): a keyframe requires
        `(nStereo < minNStereo || every-5th frame) && tracked inliers <
        ratio * lastKFTracked` — PLUS one documented deviation: a
        CRITICAL low-stereo trigger (kf_critical_stereo, default 4/5 of
        minNStereo) that bypasses the tracked-ratio AND. Ablation (bench
        EuRoC-geometry scene): with
        the pure reference policy, stereo inliers starve to ~35 while
        total inliers decay too slowly (<2%/frame) for the ratio gate to
        fire; the depth geometry weakens, forward velocity drifts
        unobserved, and tracking collapses by frame ~50. The critical
        trigger replenishes close-depth landmarks exactly when the
        stereo constraint budget — not the match count — is the
        bottleneck.

        The stereo triggers are additionally suppressed for frames
        dispatched BEFORE the last keyframe's spawned landmarks entered the
        active set (i.e. within `pipeline_depth` frames of it): such a
        frame could not possibly have matched those landmarks, so its low
        count is an artifact of the dispatch pipeline, not of tracking
        quality — firing on it cascades into a keyframe every frame and
        degrades the map."""
        p = self.params
        ratio_thr = (
            p.kf_tracked_ratio_many if n_keys > p.many_keys else p.kf_tracked_ratio
        )
        crit = (
            p.kf_critical_stereo
            if p.kf_critical_stereo is not None
            else (4 * p.kf_min_stereo) // 5
        )
        saw_last_kf = frame_idx - self.last_kf_frame > p.pipeline_depth
        low_stereo = saw_last_kf and n_stereo_inl < p.kf_min_stereo
        critical_stereo = saw_last_kf and n_stereo_inl < crit
        periodic = frame_idx - self.last_kf_frame >= p.kf_every
        degraded = n_inl < ratio_thr * max(self.last_kf_tracked, 1)
        gap = frame_idx - self.last_kf_frame >= p.kf_max_interval
        return (
            ((low_stereo or periodic) and degraded) or critical_stereo or gap
        ) and n_inl >= p.min_inliers // 2

    # ------------------------------------------------------------------
    def _initialize_map(self, keys, st):
        """Frame 0: seed landmarks from stereo depth (reference
        initializeMap, src/FeatureTracker.cpp:72-123)."""
        p = self.params
        kf_slot = self.world.alloc_keyframe(0)
        spawn_dev, avail, spawn_host = self._alloc_spawn(p.n_features)

        w = self.world
        with w.update_lock:
            w.arrays, host_blob = _prepare_and_commit(
                jnp.asarray(kf_slot, jnp.int32),
                jnp.asarray(self.pose),
                keys,
                st["depth"],
                st["est_right_x"],
                st["matched"],
                st["matched"],  # at init every stereo match seeds a landmark
                jnp.full((p.active_size,), -1, jnp.int32),
                jnp.zeros((p.active_size,), bool),
                jnp.full((p.active_size,), -1, jnp.int32),
                spawn_dev,
                avail,
                w.arrays,
                jnp.full((p.active_size,), -1, jnp.int32),
                jnp.zeros((p.active_size, 2), jnp.float32),
                jnp.zeros((p.active_size,), bool),
                jnp.full((p.active_size,), -1, jnp.int32),  # no right matches
                jnp.zeros((p.active_size, 2), jnp.float32),
                jnp.zeros((p.active_size,), jnp.int32),
                jnp.zeros((p.active_size,), bool),
                self.K,
                spawn=p.n_features,
                # map init seeds a landmark from EVERY stereo match — the
                # reference's initializeMap has no maxAddedStereo cap
                # (src/FeatureTracker.cpp:72-123)
                max_close=p.n_features,
                n_levels=p.n_levels,
                scale=p.scale,
                width=self.width,
                height=self.height,
                n_right=w.right_obs_per_kf,
                desc_majority=p.desc_majority,
            )
        n_used = self._commit_keyframe(
            kf_slot, host_blob, spawn_host, self.active_ids, self.miss_age,
            T_kf_host=self.pose,
        )
        self.last_kf_tracked = n_used
        self.last_kf_frame = 0

    def _insert_keyframe(
        self, frame_idx: int, pose: np.ndarray, outputs: dict,
        layout: np.ndarray, ages: np.ndarray, reseed: bool = False,
        defer: bool = False,
    ) -> int:
        # `pose` is the blob-derived (re-anchoring-corrected) host pose; the
        # device outputs["T"] may alias the donated state buffer and must
        # not be consumed after the next frame was dispatched.
        # reseed=True waives the per-KF close-spawn cap (lost-tracking
        # recovery re-seeds like frame-0 map init). Returns spawn count.
        p = self.params
        keys, st = outputs["keys"], outputs["st"]
        kf_slot = self.world.alloc_keyframe(frame_idx)
        # a RE-SEED keyframe behaves like frame-0 map init
        # (src/FeatureTracker.cpp:72-123): it seeds a landmark from EVERY
        # stereo match (not just close ones — the close-only rule exists to
        # avoid duplicating landmarks the map should triangulate, but a
        # lost map has nothing to triangulate against), with no
        # near-existing suppression (the old landmarks are precisely the
        # ones that stopped matching) and no spawn cap. It reuses the
        # init-sized _prepare_keyframe program — no extra compile.
        A = p.active_size
        spawn_n = p.n_features if reseed else p.spawn_per_kf
        spawn_dev, avail, spawn_host = self._alloc_spawn(spawn_n)
        if reseed:
            st_close = st["matched"]
            sup_ids = jnp.full((A,), -1, jnp.int32)
            lm_pred = jnp.zeros((A, 2), jnp.float32)
            lm_in_frame = jnp.zeros((A,), bool)
        else:
            st_close = st["close"]
            sup_ids = jnp.asarray(self.active_ids, jnp.int32)
            lm_pred = outputs["lm_pred"]
            lm_in_frame = outputs["in_frame"]
        T_kf_dev = jnp.asarray(pose, jnp.float32)
        w = self.world
        with w.update_lock:
            w.arrays, host_blob = _prepare_and_commit(
                jnp.asarray(kf_slot, jnp.int32),
                T_kf_dev,
                keys,
                st["depth"],
                st["est_right_x"],
                st["matched"],
                st_close,
                outputs["midx"],
                outputs["inliers"],
                jnp.asarray(layout, jnp.int32),
                spawn_dev,
                avail,
                w.arrays,
                sup_ids,
                lm_pred,
                lm_in_frame,
                outputs["midx_r"],
                outputs["r_uv"],
                outputs["r_oct"],
                outputs["st_flags"],
                self.K,
                spawn=spawn_n,
                # max_close is a TRACED scalar (not a jit-static), so the
                # reseed override does not recompile the fused program
                max_close=(spawn_n if reseed else p.max_spawn_close),
                n_levels=p.n_levels,
                scale=p.scale,
                width=self.width,
                height=self.height,
                n_right=w.right_obs_per_kf,
                desc_majority=p.desc_majority,
            )
        return self._commit_keyframe(
            kf_slot, host_blob, spawn_host, layout, ages, T_kf_host=pose,
            defer=defer,
        )

    def _alloc_spawn(self, count: int):
        """Reserve `count` landmark slots; returns (slots_dev (count,),
        avail_dev (count,) bool, slots_host) padded for fixed shapes."""
        slots = self.world.alloc_landmarks(count)
        pad = count - len(slots)
        slots_dev = jnp.asarray(
            np.concatenate([slots, np.zeros(pad, np.int32)]), jnp.int32
        )
        avail = jnp.asarray(np.arange(count) < len(slots))
        return slots_dev, avail, slots

    def _commit_keyframe(
        self, kf_slot, host_blob, spawn_host=None,
        layout: np.ndarray | None = None, ages: np.ndarray | None = None,
        T_kf_host: np.ndarray | None = None, defer: bool = False,
    ) -> int:
        """Host side of a keyframe commit (the device side — preparation
        + all three map scatters — already ran as the ONE fused
        _prepare_and_commit program). defer=False: blocking — the
        host-mirror blob is fetched inline and the spawn/active
        bookkeeping completes before returning (frame-0 init, reseed, and
        mono bootstrap need the result immediately). defer=True: the
        blob's device->host copy is started and the completion is stashed
        for :meth:`_finish_kf_commit` one frame later — the copy lands
        behind the next frame's compute, so a KF frame stops paying the
        blocking round trip (the reference hides the same cost in its
        LocalMapper thread handoff, src/FeatureTracker.cpp:743-842)."""
        t0 = time.perf_counter()
        w = self.world
        # start a BACKGROUND-THREAD fetch of the packed blob NOW (a
        # worker-thread np.asarray overlaps the next frame's dispatch)
        blob_fut = self._submit_fetch(host_blob)
        with w.update_lock:
            w.kf_poses_host[kf_slot] = np.asarray(T_kf_host, np.float32)
        self.frame_records.append((kf_slot, np.eye(4, dtype=np.float32)))
        self.last_kf_slot = kf_slot
        if defer:
            self._kf_pending = {
                "kf_slot": kf_slot,
                "blob": blob_fut,
                "spawn_host": spawn_host,
                "layout": layout if layout is not None else self.active_ids,
                "ages": ages if ages is not None else self.miss_age,
                "t0": time.perf_counter() - t0,  # phase-A elapsed
            }
            return -1
        self._finish_kf_commit_blob(
            kf_slot, blob_fut, spawn_host,
            layout if layout is not None else self.active_ids,
            ages if ages is not None else self.miss_age,
        )
        self.metrics.record("kf_commit", time.perf_counter() - t0)
        return self._last_n_used

    def _finish_kf_commit(self):
        """Phase B of a deferred keyframe commit: consume the host-mirror
        blob (whose copy has been landing behind the next frame's
        compute), update the host observation tables, release the unused
        spawn tail, and publish the KF to new_kf_slots (the facade
        dispatches BA only once the mirrors it reads are live). Aging
        the completion a SECOND frame delays new-landmark publication
        enough to starve mono mapping and double the 1000-frame
        adversarial ATE — one frame is the accuracy-neutral depth. The
        completion is UNCONDITIONAL and blocking: a readiness-gated
        variant makes publication timing load-dependent
        (nondeterministic trajectories; the sync-path equivalence test
        catches it)."""
        pk = self._kf_pending
        if pk is None:
            return
        self._kf_pending = None
        tb = time.perf_counter()
        self._finish_kf_commit_blob(
            pk["kf_slot"], pk["blob"], pk["spawn_host"], pk["layout"], pk["ages"]
        )
        # records only the host-side completion cost (the A->B gap is a
        # frame of useful compute, not commit latency)
        self.metrics.record("kf_commit", (time.perf_counter() - tb) + pk["t0"])

    def _finish_kf_commit_blob(self, kf_slot, host_blob, spawn_host, layout, ages):
        w = self.world
        with w.update_lock:
            # host mirrors: ONE packed fetch [key_lm | obs_r_lm | n_spawned]
            # (host_blob is a background-fetch Future or a device array)
            blob = (
                host_blob.result()
                if hasattr(host_blob, "result")
                else np.asarray(host_blob)
            )
            N = w.keys_per_kf
            Kr = w.right_obs_per_kf
            key_lm_host = blob[:N].astype(np.int64)
            obs_r_lm_host = blob[N : N + Kr].astype(np.int64)
            n_used = int(blob[-1])
            w.kf_obs_lm[kf_slot] = key_lm_host
            w.kf_obs_r_lm[kf_slot] = obs_r_lm_host
        self.new_kf_slots.append(kf_slot)
        self._last_n_used = n_used
        # return the unused tail of the spawn budget to the allocator (the
        # valid spawns are a depth-sorted prefix, so the tail is contiguous)
        if spawn_host is not None:
            w.release_landmarks(spawn_host[n_used:])
        # refresh active set with everything this KF observes
        self._refresh_active(key_lm_host[key_lm_host >= 0], layout, ages)
        self.counters.inc("keyframes")

    def add_active(self, ids: np.ndarray):
        """Merge externally-created landmarks (e.g. local-mapper multi-view
        triangulations) into the tracked active set."""
        if len(ids):
            self._refresh_active(
                np.asarray(ids, np.int64), self.active_ids, self.miss_age
            )

    def refresh_after_ba(self):
        """Re-gather the active landmark arrays after a BA write-back
        changed landmark positions in the world map."""
        if self._state is not None:
            self._state = {**self._state, "active": self._gather_active_dev()}

    # ------------------------------------------------------------------
    def reanchor(self, kf_slot: int, old_pose: np.ndarray, new_pose: np.ndarray):
        """Re-anchor the current tracking pose after an async BA update
        (reference changePosesLCA, src/FeatureTracker.cpp:884-908)."""
        delta = (new_pose @ np.linalg.inv(old_pose)).astype(np.float32)
        if not np.isfinite(delta).all():
            return  # refuse a corrupt BA result rather than poison tracking
        self.pose = (delta @ self.pose).astype(np.float32)
        self.prev_pose = (delta @ self.prev_pose).astype(np.float32)
        self._D = delta @ self._D
        if self._state is not None:
            self._state = _apply_delta(self._state, jnp.asarray(delta, jnp.float32))
        self.refresh_after_ba()

    def trajectory(self) -> np.ndarray:
        """(F, 4, 4) per-frame poses recomposed as closeKF.pose * relative
        (reference saveTrajectoryAndPosition, src/System.cpp:99-107)."""
        self.flush()
        out = []
        for kf_slot, rel in self.frame_records:
            out.append(self.world.kf_poses_host[kf_slot] @ rel)
        return np.stack(out) if out else np.zeros((0, 4, 4), np.float32)


class MonoTracker(StereoTracker):
    """Monocular-inertial frontend (reference TrackImageMonoIMU,
    src/FeatureTracker.cpp:1280-1495).

    Bootstrap: the first keyframe anchors the world; subsequent frames
    dead-reckon on IMU until sufficient motion accumulates (reference
    motion gate at 1312 / include/Conversions.h:112-137), collecting 3
    motion-gated bootstrap keyframes (reference 1315-1330). EVERY frame
    of the bootstrap interval (up to the static triangulation window) is
    additionally recorded as an observation-table keyframe, so the
    one-time init triangulates across ALL accumulated views — the
    reference's addMappointsMono walks allFrames the same way
    (src/FeatureTracker.cpp:1497-1633) — not just the 3 gate keyframes.
    The caller (VSlamSystem or the test loop) then triangulates the
    initial map via LocalMapper.find_new_points(slot, mono=True) —
    metric scale comes from the IMU dead-reckoned keyframe baselines,
    exactly as the reference's bootstrap poses do. Steady state is the
    shared _track_step program with mono=True (projection-only
    observations + CombinedImuFactor)."""

    BOOTSTRAP_KFS = 3  # motion-gated keyframes, reference src/FeatureTracker.cpp:1315
    # every bootstrap frame becomes a triangulation view up to the local
    # mapper's static window (local_mapper.WINDOW) — the fixed-shape
    # analog of the reference's unbounded allFrames walk
    MAX_BOOTSTRAP_VIEWS = 12
    # floor on the view count before init completes: at fast ego-motion
    # the 3 motion gates can pass in 3 consecutive frames, and a 3-view
    # init triangulates too few landmarks to track (measured on the
    # circuit scene: 19 landmarks -> 0 inliers -> permanent dead-reckon;
    # 6+ views -> a dense init). The reference sidesteps this only
    # because its allFrames walk happens long after bootstrap
    # (src/FeatureTracker.cpp:1497-1633).
    MIN_BOOTSTRAP_VIEWS = 6

    def __init__(self, K, width, height, world, params=None, imu_cfg=None):
        super().__init__(
            K, baseline=0.0, width=width, height=height, world=world,
            params=params, imu_cfg=imu_cfg,
        )
        self._mono = True
        p = self.params
        # reference mono re-acquisition: 1200 px radius + relaxed
        # thresholds (src/FeatureTracker.cpp:1400,
        # src/FeatureMatcher.cpp:442-447). The adaptive schedule keeps
        # the cheap tight radii first — a good IMU prediction still
        # resolves at 10 px — and escalates to the reference's full
        # 1200 px only when matching starves.
        ms = p.mono_radius_schedule or (10.0, 120.0, 400.0, 1200.0)
        self._radii = jnp.asarray(list(ms), jnp.float32)
        ffr = (
            p.mono_first_frame_radius
            if p.mono_first_frame_radius is not None
            else ms[-1]
        )
        self._radii_first = jnp.full((len(ms),), ffr, jnp.float32)
        self._desc_thr = (
            float(p.mono_desc_thr)
            if p.mono_desc_thr is not None
            else float(p.desc_thr) + 50.0
        )
        self._ratio = (
            float(p.mono_ratio)
            if p.mono_ratio is not None
            else min(float(p.ratio) + 0.1, 0.95)
        )
        self.initialized = False
        self.bootstrap_slots: list[int] = []  # ALL bootstrap view slots
        self.gate_slots: list[int] = []  # the motion-gated subset
        self.needs_init_triangulation = False

    def track(self, left: np.ndarray, right: np.ndarray | None = None, imu: np.ndarray | None = None):
        if self.initialized:
            return super().track(left, None, imu)
        with self.metrics.stage("track"):
            self.counters.inc("frames")
            return self._bootstrap(left, imu)

    # ------------------------------------------------------------------
    def _bootstrap(self, left: np.ndarray, imu: np.ndarray | None):
        p = self.params
        # dead-reckon the pose on IMU (reference PredictNextPoseIMU)
        if imu is not None and self.imu_cfg is not None and self.frame_idx > 0:
            S = self.imu_cfg.max_samples
            samples = np.zeros((S, 7), np.float32)
            rows = np.asarray(imu, np.float32)[:S]
            samples[: len(rows)] = rows
            gravity, T_bc, imu_params = self._imu_const
            T_new, v_new = _imu_predict(
                jnp.asarray(samples),
                jnp.asarray(self.pose),
                jnp.asarray(self.velocity),
                jnp.asarray(self.bias),
                gravity,
                T_bc,
                imu_params,
            )
            self.prev_pose = self.pose
            self.pose = np.asarray(T_new)
            self.velocity = np.asarray(v_new)

        take_gate = self.frame_idx == 0 or (
            len(self.gate_slots) < self.BOOTSTRAP_KFS
            and sufficient_motion(
                self.pose, self.world.kf_poses_host[self.gate_slots[-1]]
            )
        )
        # non-gate bootstrap frames still become triangulation views
        # (capped) — more baselines = a denser, better-conditioned
        # initial mono map (reference allFrames walk, 1497-1633)
        take_view = take_gate or (
            len(self.bootstrap_slots) < self.MAX_BOOTSTRAP_VIEWS - 1
        )
        if take_view:
            keys = _frontend_mono(jnp.asarray(left), self._static)
            self._insert_mono_keyframe(keys, jnp.asarray(self.pose))
            self.bootstrap_slots.append(self.last_kf_slot)
            if take_gate:
                self.gate_slots.append(self.last_kf_slot)
            if (
                len(self.gate_slots) >= self.BOOTSTRAP_KFS
                and len(self.bootstrap_slots) >= self.MIN_BOOTSTRAP_VIEWS
            ):
                # caller triangulates the initial map from this window
                self.needs_init_triangulation = True
                self.initialized = True
                self.last_kf_frame = self.frame_idx
                self._state = self._fresh_state(self.pose)
                # preserve the IMU dead-reckoned motion so the next tracked
                # frame's constant-velocity prediction continues the arc
                self._state["prev_pose"] = jnp.asarray(self.prev_pose)
        else:
            ref = self.world.kf_poses_host[self.last_kf_slot]
            rel = np.linalg.inv(ref) @ self.pose
            self.frame_records.append((self.last_kf_slot, rel.astype(np.float32)))
        self.frame_idx += 1
        return self.pose.copy()

    def _insert_mono_keyframe(self, keys, T_kf):
        """KF with observations but no spawned landmarks (mono landmarks
        come only from multi-view triangulation, reference 1497-1684)."""
        p = self.params
        kf_slot = self.world.alloc_keyframe(self.frame_idx)
        N = p.n_features
        zeros_f = jnp.zeros((N,), jnp.float32)
        spawn_dev, avail, spawn_host = self._alloc_spawn(1)
        w = self.world
        with w.update_lock:
            w.arrays, host_blob = _prepare_and_commit(
                jnp.asarray(kf_slot, jnp.int32),
                T_kf,
                keys,
                zeros_f,  # st_depth
                jnp.full((N,), -1.0, jnp.float32),  # st_right_x
                jnp.zeros((N,), bool),  # st_matched
                jnp.zeros((N,), bool),  # st_close -> no spawns
                jnp.full((p.active_size,), -1, jnp.int32),
                jnp.zeros((p.active_size,), bool),
                jnp.full((p.active_size,), -1, jnp.int32),
                spawn_dev,
                avail,
                w.arrays,
                jnp.full((p.active_size,), -1, jnp.int32),
                jnp.zeros((p.active_size, 2), jnp.float32),
                jnp.zeros((p.active_size,), bool),
                jnp.full((p.active_size,), -1, jnp.int32),
                jnp.zeros((p.active_size, 2), jnp.float32),
                jnp.zeros((p.active_size,), jnp.int32),
                jnp.zeros((p.active_size,), bool),
                self.K,
                spawn=1,
                max_close=1,
                n_levels=p.n_levels,
                scale=p.scale,
                width=self.width,
                height=self.height,
                n_right=w.right_obs_per_kf,
                desc_majority=p.desc_majority,
            )
        self._commit_keyframe(
            kf_slot, host_blob, spawn_host, self.active_ids, self.miss_age,
            T_kf_host=self.pose,
        )

    def _kf_decision(self, frame_idx: int, n_keys: int, n_inl: int, n_stereo_inl: int) -> bool:
        """Mono KF policy (reference 1470-1484): every-Nth frame with a low
        tracked ratio, or the tracked mono count degrading. Like the stereo
        policy, the low-count trigger only fires for frames dispatched after
        the last keyframe's landmarks were live (see StereoTracker)."""
        p = self.params
        ratio_thr = (
            p.kf_tracked_ratio_many if n_keys > p.many_keys else p.kf_tracked_ratio
        )
        saw_last_kf = frame_idx - self.last_kf_frame > p.pipeline_depth
        return (
            (saw_last_kf and n_inl < p.kf_min_mono)
            or (
                frame_idx - self.last_kf_frame >= p.kf_every
                and n_inl < ratio_thr * max(self.last_kf_tracked, 1)
            )
            or frame_idx - self.last_kf_frame >= p.kf_max_interval
        ) and n_inl >= p.min_inliers // 2
