import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vslam_tpu.geometry import se3
from vslam_tpu.ops import schur

K = np.array([[460.0, 0, 320.0], [0, 460.0, 240.0], [0, 0, 1.0]], np.float32)
BASELINE = 0.12


def _build_problem(W=6, L=96, noise_pose=0.02, noise_pt=0.05, seed=0, O=None):
    rng = np.random.default_rng(seed)
    # ground-truth poses along a forward path
    poses_gt = []
    for i in range(W):
        xi = np.array(
            [0.01 * i, 0.02 * i, 0.005 * i, 0.1 * i, 0.01 * i, 0.6 * i], np.float32
        )
        poses_gt.append(np.asarray(se3.se3_expmap(jnp.asarray(xi))))
    poses_gt = np.stack(poses_gt)
    pts_gt = np.stack(
        [rng.uniform(-6, 6, L), rng.uniform(-4, 4, L), rng.uniform(6, 30, L)], -1
    ).astype(np.float32)

    # exact observations: every landmark seen by every pose (dense O = W*L)
    obs_kf, obs_lm, obs_uv, obs_st = [], [], [], []
    for w in range(W):
        T_cw = np.linalg.inv(poses_gt[w])
        pc = (T_cw[:3, :3] @ pts_gt.T).T + T_cw[:3, 3]
        u = K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2]
        v = K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]
        ur = K[0, 0] * (pc[:, 0] - BASELINE) / pc[:, 2] + K[0, 2]
        for l in range(L):
            obs_kf.append(w)
            obs_lm.append(l)
            obs_uv.append([u[l], v[l], ur[l]])
            obs_st.append(l % 2 == 0)
    obs_kf = np.asarray(obs_kf, np.int32)
    obs_lm = np.asarray(obs_lm, np.int32)
    obs_uv = np.asarray(obs_uv, np.float32)
    obs_st = np.asarray(obs_st)

    # perturb non-fixed poses and all landmarks
    fixed = np.zeros(W, bool)
    fixed[0] = True
    poses_init = poses_gt.copy()
    for w in range(W):
        if not fixed[w]:
            xi = rng.normal(0, noise_pose, 6).astype(np.float32)
            poses_init[w] = poses_gt[w] @ np.asarray(se3.se3_expmap(jnp.asarray(xi)))
    pts_init = pts_gt + rng.normal(0, noise_pt, pts_gt.shape).astype(np.float32)

    odo_rel = np.stack(
        [np.linalg.inv(poses_gt[i]) @ poses_gt[i + 1] for i in range(W - 1)]
    ).astype(np.float32)

    p = schur.BAProblem(
        poses=jnp.asarray(poses_init),
        fixed=jnp.asarray(fixed),
        pose_valid=jnp.ones(W, dtype=bool),
        pts=jnp.asarray(pts_init),
        pt_valid=jnp.ones(L, dtype=bool),
        obs_kf=jnp.asarray(obs_kf),
        obs_lm=jnp.asarray(obs_lm),
        obs_uv=jnp.asarray(obs_uv),
        obs_stereo=jnp.asarray(obs_st),
        obs_right=jnp.zeros(len(obs_kf), dtype=bool),
        obs_w=jnp.ones(len(obs_kf), jnp.float32),
        obs_valid=jnp.ones(len(obs_kf), dtype=bool),
        K=jnp.asarray(K),
        baseline=jnp.float32(BASELINE),
        odo_rel=jnp.asarray(odo_rel),
        odo_valid=jnp.ones(W - 1, dtype=bool),
    )
    return p, poses_gt, pts_gt


def test_local_ba_converges_to_ground_truth():
    p, poses_gt, pts_gt = _build_problem()
    p1, err1, _ = schur.local_ba(p, iters=5)
    p2, err2, _ = schur.local_ba(p1, iters=10)
    assert float(err2) < float(schur.ba_error(p)) * 1e-3
    poses = np.asarray(p2.poses)
    for w in range(len(poses)):
        xi = np.asarray(se3.se3_logmap(jnp.asarray(np.linalg.inv(poses_gt[w]) @ poses[w])))
        assert np.abs(xi).max() < 2e-3, (w, xi)
    # landmarks recovered
    err_pts = np.linalg.norm(np.asarray(p2.pts) - pts_gt, axis=1)
    assert np.median(err_pts) < 0.02


def test_local_ba_respects_gauge():
    p, poses_gt, _ = _build_problem()
    p2, _, _ = schur.local_ba(p, iters=8)
    # fixed pose 0 must be bitwise untouched
    np.testing.assert_array_equal(np.asarray(p2.poses)[0], np.asarray(p.poses)[0])


def test_obs_chi2_flags_corrupt_observations():
    p, poses_gt, pts_gt = _build_problem(noise_pose=0.0, noise_pt=0.0)
    uv = np.array(p.obs_uv)
    bad = np.arange(7, 400, 61)
    uv[bad, :2] += 20.0
    p = p._replace(obs_uv=jnp.asarray(uv))
    chi2 = np.asarray(schur.obs_chi2(p))
    assert (chi2[bad] > schur.CHI2_THR).all()
    good = np.setdiff1d(np.arange(len(uv)), bad)
    assert (chi2[good] < schur.CHI2_THR).mean() > 0.99


def test_local_ba_with_outliers_two_rounds():
    p, poses_gt, pts_gt = _build_problem(seed=3)
    uv = np.array(p.obs_uv)
    rng = np.random.default_rng(1)
    bad = rng.choice(len(uv), 30, replace=False)
    uv[bad, :2] += rng.uniform(15, 40, (30, 2))
    p = p._replace(obs_uv=jnp.asarray(uv))
    # round 1 (5 iters) -> chi2 sweep -> round 2 (10 iters), as the reference
    p1, _, _ = schur.local_ba(p, iters=5)
    chi2 = np.asarray(schur.obs_chi2(p1))
    keep = jnp.asarray(chi2 < schur.CHI2_THR) & p1.obs_valid
    p1 = p1._replace(obs_valid=keep)
    p2, err, _ = schur.local_ba(p1, iters=10)
    poses = np.asarray(p2.poses)
    for w in range(len(poses)):
        xi = np.asarray(se3.se3_logmap(jnp.asarray(np.linalg.inv(poses_gt[w]) @ poses[w])))
        assert np.abs(xi).max() < 5e-3, (w, xi)
    # most of the injected outliers were swept
    assert (~np.asarray(keep)[bad]).mean() > 0.8


def test_slabbed_schur_matches_unslabbed():
    """The memory-chunked Schur reduction (n_slabs > 1, the single-device
    global-BA path) is the same slab math as the mesh-sharded kernel and
    must reproduce the dense solve up to float reduction order."""
    p, poses_gt, _ = _build_problem(W=6, L=96, seed=2)
    p_a, err_a, _ = schur.local_ba(p, iters=6)
    p_b, err_b, _ = schur.local_ba(p, iters=6, n_slabs=4)
    np.testing.assert_allclose(
        np.asarray(p_b.poses), np.asarray(p_a.poses), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(p_b.pts), np.asarray(p_a.pts), atol=5e-3
    )
    assert abs(float(err_a) - float(err_b)) <= 1e-3 * max(float(err_a), 1.0)


def _build_world_at_scale(n_kf, n_lm, keys_per_kf, obs_per_lm=3, seed=0):
    """A map-scale WorldMap built directly (tracking 4.5k frames to get
    there would dominate the test): KF poses along a forward corridor,
    landmarks distributed along it, each observed by obs_per_lm
    consecutive KFs with exact projections, then perturbed."""
    import dataclasses

    from vslam_tpu.models import map_state

    rng = np.random.default_rng(seed)
    lm_cap = 1
    while lm_cap < n_lm + 2:
        lm_cap *= 2
    world = map_state.WorldMap(
        lm_capacity=lm_cap, kf_capacity=n_kf, keys_per_kf=keys_per_kf,
        right_obs_per_kf=8,
    )
    poses = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    for i in range(n_kf):
        yaw = 0.002 * i
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        poses[i, :3, 3] = [0.3 * np.sin(0.05 * i), 0.0, 0.5 * i]
    pts = np.stack(
        [
            rng.uniform(-6, 6, n_lm),
            rng.uniform(-4, 4, n_lm),
            rng.uniform(0, 0.5 * n_kf + 20.0, n_lm) + 6.0,
        ],
        axis=-1,
    ).astype(np.float32)

    obs_uv = np.zeros((n_kf, keys_per_kf, 3), np.float32)
    obs_lm = np.full((n_kf, keys_per_kf), -1, np.int64)
    obs_oct = np.zeros((n_kf, keys_per_kf), np.int64)
    obs_st = np.zeros((n_kf, keys_per_kf), bool)
    obs_valid = np.zeros((n_kf, keys_per_kf), bool)
    fill = np.zeros(n_kf, np.int64)
    # landmark i is observed by obs_per_lm consecutive KFs around the KF
    # whose z matches its depth minus a viewing distance
    anchor = np.clip(((pts[:, 2] - 12.0) / 0.5).astype(np.int64), 0, n_kf - obs_per_lm)
    for i in range(n_lm):
        for d in range(obs_per_lm):
            k = int(anchor[i]) + d
            j = fill[k]
            if j >= keys_per_kf:
                continue
            T_cw = np.linalg.inv(poses[k])
            pc = T_cw[:3, :3] @ pts[i] + T_cw[:3, 3]
            if pc[2] < 0.5:
                continue
            u = 460.0 * pc[0] / pc[2] + 320.0
            v = 460.0 * pc[1] / pc[2] + 240.0
            ur = 460.0 * (pc[0] - BASELINE) / pc[2] + 320.0
            obs_uv[k, j] = [u, v, ur]
            obs_lm[k, j] = i
            obs_st[k, j] = True
            obs_valid[k, j] = True
            fill[k] += 1
    world.arrays = dataclasses.replace(
        world.arrays,
        kf_pose=jnp.asarray(poses),
        kf_valid=jnp.asarray(np.ones(n_kf, bool)),
        lm_pos=jnp.asarray(
            np.concatenate([pts, np.zeros((lm_cap - n_lm, 3), np.float32)])
        ),
        lm_valid=jnp.asarray(np.arange(lm_cap) < n_lm),
        obs_uv=jnp.asarray(obs_uv),
        obs_lm=jnp.asarray(obs_lm.astype(np.int32)),
        obs_oct=jnp.asarray(obs_oct.astype(np.int32)),
        obs_stereo=jnp.asarray(obs_st),
        obs_valid=jnp.asarray(obs_valid),
    )
    world.kf_obs_lm[:] = obs_lm
    world.kf_poses_host[:] = poses
    world.n_keyframes = n_kf
    world.n_landmarks = n_lm
    world.kf_frame_idx[:n_kf] = np.arange(n_kf)
    return world, poses, pts


@pytest.mark.slow
def test_global_ba_at_map_scale_completes():
    """run_global over a 256-KF / 50k-landmark map (KITTI-00 order of
    magnitude) completes on one device via the slab-chunked Schur
    reduction (the dense (W,L,6,3) Hpl would be ~2.3 GiB; chunking
    bounds it) and refines perturbed poses."""
    import dataclasses

    from vslam_tpu.models import local_mapper

    n_kf, n_lm = 256, 50_000
    world, poses_gt, _ = _build_world_at_scale(n_kf, n_lm, keys_per_kf=1024)
    # realistic error model: smooth ACCUMULATED drift (translation random
    # walk), not white per-pose noise — white noise corrupts the relative
    # poses that the odometry BetweenFactor chain (built from current
    # estimates, like the reference src/OptimizationBA.cpp:750-768) then
    # pins, making recovery impossible by construction
    rng = np.random.default_rng(1)
    drift = np.cumsum(rng.normal(0, 0.004, (n_kf, 3)), axis=0).astype(np.float32)
    drift[0] = 0.0
    poses_pert = poses_gt.copy()
    poses_pert[:, :3, 3] += drift
    world.arrays = dataclasses.replace(
        world.arrays, kf_pose=jnp.asarray(poses_pert)
    )
    world.kf_poses_host[:] = poses_pert

    n_obs = int((world.kf_obs_lm[:n_kf] >= 0).sum())
    mapper = local_mapper.LocalMapper(
        world, K, BASELINE,
        local_mapper.LocalMapperConfig(iters_round1=3, iters_round2=5),
    )
    r = mapper.run_global(max_landmarks=1 << 17)
    assert r is not None
    assert len(r["window"]) == n_kf
    assert np.isfinite(r["error"])
    new_poses = world.kf_poses_host[:n_kf]
    assert np.isfinite(new_poses).all()
    # What global BA CAN do without loop closures (the reference has none
    # either — SURVEY.md: LC is vestigial): drive the map internally
    # consistent and recover LOCAL structure. Smooth accumulated drift
    # lies in the gauge near-null space (each landmark is seen by ~3
    # consecutive KFs, so a low-frequency warp moves landmarks+poses
    # together at ~zero reprojection cost) — absolute drift removal is a
    # loop-closure capability, not a BA deficiency.
    assert r["error"] < 0.01 * n_obs, (r["error"], n_obs)  # ~0 px^2 / obs
    def rel_err(ps):
        d = np.linalg.inv(ps[:-5]) @ ps[5:]
        dg = np.linalg.inv(poses_gt[:-5]) @ poses_gt[5:]
        return np.mean(np.linalg.norm(d[:, :3, 3] - dg[:, :3, 3], axis=1))
    assert rel_err(new_poses) < 0.7 * rel_err(poses_pert), (
        rel_err(new_poses), rel_err(poses_pert)
    )


def test_global_ba_truncation_is_logged(capsys):
    """Landmark truncation at max_landmarks must be observable — a
    warning line + counter, never silent."""
    from vslam_tpu.models import local_mapper

    world, _, _ = _build_world_at_scale(16, 3000, keys_per_kf=1024)
    mapper = local_mapper.LocalMapper(
        world, K, BASELINE,
        local_mapper.LocalMapperConfig(iters_round1=1, iters_round2=1),
    )
    tbl = world.kf_obs_lm[: world.n_keyframes]
    n_observed = len(np.unique(tbl[tbl >= 0]))
    assert n_observed > 1024  # the cap actually binds
    r = mapper.run_global(max_landmarks=1024)
    assert r is not None
    out = capsys.readouterr().out
    assert "truncating" in out
    assert mapper.counters.get("global_lm_truncated") == n_observed - 1024


def test_global_ba_refines_full_map():
    """run_global: a single 2-round Schur LM over EVERY keyframe — the
    grown-window/global mode the reference's ~11-KF GTSAM window cannot
    reach (SURVEY.md §5 long-context). Must not worsen the trajectory and
    must leave the map consistent."""
    import numpy as np

    from vslam_tpu.models import local_mapper, map_state, tracker
    from vslam_tpu.utils import synthetic, trajectory

    scene = synthetic.make_scene(
        n_frames=14, n_points=400, width=320, height=240, fps=10.0, seed=7
    )
    params = tracker.TrackerParams(
        n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256,
        kf_min_stereo=60,
    )
    world = map_state.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=512)
    trk = tracker.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, 320, 240, world, params
    )
    mapper = local_mapper.LocalMapper(
        world, scene.K.astype(np.float32), scene.baseline,
        local_mapper.LocalMapperConfig(n_levels=4, scale=1.2),
    )
    for f in range(14):
        n_kf = len(trk.new_kf_slots)
        trk.track(scene.render(f), scene.render(f, right=True))
        if len(trk.new_kf_slots) > n_kf and trk.new_kf_slots[-1] > 0:
            r = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])
    trk.flush()
    ate_before = trajectory.ate_rmse(
        trk.trajectory(), scene.poses_c2w[:14], align=False
    )

    r = mapper.run_global()
    assert r is not None
    assert len(r["window"]) == world.n_keyframes
    trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
    ate_after = trajectory.ate_rmse(
        trk.trajectory(), scene.poses_c2w[:14], align=False
    )
    # global refinement must not corrupt an already-good trajectory
    assert ate_after < max(1.25 * ate_before, 0.03), (ate_before, ate_after)
    # KF0 gauge held
    np.testing.assert_allclose(world.kf_poses_host[0], np.eye(4), atol=1e-5)
    # map still consistent: device poses mirror the host
    np.testing.assert_allclose(
        np.asarray(world.arrays.kf_pose[: world.n_keyframes]),
        world.kf_poses_host[: world.n_keyframes],
        atol=1e-5,
    )
