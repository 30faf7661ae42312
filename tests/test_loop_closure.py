"""Loop closure: pose-graph correction + detection/merge end-to-end.

The reference's loop-closure state is vestigial (include/Map.h:122-127 —
checked by both threads, set by nothing; SURVEY.md §2 quirks). These
tests cover the real implementation (models/pose_graph.py,
models/loop_closure.py)."""

import numpy as np
import pytest
import jax.numpy as jnp

from vslam_tpu.geometry import se3
from vslam_tpu.models import map_state, pose_graph
from vslam_tpu.ops import hamming
from vslam_tpu.utils import synthetic


def test_pose_graph_recovers_loop_drift():
    """A 40-pose chain with biased odometry drifts 0.7 m by the loop end;
    one correct loop edge must pull the end pose back to mm scale, with
    the error distributed along the chain."""
    n = 40
    step = np.asarray(
        se3.se3_expmap(jnp.asarray([0.0, 0.02, 0.0, 0.0, 0.0, 0.3], jnp.float32))
    )
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    drift_step = np.asarray(
        se3.se3_expmap(
            jnp.asarray([0.0005, 0.0225, 0.0, 0.004, 0.002, 0.301], jnp.float32)
        )
    )
    est = [gt[0]]
    for _ in range(1, n):
        est.append(est[-1] @ drift_step)
    est = np.stack(est)
    pre = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    assert pre > 0.5  # the drift is real

    ei = np.concatenate([np.arange(n - 1), [0]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, n), [n - 1]]).astype(np.int32)
    rel = np.concatenate(
        [
            np.tile(drift_step, (n - 1, 1, 1)),
            (np.linalg.inv(gt[0]) @ gt[-1])[None],
        ]
    ).astype(np.float32)
    w = np.full(n, 100.0, np.float32)
    ps, err = pose_graph.optimize(
        jnp.asarray(est), jnp.ones(n, bool), jnp.asarray(ei), jnp.asarray(ej),
        jnp.asarray(rel), jnp.asarray(w), iters=30,
    )
    ps = np.asarray(ps)
    post = np.linalg.norm(ps[-1][:3, 3] - gt[-1][:3, 3])
    assert post < 0.01, (pre, post)
    # gauge held
    np.testing.assert_array_equal(ps[0], est[0])
    # error distributed: every pose near ground truth
    errs = np.linalg.norm(ps[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert errs.max() < 0.05, errs.max()


def _drifted_chain(n, loops=((0, -1),), seed=None):
    """(gt, est, chain_rel(drifted), loop edges) for an n-pose chain whose
    odometry is biased; loop edge k connects pose loops[k][0] to
    loops[k][1] with the TRUE relative pose."""
    step = np.asarray(
        se3.se3_expmap(jnp.asarray([0.0, 0.02, 0.0, 0.0, 0.0, 0.3], jnp.float32))
    )
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    drift_step = np.asarray(
        se3.se3_expmap(
            jnp.asarray(
                [0.0005, 0.0225, 0.0, 0.004, 0.002, 0.301], jnp.float32
            )
        )
    )
    est = [gt[0]]
    for _ in range(1, n):
        est.append(est[-1] @ drift_step)
    est = np.stack(est)
    li, lj, lrel = [], [], []
    for a, b in loops:
        a, b = a % n, b % n
        li.append(a)
        lj.append(b)
        lrel.append(np.linalg.inv(gt[a]) @ gt[b])
    return gt, est, drift_step, (
        np.asarray(li, np.int32), np.asarray(lj, np.int32),
        np.stack(lrel).astype(np.float32),
    )


def test_sparse_pose_graph_matches_dense():
    """optimize_chain (block-Thomas + Woodbury, O(P)/iter) must land in
    the same minimum as the dense O(P^3) path on the identical drifted
    40-pose loop problem."""
    n = 40
    gt, est, drift_step, (li, lj, lrel) = _drifted_chain(n)
    chain_rel = np.tile(drift_step, (n - 1, 1, 1)).astype(np.float32)
    w = np.full(n - 1, 100.0, np.float32)

    ei = np.concatenate([np.arange(n - 1), li]).astype(np.int32)
    ej = np.concatenate([np.arange(1, n), lj]).astype(np.int32)
    rel = np.concatenate([chain_rel, lrel]).astype(np.float32)
    ew = np.full(n, 100.0, np.float32)
    ps_d, err_d = pose_graph.optimize(
        jnp.asarray(est), jnp.ones(n, bool), jnp.asarray(ei), jnp.asarray(ej),
        jnp.asarray(rel), jnp.asarray(ew), iters=30,
    )
    # sparse path, with padded loop slots (zero weight) like production
    L = 4
    lip = np.zeros(L, np.int32)
    ljp = np.zeros(L, np.int32)
    lrelp = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    lwp = np.zeros(L, np.float32)
    lip[: len(li)], ljp[: len(lj)], lrelp[: len(li)] = li, lj, lrel
    lwp[: len(li)] = 100.0
    ps_s, err_s = pose_graph.optimize_chain(
        jnp.asarray(est), jnp.ones(n, bool), jnp.asarray(chain_rel),
        jnp.asarray(w), jnp.asarray(lip), jnp.asarray(ljp),
        jnp.asarray(lrelp), jnp.asarray(lwp), iters=30,
    )
    ps_d, ps_s = np.asarray(ps_d), np.asarray(ps_s)
    # both reach the same basin: per-pose translations agree to mm scale
    dt = np.linalg.norm(ps_d[:, :3, 3] - ps_s[:, :3, 3], axis=1)
    assert dt.max() < 5e-3, dt.max()
    assert abs(float(err_d) - float(err_s)) < 1e-2 * max(float(err_d), 1.0)
    # and the sparse result actually solves the problem
    errs = np.linalg.norm(ps_s[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert errs.max() < 0.05, errs.max()


def test_sim3_pose_graph_recovers_scale_drift():
    """Monocular SCALE drift (each odometry step's translation stretched
    by a compounding factor) cannot be absorbed by an SE(3) loop edge —
    the Sim(3) chain graph (7-dof states, Strasdat/ORB-SLAM style) must
    distribute both the pose AND the scale error and recover the true
    trajectory where the SE(3) path demonstrably cannot."""
    from vslam_tpu.geometry import sim3

    n = 40
    step = np.asarray(
        se3.se3_expmap(jnp.asarray([0.0, 0.02, 0.0, 0.0, 0.0, 0.3], jnp.float32))
    )
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    # mono-style scale drift: step i's translation scaled by q^i
    q = 1.012  # compounds to ~1.6x by the loop end
    est = [gt[0]]
    for i in range(1, n):
        stretched = step.copy()
        stretched[:3, 3] *= q ** (i - 1)
        est.append(est[-1] @ stretched)
    est = np.stack(est).astype(np.float32)
    pre = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    assert pre > 0.5, pre  # the stretch is real

    # chain measurements from the DRIFTED estimates (scale-1 Sim(3));
    # loop edge (0, n-1) with the TRUE relative pose AND the measured
    # relative scale — the new leg's local map runs at ~q^(n-2) times the
    # old leg's scale, which is exactly what the Umeyama fit of merged
    # duplicate landmarks reports (ORB-SLAM's Horn-alignment Sim3 edge);
    # a scale-1 loop edge would FIGHT the chain instead of closing it
    chain_rel = np.stack(
        [np.linalg.inv(est[i]) @ est[i + 1] for i in range(n - 1)]
    ).astype(np.float32)
    w = np.full(n - 1, 100.0, np.float32)
    L = 4
    lip = np.zeros(L, np.int32)
    ljp = np.zeros(L, np.int32)
    lrelp = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    lwp = np.zeros(L, np.float32)
    lip[0], ljp[0] = 0, n - 1
    rel_true = np.linalg.inv(gt[0]) @ gt[-1]
    s_loop = float(q ** -(n - 2))  # measured new-leg/old-leg scale ratio
    Z = rel_true.copy().astype(np.float32)
    Z[:3, :3] *= s_loop
    lrelp[0] = Z
    lwp[0] = 100.0

    S_opt, err = pose_graph.optimize_sim3_chain(
        jnp.asarray(est), jnp.ones(n, bool), jnp.asarray(chain_rel),
        jnp.asarray(w), jnp.asarray(lip), jnp.asarray(ljp),
        jnp.asarray(lrelp), jnp.asarray(lwp), iters=40,
    )
    poses_s = np.asarray(sim3.to_se3(S_opt))
    post_sim3 = np.linalg.norm(poses_s[-1][:3, 3] - gt[-1][:3, 3])

    # the SE(3) path on the identical problem, for contrast
    ps_se3, _ = pose_graph.optimize_chain(
        jnp.asarray(est), jnp.ones(n, bool), jnp.asarray(chain_rel),
        jnp.asarray(w), jnp.asarray(lip), jnp.asarray(ljp),
        jnp.asarray(lrelp), jnp.asarray(lwp), iters=40,
    )
    ps_se3 = np.asarray(ps_se3)
    post_se3 = np.linalg.norm(ps_se3[-1][:3, 3] - gt[-1][:3, 3])

    # Sim(3) recovers the loop end AND the whole trajectory
    assert post_sim3 < 0.05 * pre, (pre, post_sim3)
    errs = np.linalg.norm(poses_s[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert errs.max() < 0.15, errs.max()
    # the recovered per-KF scales descend to compensate the stretch
    scales = np.asarray(sim3.scale_of(S_opt))
    assert scales[-1] < 0.85, scales[-1]
    # and SE(3) is measurably worse mid-chain (it cannot rescale the
    # stretched segments, only bend them)
    errs_se3 = np.linalg.norm(ps_se3[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert errs.max() < 0.5 * errs_se3.max(), (errs.max(), errs_se3.max())
    print(
        f"\n[sim3] pre={pre:.3f} post_sim3={post_sim3:.4f} "
        f"post_se3={post_se3:.4f} max_err sim3/se3="
        f"{errs.max():.3f}/{errs_se3.max():.3f} s_end={scales[-1]:.3f}"
    )


def test_sparse_pose_graph_scales_to_2048():
    """A 2048-keyframe graph (the dense path's documented P <= ~1k wall:
    a KITTI-scale map with degraded tracking blows past 1k KFs) with 3 loop edges optimizes in seconds on the CPU tier
    and recovers the drift."""
    import time

    n = 2048
    gt, est, drift_step, (li, lj, lrel) = _drifted_chain(
        n, loops=((0, 680), (0, 1360), (0, -1))
    )
    # drift across 2048 composed steps is enormous; rebuild with a much
    # smaller bias so the linearization basin still contains the truth
    small = np.asarray(
        se3.se3_expmap(
            jnp.asarray([2e-5, 0.0201, 0.0, 2e-4, 1e-4, 0.30004], jnp.float32)
        )
    )
    est = [gt[0]]
    for _ in range(1, n):
        est.append(est[-1] @ small)
    est = np.stack(est)
    pre = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    assert pre > 0.1, pre

    chain_rel = np.tile(small, (n - 1, 1, 1)).astype(np.float32)
    w = np.full(n - 1, 100.0, np.float32)
    L = 4
    lip = np.zeros(L, np.int32)
    ljp = np.zeros(L, np.int32)
    lrelp = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    lwp = np.zeros(L, np.float32)
    lip[: len(li)], ljp[: len(lj)], lrelp[: len(li)] = li, lj, lrel
    lwp[: len(li)] = 100.0

    args = (
        jnp.asarray(est), jnp.ones(n, bool), jnp.asarray(chain_rel),
        jnp.asarray(w), jnp.asarray(lip), jnp.asarray(ljp),
        jnp.asarray(lrelp), jnp.asarray(lwp),
    )
    ps, err = pose_graph.optimize_chain(*args, iters=25)  # includes compile
    t0 = time.perf_counter()
    ps, err = pose_graph.optimize_chain(*args, iters=25)
    ps = np.asarray(ps)
    dt_solve = time.perf_counter() - t0
    assert dt_solve < 60.0, f"sparse pose graph too slow: {dt_solve:.1f}s"
    post = np.linalg.norm(ps[-1][:3, 3] - gt[-1][:3, 3])
    assert post < 0.1 * pre, (pre, post)
    errs = np.linalg.norm(ps[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert errs.max() < 0.2, errs.max()


def _split_map_world(n_kf=20, n_pts=400, seed=3, scale_err=1.0):
    """A map whose trajectory revisits its start, built as TWO sub-maps:
    leg A (KFs 0..9, ground truth) and leg B (KFs 10..19) stored with a
    rigid DRIFT offset T_err — the situation after accumulated drift (or
    a re-seed): leg B re-observes leg A's physical structure under
    DUPLICATE landmark ids at offset positions. All stored quantities are
    self-consistent (a rigid offset preserves projections), so only a
    loop closure can discover and remove the offset. Returns
    (world, true_poses, T_err)."""
    import dataclasses

    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    K = np.array([[460.0, 0, 160.0], [0, 460.0, 120.0], [0, 0, 1.0]], np.float32)
    X = np.stack(
        [rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
         rng.uniform(5, 11, n_pts)], -1,
    ).astype(np.float32)
    desc = (rng.integers(0, 2, (n_pts, 256)) * 2 - 1).astype(np.int8)

    half = n_kf // 2
    true_poses = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    zmax = 2.0
    for i in range(n_kf):
        if i < half:
            true_poses[i, :3, 3] = [0.0, 0.0, zmax * i / (half - 1)]
        else:
            true_poses[i, :3, 3] = [
                0.25, 0.0, zmax * (1.0 - (i - half) / (n_kf - half)),
            ]
    xi = np.array([0.06, 0.22, 0.08, 0.015, 0.03, 0.01], np.float32)
    T_err = np.asarray(se3.se3_expmap(jnp.asarray(xi)))  # the drift
    # optional SIMILARITY drift (mono tests): leg B additionally scaled
    # by scale_err about the origin — projections stay consistent
    # because a global similarity of camera + points preserves images

    keys_per_kf = 512
    world = map_state.WorldMap(
        lm_capacity=2048, kf_capacity=32, keys_per_kf=keys_per_kf,
        right_obs_per_kf=8,
    )
    # duplicate landmark populations: leg A ids 0..n_pts-1 at X; leg B ids
    # n_pts..2*n_pts-1 at T_err @ X
    XB = scale_err * ((T_err[:3, :3] @ X.T).T + T_err[:3, 3])
    lm_pos = np.zeros((2048, 3), np.float32)
    lm_pos[:n_pts] = X
    lm_pos[n_pts : 2 * n_pts] = XB
    lm_desc = np.zeros((2048, 256), np.int8)
    lm_desc[:n_pts] = desc
    lm_desc[n_pts : 2 * n_pts] = desc
    lm_valid = np.zeros(2048, bool)
    lm_valid[: 2 * n_pts] = True

    stored_poses = true_poses.copy()
    stored_poses[half:] = np.einsum("ij,kjl->kil", T_err, true_poses[half:])
    stored_poses[half:, :3, 3] *= scale_err  # similarity: t' = s(R t + t_err)

    obs_uv = np.zeros((32, keys_per_kf, 3), np.float32)
    obs_lm = np.full((32, keys_per_kf), -1, np.int64)
    obs_desc = np.zeros((32, keys_per_kf, 256), np.int8)
    obs_valid = np.zeros((32, keys_per_kf), bool)
    for i in range(n_kf):
        T_cw = np.linalg.inv(true_poses[i])
        pc = (T_cw[:3, :3] @ X.T).T + T_cw[:3, 3]
        u = K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2]
        v = K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]
        vis = (pc[:, 2] > 1.0) & (u > 5) & (u < 315) & (v > 5) & (v < 235)
        idx = np.nonzero(vis)[0][:keys_per_kf]
        base = 0 if i < half else n_pts
        obs_uv[i, : len(idx), 0] = u[idx]
        obs_uv[i, : len(idx), 1] = v[idx]
        obs_lm[i, : len(idx)] = base + idx
        obs_desc[i, : len(idx)] = desc[idx]
        obs_valid[i, : len(idx)] = True

    world.arrays = dataclasses.replace(
        world.arrays,
        kf_pose=jnp.asarray(stored_poses[:32].copy() if len(stored_poses) >= 32 else np.concatenate([stored_poses, np.tile(np.eye(4, dtype=np.float32), (32 - n_kf, 1, 1))])),
        kf_valid=jnp.asarray(np.arange(32) < n_kf),
        lm_pos=jnp.asarray(lm_pos),
        lm_desc=jnp.asarray(lm_desc),
        lm_valid=jnp.asarray(lm_valid),
        obs_uv=jnp.asarray(obs_uv),
        obs_lm=jnp.asarray(obs_lm.astype(np.int32)),
        obs_desc=jnp.asarray(hamming.pack_signed(obs_desc)),
        obs_valid=jnp.asarray(obs_valid),
    )
    pad = np.tile(np.eye(4, dtype=np.float32), (32, 1, 1))
    pad[:n_kf] = stored_poses
    world.kf_poses_host[:] = pad
    world.kf_obs_lm[:] = obs_lm
    world.n_keyframes = n_kf
    world.n_landmarks = 2 * n_pts
    world.kf_frame_idx[:n_kf] = np.arange(n_kf)
    return world, true_poses, np.asarray(T_err), K


def test_loop_closure_detects_and_merges():
    """End-to-end on the split map: the last keyframe revisits the start
    under a rigid drift offset with duplicate landmarks. LoopCloser must
    retrieve a leg-A keyframe (the legs share NO ids, so covisibility
    exclusion cannot hide it), verify geometrically, pose-graph away most
    of the offset, and merge the duplicate landmarks."""
    from vslam_tpu.models import loop_closure

    world, true_poses, T_err, K = _split_map_world()
    n = world.n_keyframes
    pre_err = np.linalg.norm(
        world.kf_poses_host[n - 1][:3, 3] - true_poses[n - 1][:3, 3]
    )
    assert pre_err > 0.08  # the injected drift is real

    closer = loop_closure.LoopCloser(world, K, 0.12, min_gap=3)
    # temporal consistency: the first detection only arms the candidate;
    # the second consecutive agreeing keyframe applies the closure
    assert closer.try_close(n - 2) is None
    assert closer._last_cand is not None, "first detection did not fire"
    rc = closer.try_close(n - 1)
    assert rc is not None, "loop not detected"
    assert rc["old_kf"] < n // 2, rc  # retrieved from leg A
    assert rc["n_merged"] > 100, rc

    post_err = np.linalg.norm(
        world.kf_poses_host[n - 1][:3, 3] - true_poses[n - 1][:3, 3]
    )
    # most of the drift removed (the graph splits the error across the
    # odometry links, so exact recovery is not expected)
    assert post_err < 0.4 * pre_err, (pre_err, post_err)
    # merged ids are gone from every observation table and invalid
    valid = np.asarray(world.arrays.lm_valid)
    tbl = world.kf_obs_lm[:n]
    live = tbl[tbl >= 0]
    assert valid[live].all(), "observation tables reference merged-away ids"
    # device and host observation tables agree after the remap
    np.testing.assert_array_equal(
        np.asarray(world.arrays.obs_lm)[:n], tbl.astype(np.int32)
    )


def test_mono_mode_loop_closure_detects_and_merges():
    """Loop closure in MONOCULAR observation mode: the split-map world re-run with
    baseline=0 and NO right-camera rows — detection, the
    projection-only geometric verification (the path mono mode
    exercises), the Sim(3) chain graph and the merge must close it.

    Leg B carries a SIMILARITY drift — the rigid offset AND a 0.9 scale,
    the mono failure mode an SE(3) edge cannot absorb. The mono path
    measures the loop edge's relative scale by a scaled Umeyama fit of
    the merged duplicate-landmark pairs and optimizes 7-dof Sim(3)
    states (pose_graph.optimize_sim3_chain, ORB-SLAM's approach); the
    landmarks move by the full similarity delta. (The reference has no
    loop closure in ANY mode.)"""
    from vslam_tpu.models import loop_closure

    world, true_poses, T_err, K = _split_map_world(scale_err=0.9)
    n = world.n_keyframes
    # mono mode: drop every right-camera observation row
    import dataclasses

    world.arrays = dataclasses.replace(
        world.arrays,
        obs_r_lm=jnp.full_like(world.arrays.obs_r_lm, -1),
    )
    world.kf_obs_r_lm[:] = -1
    pre_err = np.linalg.norm(
        world.kf_poses_host[n - 1][:3, 3] - true_poses[n - 1][:3, 3]
    )

    closer = loop_closure.LoopCloser(world, K, 0.0, min_gap=3)  # baseline 0
    assert closer.try_close(n - 2) is None  # arms the candidate
    rc = closer.try_close(n - 1)
    assert rc is not None, "mono-mode loop not detected"
    assert rc["old_kf"] < n // 2, rc
    assert rc["n_merged"] > 100, rc
    post_err = np.linalg.norm(
        world.kf_poses_host[n - 1][:3, 3] - true_poses[n - 1][:3, 3]
    )
    assert post_err < 0.4 * pre_err, (pre_err, post_err)


@pytest.mark.slow
def test_live_circuit_loop_closure(tmp_path):
    """Loop closure END-TO-END through the LIVE pipeline: the tracker drives a full synthetic circuit
    (make_loop_scene: camera circles inside a cylindrical wall, returning
    to its start pose), accumulating real odometry drift; detection must
    fire at the actual revisit — validating MIN_GAP / min_votes /
    verification thresholds against live tracker output instead of
    hand-built tables — the pose graph + merge must reduce the drifted
    pose error, and a follow-up global BA must keep the trajectory tight.
    (The reference's loop-closure state is checked by both threads but
    never driven — include/Map.h:122-127.)"""
    import pathlib

    from vslam_tpu.models import system as system_mod
    from vslam_tpu.utils import trajectory
    from vslam_tpu.utils.config import ConfigFile

    W, H = 512, 384
    n = 360
    # 1.2 laps: the revisit OVERLAP spans ~60 frames, so detection gets
    # its two consecutive agreeing keyframes even at a sparse KF cadence
    scene = synthetic.make_loop_scene(n_frames=n, width=W, height=H, loops=1.2)
    cfg = pathlib.Path(tmp_path) / "c.yaml"
    cfg.write_text(f"""rectified: true
slamMode: 1
dataset: "KITTI"
imagesPath: "/nonexistent"
fileExtension: ".png"
Camera: {{width: {W}, height: {H}, fps: 10.0, bl: 0.12}}
Camera_l: {{fx: 460.0, fy: 460.0, cx: {W/2}, cy: {H/2}}}
Camera_r: {{fx: 460.0, fy: 460.0, cx: {W/2}, cy: {H/2}}}
FE: {{nFeatures: 1024, nLevels: 8, imScale: 1.2, edgeThreshold: 19, maxFastThreshold: 20, minFastThreshold: 7}}
""")
    # active_size deliberately SMALLER than the map (the production
    # big-map regime): landmarks out of view never age (reference
    # setActiveOutliers semantics), so with a roomy active set the
    # lap-start landmarks survive the whole lap and the tracker simply
    # RE-ACQUIRES them at the revisit — the map self-closes and the
    # loop-closure subsystem correctly stays idle (measured: 218 shared
    # observations between the revisit KF and KF0, ATE 0.05 with zero
    # closures). At KITTI-00 scale the active set cannot hold the map,
    # re-acquisition is impossible, and the detector must fire.
    from vslam_tpu.models import tracker as tracker_mod

    params = tracker_mod.TrackerParams(
        n_features=1024, n_levels=8, active_size=1024,
    )
    sys_ = system_mod.VSlamSystem(
        ConfigFile(str(cfg)), async_ba=True, lm_capacity=1 << 15,
        kf_capacity=256, loop_closure=True, tracker_params=params,
    )
    # deterministic consume latency: reproducible closure timing (the
    # same switch the bench circuit uses; see VSlamSystem)
    sys_.deterministic_ba_latency = True
    events = []
    orig_close = sys_.loop_closer.close

    def close_spy(kf_slot, old_kf, T_loop):
        r = orig_close(kf_slot, old_kf, T_loop)
        if r is not None:
            events.append(dict(r))
        return r

    sys_.loop_closer.close = close_spy

    # keyframe-pose ATE vs ground truth, sampled around the automatic
    # post-closure polish (the BA must IMPROVE on the graph-only
    # correction, not just not regress)
    w = sys_.world

    def kf_ate():
        nk = w.n_keyframes
        fr = w.kf_frame_idx[:nk].astype(int)
        est = w.kf_poses_host[:nk, :3, 3]
        gt = scene.poses_c2w[fr][:, :3, 3]
        return float(np.sqrt(((est - gt) ** 2).sum(1).mean()))

    polish_deltas = []
    orig_global = sys_.mapper.run_global

    def global_spy(*a, **k):
        pre = kf_ate()
        r = orig_global(*a, **k)
        if r is not None:
            polish_deltas.append((pre, kf_ate()))
        return r

    sys_.mapper.run_global = global_spy
    for f in range(n):
        sys_.track_stereo(scene.render(f), scene.render(f, right=True))
    sys_.exit()

    # 1. detection fired through the live pipeline, at the actual revisit:
    #    the new keyframe sits in the second lap, the retrieved old
    #    keyframe in the first quarter-lap
    assert sys_.loop_closer.closures >= 1, "no closure fired on a full circuit"
    ev = events[0]
    lap = int(n / 1.2)
    new_frame = int(w.kf_frame_idx[ev["kf_slot"]])
    old_frame = int(w.kf_frame_idx[ev["old_kf"]])
    assert new_frame > lap - 40, (new_frame, lap)
    assert old_frame < lap // 3, (old_frame, lap)
    assert ev["n_merged"] > 0  # duplicate landmarks actually merged

    # 2. the correction moved the revisit keyframe TOWARD ground truth
    gt_t = scene.poses_c2w[new_frame][:3, 3]
    pre = np.linalg.norm(ev["old_pose"][:3, 3] - gt_t)
    post = np.linalg.norm(ev["new_pose"][:3, 3] - gt_t)
    assert post < pre, (pre, post)

    # 3. the AUTOMATIC post-closure polish ran and improved on the
    #    graph-only correction (ate_post_ba < ate_post_graph).
    #    Per-polish kf-ATE deltas are noisy run-to-run (async consume
    #    timing shifts closure cadence; a single polish can land within
    #    the +-0.01 noise band), so the evidence gate is: SOME polish
    #    measurably improved, or the final trajectory beats the best the
    #    graph-only (r4) pipeline ever produced (0.058).
    assert polish_deltas, "closure applied but no automatic polish ran"
    poses = sys_.trajectory()
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[: len(poses)], align=False)
    improved = any(post < pre for pre, post in polish_deltas)
    assert improved or ate < 0.05, (polish_deltas, ate)

    # 4. final trajectory is tight and a follow-up global BA stays tight
    assert ate < 0.06, ate
    assert sys_.global_ba() is not None
    poses2 = sys_.trajectory()
    ate2 = trajectory.ate_rmse(poses2, scene.poses_c2w[: len(poses2)], align=False)
    assert ate2 < max(1.1 * ate, 0.05), (ate, ate2)
    print(f"\n[live-loop] closures={sys_.loop_closer.closures} "
          f"ate={ate:.4f} -> {ate2:.4f} (closure err {pre:.3f}->{post:.3f}; "
          f"polish kf_ate deltas {[(round(a, 4), round(b, 4)) for a, b in polish_deltas]})")
