"""Distributed BA tests on the virtual 8-device CPU mesh.

SURVEY.md §4's distributed-test strategy: the single-host and N-shard BA
must produce tolerance-identical updates, runnable without several devices
via the conftest's 8-device CPU mesh. The sharded path here is the SAME
kernel the live mapper runs (schur.local_ba_two_rounds with axis_name),
so these tests cover the production distributed path, not a demo.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vslam_tpu.geometry import se3
from vslam_tpu.models import local_mapper, map_state, tracker
from vslam_tpu.ops import schur
from vslam_tpu.parallel import mesh as mesh_mod
from vslam_tpu.parallel import sharded_ba
from vslam_tpu.utils import synthetic, trajectory

from tests.test_ba import _build_problem

N_DEV = 8


def test_sharded_two_rounds_matches_single_device():
    """The full 2-round sharded BA (obs rows sharded, psum-assembled
    normal equations, slab-sharded Schur reduction) must match the
    single-device kernel — same algorithm, different reduction order."""
    p, poses_gt, pts_gt = _build_problem(W=8, L=128, seed=1)
    mesh = mesh_mod.make_mesh(N_DEV, axis=sharded_ba.AXIS)
    step = sharded_ba.sharded_two_rounds(mesh, iters1=5, iters2=10)

    p_s, err_s, kill_s = sharded_ba.run_problem(step, p)
    p_d, err_d, kill_d = schur.local_ba_two_rounds(p, iters1=5, iters2=10)

    # same solution (both in the ground-truth basin, and mutually close)
    for w in range(len(poses_gt)):
        rel = np.linalg.inv(np.asarray(p_d.poses)[w]) @ np.asarray(p_s.poses)[w]
        xi = np.asarray(se3.se3_logmap(jnp.asarray(rel)))
        assert np.abs(xi).max() < 1e-3, (w, xi)
        xi_gt = np.asarray(
            se3.se3_logmap(
                jnp.asarray(np.linalg.inv(poses_gt[w]) @ np.asarray(p_s.poses)[w])
            )
        )
        assert np.abs(xi_gt).max() < 2e-3, (w, xi_gt)
    np.testing.assert_allclose(
        np.asarray(p_s.pts), np.asarray(p_d.pts), rtol=1e-3, atol=1e-3
    )
    # kill masks agree (exact observations -> none killed on either path)
    np.testing.assert_array_equal(np.asarray(kill_s), np.asarray(kill_d))
    assert abs(float(err_s) - float(err_d)) <= 1e-2 * max(float(err_d), 1.0)


def test_sharded_two_rounds_realistic_size_runs():
    """Smoke at the LIVE problem shape (WTOT pose slots, 4096 landmark
    slots, WTOT*(K+Kr) observation rows) — the size the mapper actually
    dispatches, divisible by the 8-device mesh."""
    Wb = local_mapper.WTOT
    L = local_mapper.LM_SLOTS
    O = Wb * (1024 + 256)
    rng = np.random.default_rng(0)
    p, _, _ = _build_problem(W=Wb, L=64, seed=3)
    # expand to full shapes with masked padding
    reps = O // len(np.asarray(p.obs_kf)) + 1
    idx = np.tile(np.arange(len(np.asarray(p.obs_kf))), reps)[:O]
    pts = np.zeros((L, 3), np.float32)
    pts[:64] = np.asarray(p.pts)
    pt_valid = np.zeros(L, bool)
    pt_valid[:64] = True
    p_big = p._replace(
        pts=jnp.asarray(pts),
        pt_valid=jnp.asarray(pt_valid),
        obs_kf=jnp.asarray(np.asarray(p.obs_kf)[idx]),
        obs_lm=jnp.asarray(np.asarray(p.obs_lm)[idx]),
        obs_uv=jnp.asarray(np.asarray(p.obs_uv)[idx]),
        obs_stereo=jnp.asarray(np.asarray(p.obs_stereo)[idx]),
        obs_right=jnp.asarray(np.asarray(p.obs_right)[idx]),
        obs_w=jnp.asarray(np.asarray(p.obs_w)[idx]),
        obs_valid=jnp.asarray(np.asarray(p.obs_valid)[idx] & (idx < idx.size)),
    )
    mesh = mesh_mod.make_mesh(N_DEV, axis=sharded_ba.AXIS)
    step = sharded_ba.sharded_two_rounds(mesh, iters1=2, iters2=2)
    p_s, err, kill = sharded_ba.run_problem(step, p_big)
    assert np.isfinite(np.asarray(p_s.poses)).all()
    assert np.isfinite(float(err))


def test_sharded_slabbed_matches_single_device():
    """The COMPOSED path — mesh-sharded linearization + slab-chunked
    Schur reduction (run_global at map scale) — must match both the
    unsharded-slabbed and the plain single-device kernels."""
    p, poses_gt, pts_gt = _build_problem(W=8, L=128, seed=5)
    mesh = mesh_mod.make_mesh(N_DEV, axis=sharded_ba.AXIS)
    # L=128, n_slabs=4, mesh=8 -> 4-landmark sub-slabs per shard
    step = sharded_ba.sharded_two_rounds(mesh, iters1=5, iters2=10, n_slabs=4)

    p_ss, err_ss, kill_ss = sharded_ba.run_problem(step, p)
    p_sl, err_sl, kill_sl = schur.local_ba_two_rounds(
        p, iters1=5, iters2=10, n_slabs=4
    )
    p_d, err_d, kill_d = schur.local_ba_two_rounds(p, iters1=5, iters2=10)

    for w in range(len(poses_gt)):
        for other in (p_sl, p_d):
            rel = np.linalg.inv(np.asarray(other.poses)[w]) @ np.asarray(
                p_ss.poses
            )[w]
            xi = np.asarray(se3.se3_logmap(jnp.asarray(rel)))
            assert np.abs(xi).max() < 1e-3, (w, xi)
    np.testing.assert_allclose(
        np.asarray(p_ss.pts), np.asarray(p_d.pts), rtol=1e-3, atol=1e-3
    )
    np.testing.assert_array_equal(np.asarray(kill_ss), np.asarray(kill_d))
    assert abs(float(err_ss) - float(err_d)) <= 1e-2 * max(float(err_d), 1.0)


def test_global_ba_uses_mesh_when_slabbed(monkeypatch):
    """run_global with a configured mesh AND a slab-chunked reduction must
    route through the sharded kernel (the round-3 gap: ops/schur raised on
    axis_name + n_slabs, so map-scale global BA ran single-device exactly
    where the mesh pays most)."""
    from vslam_tpu.utils import synthetic

    scene = synthetic.make_scene(
        n_frames=10, n_points=400, width=320, height=240, fps=10.0, seed=11
    )
    params = tracker.TrackerParams(
        n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60
    )
    mesh = mesh_mod.make_mesh(N_DEV, axis=sharded_ba.AXIS)
    world = map_state.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=512)
    trk = tracker.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, scene.width, scene.height,
        world, params,
    )
    mapper = local_mapper.LocalMapper(
        world, scene.K.astype(np.float32), scene.baseline, mesh=mesh
    )
    for f in range(10):
        nk = len(trk.new_kf_slots)
        trk.track(scene.render(f), scene.render(f, right=True))
        if len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
            r = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])
    trk.flush()
    # force the memory guard to chunk (tiny budget + low slab floor) and
    # verify the sharded cache gains an n_slabs>1 variant = the composed
    # kernel actually ran
    monkeypatch.setattr(mapper, "GLOBAL_SLAB_BYTES", 1 << 10)
    monkeypatch.setattr(mapper, "GLOBAL_MIN_SLAB", 128)
    r = mapper.run_global()
    assert r is not None and np.isfinite(r["error"])
    assert any(k > 1 for k in mapper._sharded_cache), (
        "global BA did not take the sharded slab-chunked path"
    )


@pytest.mark.slow
def test_sharded_mapper_end_to_end_matches_single_device():
    """Full tracking+mapping loop with the SHARDED mapper vs the
    single-device mapper: same trajectory to float-reduction tolerance."""
    scene = synthetic.make_scene(
        n_frames=12, n_points=400, width=320, height=240, fps=10.0, seed=7
    )
    params = tracker.TrackerParams(
        n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60
    )

    def run(mesh):
        world = map_state.WorldMap(
            lm_capacity=8192, kf_capacity=64, keys_per_kf=512
        )
        trk = tracker.StereoTracker(
            scene.K.astype(np.float32), scene.baseline, scene.width,
            scene.height, world, params,
        )
        mapper = local_mapper.LocalMapper(
            world, scene.K.astype(np.float32), scene.baseline, mesh=mesh
        )
        for f in range(12):
            nk = len(trk.new_kf_slots)
            trk.track(scene.render(f), scene.render(f, right=True))
            if len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
                r = mapper.run(trk.new_kf_slots[-1])
                trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
                trk.add_active(r["new_lm_ids"])
        return trk.trajectory(), mapper.ba_count

    traj_single, n1 = run(None)
    traj_shard, n2 = run(mesh_mod.make_mesh(N_DEV, axis=sharded_ba.AXIS))
    assert n2 == n1 and n2 > 0
    assert len(traj_shard) == len(traj_single)
    # identical pipeline, BA differs only in float reduction order
    d = np.linalg.norm(
        traj_shard[:, :3, 3] - traj_single[:, :3, 3], axis=1
    )
    assert d.max() < 0.01, d
    gt = scene.poses_c2w[: len(traj_shard)]
    ate = trajectory.ate_rmse(traj_shard, gt, align=False)
    assert ate < 0.03, ate


def test_dryrun_multichip_entrypoint():
    """The driver's multi-chip dry run must compile + execute on the
    virtual mesh."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(N_DEV)


def test_multi_sequence_batch_matches_individual_runs():
    """Multi-sequence batch mode (SURVEY.md §7 phase 5): S sequences ride
    ONE vmapped frame program; each sequence's trajectory must match its
    own single-sequence run (same math, batched execution)."""
    from vslam_tpu.models import local_mapper, map_state, tracker
    from vslam_tpu.parallel import multi_seq
    from vslam_tpu.utils import synthetic, trajectory

    n, S = 10, 3
    params = tracker.TrackerParams(
        n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256,
        kf_min_stereo=60,
    )
    scenes = [
        synthetic.make_scene(
            n_frames=n, n_points=400, width=320, height=240, fps=10.0,
            seed=7 + 3 * s,
        )
        for s in range(S)
    ]

    def make(scene):
        world = map_state.WorldMap(
            lm_capacity=8192, kf_capacity=64, keys_per_kf=params.n_features
        )
        trk = tracker.StereoTracker(
            scene.K.astype(np.float32), scene.baseline, scene.width,
            scene.height, world, params,
        )
        mapper = local_mapper.LocalMapper(
            world, scene.K.astype(np.float32), scene.baseline,
            local_mapper.LocalMapperConfig(n_levels=4, scale=1.2),
        )
        return trk, mapper

    # individual baseline runs
    solo = []
    for s in range(S):
        trk, mapper = make(scenes[s])
        for f in range(n):
            nk = len(trk.new_kf_slots)
            trk.track(scenes[s].render(f), scenes[s].render(f, right=True))
            if len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
                r = mapper.run(trk.new_kf_slots[-1])
                trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
                trk.add_active(r["new_lm_ids"])
        solo.append(trk.trajectory())

    # batched run
    pairs = [make(sc) for sc in scenes]
    front = multi_seq.BatchedStereoFrontend([p[0] for p in pairs])
    for f in range(n):
        nks = [len(p[0].new_kf_slots) for p in pairs]
        front.track(
            [(scenes[s].render(f), scenes[s].render(f, right=True)) for s in range(S)]
        )
        for s, (trk, mapper) in enumerate(pairs):
            if len(trk.new_kf_slots) > nks[s] and trk.new_kf_slots[-1] > 0:
                r = mapper.run(trk.new_kf_slots[-1])
                trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
                trk.add_active(r["new_lm_ids"])
    front.flush()

    for s, (trk, _) in enumerate(pairs):
        batched = trk.trajectory()
        assert len(batched) == len(solo[s]) == n
        # identical pipeline, batched execution: same result up to float
        # fusion-order differences
        np.testing.assert_allclose(batched, solo[s], atol=2e-3)
        ate = trajectory.ate_rmse(
            batched, scenes[s].poses_c2w[:n], align=False
        )
        assert ate < 0.04, (s, ate)


def test_multi_sequence_batch_mono():
    """Mono-IMU multi-sequence batch: bootstraps run unbatched per sequence, the steady state
    rides one vmapped mono _track_step; each sequence's trajectory must
    match its own solo mono run."""
    from vslam_tpu.models import local_mapper, map_state, tracker
    from vslam_tpu.parallel import multi_seq
    from vslam_tpu.utils import datasets, synthetic, trajectory

    n, S = 14, 2
    params = tracker.TrackerParams(
        n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256,
    )
    scenes = [
        synthetic.make_scene(
            n_frames=n, n_points=500, width=320, height=240, fps=10.0,
            seed=11 + 5 * s, texture="distinct", motion="lateral",
        )
        for s in range(S)
    ]
    all_bins = [datasets.bin_imu_per_frame(sc.imu, sc.times) for sc in scenes]

    def dt_rows(bins, f):
        rows = bins[f]
        if rows is None or len(rows) == 0:
            return None
        t = rows[:, 0]
        dts = np.diff(np.concatenate([[t[0] - 1.0 / 200.0], t]))
        return np.concatenate(
            [np.maximum(dts, 0)[:, None], rows[:, 1:7]], axis=1
        ).astype(np.float32)

    def make(scene):
        world = map_state.WorldMap(
            lm_capacity=8192, kf_capacity=64, keys_per_kf=params.n_features
        )
        cfg = tracker.ImuConfig(
            gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5,
            accel_walk=3e-3, hz=200.0, T_bc=np.eye(4, dtype=np.float32),
            gravity_w=synthetic.GRAVITY_W.astype(np.float32),
        )
        trk = tracker.MonoTracker(
            scene.K.astype(np.float32), scene.width, scene.height, world,
            params, imu_cfg=cfg,
        )
        trk.velocity = scene.velocities[0].astype(np.float32)
        mapper = local_mapper.LocalMapper(
            world, scene.K.astype(np.float32), 0.0,
            local_mapper.LocalMapperConfig(n_levels=4, scale=1.2),
        )
        return trk, mapper

    def service(trk, mapper, nk_before):
        if getattr(trk, "needs_init_triangulation", False):
            ids = mapper.find_new_points(trk.new_kf_slots[-1], mono=True)
            trk.add_active(ids)
            trk.needs_init_triangulation = False
            trk.last_kf_tracked = max(len(ids), 1)
        elif len(trk.new_kf_slots) > nk_before and trk.new_kf_slots[-1] > 0:
            ids = mapper.find_new_points(trk.new_kf_slots[-1], mono=True)
            trk.add_active(ids)

    solo = []
    for s in range(S):
        trk, mapper = make(scenes[s])
        for f in range(n):
            nk = len(trk.new_kf_slots)
            trk.track(scenes[s].render(f), imu=dt_rows(all_bins[s], f))
            service(trk, mapper, nk)
        solo.append(trk.trajectory())

    pairs = [make(sc) for sc in scenes]
    front = multi_seq.BatchedStereoFrontend([p[0] for p in pairs])
    assert front._mono and front._has_imu
    for f in range(n):
        nks = [len(p[0].new_kf_slots) for p in pairs]
        front.track(
            [scenes[s].render(f) for s in range(S)],
            imu=[dt_rows(all_bins[s], f) for s in range(S)],
        )
        for s, (trk, mapper) in enumerate(pairs):
            service(trk, mapper, nks[s])
    front.flush()

    for s, (trk, _) in enumerate(pairs):
        batched = trk.trajectory()
        assert len(batched) == len(solo[s]) == n
        np.testing.assert_allclose(batched, solo[s], atol=2e-3)
        ate = trajectory.ate_rmse(batched, scenes[s].poses_c2w[:n], align=False)
        assert ate < 0.06, (s, ate)


def test_multi_sequence_batch_imu():
    """Stereo-IMU multi-sequence batch (the IMU state is per-sequence
    identical and batches the same way): per-sequence IMU
    constants ride as batched operands, per-frame sample bins as a
    stacked array; each sequence's trajectory must match its own solo
    stereo-IMU run."""
    from vslam_tpu.models import local_mapper, map_state, tracker
    from vslam_tpu.parallel import multi_seq
    from vslam_tpu.utils import datasets, synthetic, trajectory

    n, S = 8, 2
    params = tracker.TrackerParams(
        n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256,
        kf_min_stereo=60,
    )
    scenes = [
        synthetic.make_scene(
            n_frames=n, n_points=400, width=320, height=240, fps=10.0,
            seed=7 + 5 * s,
        )
        for s in range(S)
    ]
    all_bins = [datasets.bin_imu_per_frame(sc.imu, sc.times) for sc in scenes]

    def dt_rows(bins, f):
        rows = bins[f]
        if rows is None or len(rows) == 0:
            return None
        t = rows[:, 0]
        dts = np.diff(np.concatenate([[t[0] - 1.0 / 200.0], t]))
        return np.concatenate(
            [np.maximum(dts, 0)[:, None], rows[:, 1:7]], axis=1
        ).astype(np.float32)

    def make(scene):
        world = map_state.WorldMap(
            lm_capacity=8192, kf_capacity=64, keys_per_kf=params.n_features
        )
        cfg = tracker.ImuConfig(
            gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5,
            accel_walk=3e-3, hz=200.0, T_bc=np.eye(4, dtype=np.float32),
            gravity_w=synthetic.GRAVITY_W.astype(np.float32),
        )
        trk = tracker.StereoTracker(
            scene.K.astype(np.float32), scene.baseline, scene.width,
            scene.height, world, params, imu_cfg=cfg,
        )
        trk.velocity = scene.velocities[0].astype(np.float32)
        mapper = local_mapper.LocalMapper(
            world, scene.K.astype(np.float32), scene.baseline,
            local_mapper.LocalMapperConfig(n_levels=4, scale=1.2),
        )
        return trk, mapper

    def run_kf(trk, mapper, nk_before):
        if len(trk.new_kf_slots) > nk_before and trk.new_kf_slots[-1] > 0:
            r = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])

    solo = []
    for s in range(S):
        trk, mapper = make(scenes[s])
        for f in range(n):
            nk = len(trk.new_kf_slots)
            trk.track(
                scenes[s].render(f), scenes[s].render(f, right=True),
                imu=dt_rows(all_bins[s], f),
            )
            run_kf(trk, mapper, nk)
        solo.append(trk.trajectory())

    pairs = [make(sc) for sc in scenes]
    front = multi_seq.BatchedStereoFrontend([p[0] for p in pairs])
    assert front._has_imu
    for f in range(n):
        nks = [len(p[0].new_kf_slots) for p in pairs]
        front.track(
            [(scenes[s].render(f), scenes[s].render(f, right=True)) for s in range(S)],
            imu=[dt_rows(all_bins[s], f) for s in range(S)],
        )
        for s, (trk, mapper) in enumerate(pairs):
            run_kf(trk, mapper, nks[s])
    front.flush()

    for s, (trk, _) in enumerate(pairs):
        batched = trk.trajectory()
        assert len(batched) == len(solo[s]) == n
        np.testing.assert_allclose(batched, solo[s], atol=2e-3)
        ate = trajectory.ate_rmse(batched, scenes[s].poses_c2w[:n], align=False)
        assert ate < 0.06, (s, ate)
