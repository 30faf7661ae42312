"""Map capacity growth: long sequences must not hit the round-1 hard
RuntimeError wall (KITTI 00 runs ~4.5k frames / ~900 KFs
against a 512-KF default). Growth is a one-time array reallocation that
preserves all content."""

import numpy as np

from vslam_tpu.models import local_mapper, map_state, tracker
from vslam_tpu.utils import synthetic, trajectory


def test_grow_preserves_content():
    w = map_state.WorldMap(lm_capacity=64, kf_capacity=4, keys_per_kf=32, right_obs_per_kf=8)
    # populate a landmark and a keyframe through the normal paths
    slots = w.alloc_landmarks(3)
    w.arrays = map_state.scatter_landmarks(
        w.arrays,
        np.asarray(slots),
        np.arange(9, dtype=np.float32).reshape(3, 3),
        np.ones((3, 256), np.int8),
        np.full(3, 2.0, np.float32),
        np.full(3, 1.0, np.float32),
        np.ones(3, bool),
    )
    kf = w.alloc_keyframe(0)
    w.kf_obs_lm[kf, :3] = slots
    w.kf_poses_host[kf, 0, 3] = 5.0

    w.grow_landmarks(65)
    w.grow_keyframes(5)
    assert w.lm_capacity == 128 and w.kf_capacity == 8
    assert w.arrays.lm_pos.shape == (128, 3)
    assert w.arrays.obs_lm.shape == (8, 32)
    np.testing.assert_allclose(
        np.asarray(w.arrays.lm_pos[:3]), np.arange(9.0).reshape(3, 3)
    )
    assert np.asarray(w.arrays.lm_valid)[:3].all()
    assert not np.asarray(w.arrays.lm_valid)[3:].any()
    assert w.kf_obs_lm.shape == (8, 32)
    assert (w.kf_obs_lm[kf, :3] == slots).all()
    assert w.kf_poses_host[kf, 0, 3] == 5.0
    # new KF rows are identity poses
    np.testing.assert_allclose(w.kf_poses_host[5], np.eye(4))
    # allocator keeps handing out slots across the old boundary
    more = w.alloc_landmarks(100)
    assert len(more) == 100 and more[0] == 3

    # idempotent when already big enough
    w.grow_landmarks(10)
    assert w.lm_capacity == 128


def test_tracking_survives_growth():
    """Full tracking+BA run that starts with tiny capacities and must grow
    both axes mid-run without losing accuracy."""
    scene = synthetic.make_scene(
        n_frames=14, n_points=400, width=320, height=240, fps=10.0, seed=7
    )
    params = tracker.TrackerParams(
        n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256,
        kf_min_stereo=60,
    )
    # 600 slots: the init KF alone takes 512, the next KF's 256-slot
    # spawn reservation forces a landmark growth
    world = map_state.WorldMap(lm_capacity=600, kf_capacity=2, keys_per_kf=512)
    trk = tracker.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, 320, 240, world, params
    )
    mapper = local_mapper.LocalMapper(
        world, scene.K.astype(np.float32), scene.baseline,
        local_mapper.LocalMapperConfig(n_levels=4, scale=1.2),
    )
    n = 14
    for f in range(n):
        n_kf = len(trk.new_kf_slots)
        trk.track(scene.render(f), scene.render(f, right=True))
        if len(trk.new_kf_slots) > n_kf and trk.new_kf_slots[-1] > 0:
            r = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])
    poses = trk.trajectory()
    assert world.kf_capacity > 2, "keyframe axis never grew"
    assert world.lm_capacity > 600, "landmark axis never grew"
    assert world.n_keyframes > 2
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:n], align=False)
    assert ate < 0.03, ate
