"""End-to-end tests of the VSlamSystem facade — the user-facing entry
path (reference VSlamSystem, src/System.cpp:6-124): config-driven
construction (rectified KITTI-style and unrectified EuRoC-style rigs),
track_stereo in sync and async-BA modes, track_mono_imu with the gravity
init and the mono init-triangulation handoff, and trajectory parity with
the direct tracker+mapper loop."""

import numpy as np
import pytest

from vslam_tpu.models import local_mapper, map_state, system, tracker
from vslam_tpu.utils import datasets, synthetic, trajectory
from vslam_tpu.utils.config import ConfigFile, SlamMode

W, H = 320, 240
FX, CX, CY = 460.0, W / 2.0, H / 2.0
BL = 0.12


def _params():
    # same shapes as tests/test_tracking.py so compiled programs are shared
    return tracker.TrackerParams(
        n_features=512, n_levels=4, active_size=1024, spawn_per_kf=256,
        kf_min_stereo=60,
    )


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(
        n_frames=12, n_points=400, width=W, height=H, fps=10.0, seed=7
    )


def _write_config(tmp_path, slam_mode: int, rectified: bool = True) -> str:
    """A config in the reference's exact YAML schema
    (reference config/config_kitti_00.yaml, config/config_MH_01.yaml)
    whose intrinsics match the synthetic scene."""
    cam = f"fx: {FX}\n  fy: {FX}\n  cx: {CX}\n  cy: {CY}"
    kmat = (
        "rows: 3\n    cols: 3\n    data: "
        f"[{FX}, 0.0, {CX}, 0.0, {FX}, {CY}, 0.0, 0.0, 1.0]"
    )
    pmat = (
        "rows: 3\n    cols: 4\n    data: "
        f"[{FX}, 0.0, {CX}, 0.0, 0.0, {FX}, {CY}, 0.0, 0.0, 0.0, 1.0, 0.0]"
    )
    dkrp = ""
    if not rectified:
        # EuRoC-style D/K/R/P blocks; zero distortion + identity R so the
        # remap is a pass-through and accuracy can be compared with the
        # rectified run (reference src/Camera.cpp:65-119 path)
        dkrp = f"""
  D:
    rows: 1
    cols: 5
    data: [0.0, 0.0, 0.0, 0.0, 0.0]
  K:
    {kmat}
  R:
    rows: 3
    cols: 3
    data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
  P:
    {pmat}"""
    text = f"""rectified: {str(rectified).lower()}
slamMode: {slam_mode}
dataset: "KITTI"
imagesPath: "/nonexistent"
fileExtension: ".png"
Camera:
  width: {W}
  height: {H}
  fps: 10.0
  bl: {BL}
Camera_l:
  {cam}{dkrp}
Camera_r:
  {cam}{dkrp}
FE:
  nFeatures: 512
  nLevels: 4
  imScale: 1.2
  edgeThreshold: 19
  maxFastThreshold: 20
  minFastThreshold: 7
IMU:
  Hz: 200
  gyroscope_noise_density: 1.7e-4
  accelerometer_noise_density: 2.0e-3
  gyroscope_random_walk: 1.9e-5
  accelerometer_random_walk: 3.0e-3
"""
    p = tmp_path / f"config_mode{slam_mode}_{'rect' if rectified else 'unrect'}.yaml"
    p.write_text(text)
    return str(p)


def _run_system(sys_, scene, n, imu_bins=None):
    for f in range(n):
        imu = imu_bins[f] if imu_bins is not None else None
        sys_.track_stereo(scene.render(f), scene.render(f, right=True), imu=imu)
    sys_.exit()
    return sys_.trajectory()


def test_sync_system_matches_direct_loop(tmp_path, scene):
    """The facade's sync path must produce the same trajectory as wiring
    tracker+mapper by hand — one bad index here invalidates every dataset
    run."""
    n = 12
    conf = ConfigFile(_write_config(tmp_path, slam_mode=1))
    assert conf.slam_mode == SlamMode.STEREO and conf.rectified
    sys_ = system.VSlamSystem(
        conf, lm_capacity=8192, kf_capacity=64, tracker_params=_params()
    )
    poses_sys = _run_system(sys_, scene, n)

    # direct loop with identical components
    params = _params()
    world = map_state.WorldMap(lm_capacity=8192, kf_capacity=64, keys_per_kf=512)
    trk = tracker.StereoTracker(
        scene.K.astype(np.float32), BL, W, H, world, params
    )
    mapper = local_mapper.LocalMapper(
        world, scene.K.astype(np.float32), BL,
        local_mapper.LocalMapperConfig(n_levels=4, scale=1.2),
    )
    for f in range(n):
        n_kf = len(trk.new_kf_slots)
        trk.track(scene.render(f), scene.render(f, right=True))
        if len(trk.new_kf_slots) > n_kf and trk.new_kf_slots[-1] > 0:
            r = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])
    poses_direct = trk.trajectory()

    assert len(poses_sys) == n
    np.testing.assert_allclose(poses_sys, poses_direct, atol=1e-4)
    ate = trajectory.ate_rmse(poses_sys, scene.poses_c2w[:n], align=False)
    assert ate < 0.03, ate


def test_async_ba_system(tmp_path, scene):
    """async_ba=True: BA dispatched to the device queue, consumed
    ba_latency_frames later (the reference LocalMapper thread's role,
    src/System.cpp:18-19). Trajectory must stay accurate and complete."""
    n = 12
    conf = ConfigFile(_write_config(tmp_path, slam_mode=1))
    sys_ = system.VSlamSystem(
        conf, async_ba=True, lm_capacity=8192, kf_capacity=64,
        tracker_params=_params(),
    )
    poses = _run_system(sys_, scene, n)
    assert len(poses) == n
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:n], align=False)
    assert ate < 0.03, ate
    assert sys_._pending_ba is None  # exit() drained the in-flight BA


def test_unrectified_euroc_style_rig(tmp_path, scene):
    """Unrectified config (D/K/R/P blocks): the facade builds the remap
    tables and rectifies every frame on device. With zero distortion and
    identity R the remap is a pass-through, so the trajectory must match
    the rectified run's accuracy (reference src/Camera.cpp:65-119,
    src/VIOSlam.cpp:282-306)."""
    n = 10
    conf = ConfigFile(_write_config(tmp_path, slam_mode=1, rectified=False))
    assert not conf.rectified
    sys_ = system.VSlamSystem(
        conf, lm_capacity=8192, kf_capacity=64, tracker_params=_params()
    )
    assert sys_._maps is not None, "unrectified rig must build remap tables"
    poses = _run_system(sys_, scene, n)
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:n], align=False)
    assert ate < 0.03, ate


def test_stereo_imu_gravity_init_mechanism(tmp_path, scene):
    """One-time gravity init from the first accel sample with the
    reference's EuRoC-mounting axis permutation {a_y, -a_x, a_z}
    (src/VIOSlam.cpp:274) — applied exactly once, on the first IMU batch."""
    conf = ConfigFile(_write_config(tmp_path, slam_mode=0))
    assert conf.slam_mode == SlamMode.STEREO_IMU
    sys_ = system.VSlamSystem(
        conf, lm_capacity=8192, kf_capacity=64, tracker_params=_params()
    )
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)
    # frame 0 has no preceding IMU interval — the init fires on the first
    # non-empty batch
    sys_.track_stereo(scene.render(0), scene.render(0, right=True), imu=bins[0])
    assert not sys_._gravity_set
    sys_.track_stereo(scene.render(1), scene.render(1, right=True), imu=bins[1])
    a = bins[1][0, 4:7]
    expect = np.array([a[1], -a[0], a[2]], np.float32)
    assert sys_._gravity_set
    np.testing.assert_allclose(
        np.asarray(sys_.tracker.imu_cfg.gravity_w), expect, atol=1e-6
    )
    # a later batch must NOT re-init
    sys_.tracker.set_gravity(np.array([0.0, 0.0, -9.81]))
    sys_.track_stereo(scene.render(2), scene.render(2, right=True), imu=bins[2])
    np.testing.assert_allclose(
        np.asarray(sys_.tracker.imu_cfg.gravity_w),
        np.array([0.0, 0.0, -9.81], np.float32), atol=1e-6,
    )
    sys_.exit()


def test_stereo_imu_system_tracks(tmp_path, scene):
    """Full visual-inertial run through the facade: IMU rows with absolute
    timestamps are re-cut into per-sample dt rows (first-sample 1/Hz
    fallback, reference src/FeatureTracker.cpp:337-350) and fused by the
    tracker. The synthetic body frame is NOT EuRoC-mounted, so the
    reference's permutation init doesn't apply — gravity is overridden
    with the scene's true vector (what the permutation computes for
    EuRoC's sensor mounting)."""
    n = 10
    conf = ConfigFile(_write_config(tmp_path, slam_mode=0))
    sys_ = system.VSlamSystem(
        conf, lm_capacity=8192, kf_capacity=64, tracker_params=_params()
    )
    sys_._gravity_set = True  # see docstring
    sys_.tracker.set_gravity(synthetic.GRAVITY_W.astype(np.float32))
    sys_.tracker.velocity = scene.velocities[0].astype(np.float32)
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)
    poses = _run_system(sys_, scene, n, imu_bins=bins)
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:n], align=False)
    assert ate < 0.08, ate


@pytest.fixture(scope="module")
def mono_scene():
    """Mono-friendly world: LATERAL strafing motion (every landmark gets
    real parallax; forward motion gives near-zero parallax at the image
    center and outruns its own near-field map within frames) and the
    alias-resistant distinct texture (wide mono search radii flood with
    false candidates on the classic texture's clustered descriptors)."""
    return synthetic.make_scene(
        n_frames=30, n_points=500, width=W, height=H, fps=10.0, seed=7,
        texture="distinct", motion="lateral",
    )


def test_mono_imu_system(tmp_path, mono_scene):
    """Monocular-inertial through the facade (reference TrackMonoIMU,
    src/System.cpp:82-85): bootstrap KFs, the init-triangulation handoff
    to the mapper (system.py dispatches find_new_points and merges the new
    landmarks into the tracked set), then steady-state tracking.

    Gates on REAL visual tracking, not dead-reckoning: the exact
    synthetic IMU can hold ATE alone, so the old ATE-only assert passed
    while steady-state matching returned zero inliers (mono was in fact
    broken). Now: sustained
    inliers, per-KF landmark growth, AND a tight ATE."""
    scene = mono_scene
    n = 30
    conf = ConfigFile(_write_config(tmp_path, slam_mode=2))
    # mono needs a deeper feature budget than the 512 the stereo tests
    # share: at 512 the per-frame top-k corner selection flickers on this
    # texture (~45% redetection), landmark re-observation starves, and
    # steady state sits on a knife edge (A/B'd: 512 decays 90->0
    # inliers by frame 28; 1024 holds 80-100 indefinitely)
    params = tracker.TrackerParams(
        n_features=1024, n_levels=4, active_size=2048, spawn_per_kf=256,
        kf_min_stereo=60,
    )
    sys_ = system.VSlamSystem(
        conf, lm_capacity=8192, kf_capacity=64, tracker_params=params
    )
    assert isinstance(sys_.tracker, tracker.MonoTracker)
    # reference mono re-acquisition parity (src/FeatureTracker.cpp:1400,
    # src/FeatureMatcher.cpp:442-447): schedule tops out at 1200 px with
    # +50/+0.1 relaxed thresholds
    assert float(np.asarray(sys_.tracker._radii)[-1]) == 1200.0
    assert sys_.tracker._desc_thr == params.desc_thr + 50.0
    assert abs(sys_.tracker._ratio - min(params.ratio + 0.1, 0.95)) < 1e-6
    sys_._gravity_set = True  # synthetic body frame; see stereo-IMU test
    sys_.tracker.set_gravity(synthetic.GRAVITY_W.astype(np.float32))
    sys_.tracker.velocity = scene.velocities[0].astype(np.float32)
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)
    inliers = []
    for f in range(n):
        sys_.track_mono_imu(scene.render(f), imu=bins[f])
        s_ = sys_.tracker.last_stats
        if s_:
            inliers.append(s_.get("n_inliers", 0))
    sys_.exit()
    assert sys_.tracker.initialized
    assert not sys_.tracker.needs_init_triangulation
    assert sys_.world.n_landmarks > 200, "mono mapping did not grow the map"
    # steady state genuinely TRACKS: second half of the run averages a
    # healthy inlier count and never goes lost
    tail = inliers[len(inliers) // 2 :]
    assert min(tail) > 20 and float(np.mean(tail)) > 40, inliers
    poses = sys_.trajectory()
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:n], align=False)
    assert ate < 0.05, ate


def test_sharded_facade_matches_unsharded(tmp_path, scene):
    """VSlamSystem(shards=8) runs the local BA SHARDED over the virtual
    8-device mesh through the USER-FACING path (the facade and driver
    build the mesh) and
    must reproduce the unsharded facade trajectory."""
    n = 12
    conf = ConfigFile(_write_config(tmp_path, slam_mode=1))
    sys_u = system.VSlamSystem(
        conf, lm_capacity=8192, kf_capacity=64, tracker_params=_params()
    )
    poses_u = _run_system(sys_u, scene, n)

    sys_s = system.VSlamSystem(
        conf, lm_capacity=8192, kf_capacity=64, tracker_params=_params(),
        shards=8,
    )
    assert sys_s.mapper.mesh is not None
    assert sys_s.mapper._sharded is not None
    poses_s = _run_system(sys_s, scene, n)

    assert len(poses_s) == n
    # same trajectory up to float reduction order in the psum'd Schur
    # assembly (the sharded kernel is the same program, slab-split)
    np.testing.assert_allclose(poses_s, poses_u, atol=2e-3)
    ate = trajectory.ate_rmse(poses_s, scene.poses_c2w[:n], align=False)
    assert ate < 0.03, ate


def test_save_trajectory_formats(tmp_path, scene):
    """KITTI 3x4 + TUM trajectory writers through the facade (reference
    saveTrajectoryAndPosition, src/System.cpp:87-124)."""
    n = 6
    conf = ConfigFile(_write_config(tmp_path, slam_mode=1))
    sys_ = system.VSlamSystem(
        conf, lm_capacity=8192, kf_capacity=64, tracker_params=_params()
    )
    _run_system(sys_, scene, n)
    out = str(tmp_path / "traj.txt")
    sys_.save_trajectory(out, times=scene.times[:n])
    rows = np.loadtxt(out)
    assert rows.shape == (n, 12)
    # row f is the 3x4 of pose f
    poses = sys_.trajectory()
    np.testing.assert_allclose(
        rows.reshape(n, 3, 4), poses[:, :3, :], atol=1e-5
    )
    tum = np.loadtxt(out + ".tum")
    assert tum.shape == (n, 8)


def test_facade_loop_closure_smoke(tmp_path, scene):
    """loop_closure=True wires a LoopCloser and runs detection after
    every keyframe's BA without disturbing a loop-free run (detection
    returns None; trajectory unchanged semantics). The closure math
    itself is covered by tests/test_loop_closure.py."""
    n = 10
    conf = ConfigFile(_write_config(tmp_path, slam_mode=1))
    sys_ = system.VSlamSystem(
        conf, lm_capacity=8192, kf_capacity=64, tracker_params=_params(),
        loop_closure=True,
    )
    assert sys_.loop_closer is not None
    poses = _run_system(sys_, scene, n)
    assert sys_.loop_closer.closures == 0  # nothing to close, nothing broken
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:n], align=False)
    assert ate < 0.03, ate
