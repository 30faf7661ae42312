"""Benchmark: tracked frames/s on one chip, full SLAM loop.

Runs the complete stereo tracking pipeline (pyramid/FAST/BRIEF extraction
x2, stereo matching, landmark projection matching, motion-only LM, KF
insertion + local BA) on an EuRoC-sized synthetic sequence and reports
steady-state tracked frames/s on the available device. Also measures a
KITTI-geometry variant (2048 features on a 1248x384 frame — the
reference's KITTI configs run 2000 features at 1241x376,
config/config_kitti_00.yaml:3,49) and dedicated local-BA solves/s
(BASELINE.json metric list), plus the per-stage StageTimer breakdown.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
vs_baseline is against the reference's implied real-time rate on its
EuRoC configs (20 fps capture, config_MH_01.yaml:97) — the reference
publishes no measured numbers (BASELINE.md), so its design target is the
comparison point.
"""

import json
import os
import time

import numpy as np


def _render_frames(scene, n_frames, cache_key):
    """Pre-render all frames (host-side input, excluded from timing);
    uint8 like a real camera feed — cast to f32 happens on device. The
    renders are deterministic in the scene parameters, so they are cached
    on disk: rendering 80 EuRoC-sized frames costs ~60 s of host time the
    driver's bench budget should not pay twice."""
    cache_dir = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".bench_cache"
    )
    path = os.path.join(cache_dir, f"{cache_key}.npz")
    if os.path.exists(path):
        stack = np.load(path)["frames"]  # (n, 2, H, W) uint8
        if stack.shape[0] == n_frames:
            return [(stack[f, 0], stack[f, 1]) for f in range(n_frames)]
    frames = [
        (
            scene.render(f).astype(np.uint8),
            scene.render(f, right=True).astype(np.uint8),
        )
        for f in range(n_frames)
    ]
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(
        path, frames=np.stack([np.stack(fr) for fr in frames])
    )
    return frames


def run_pipeline(scene, params, n_frames, warmup, cache_key):
    """Full tracking + async local-BA loop; returns (fps, ate, trk, mapper)."""
    from vslam_tpu.models import local_mapper, map_state, tracker
    from vslam_tpu.utils import trajectory

    world = map_state.WorldMap(
        lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=params.n_features
    )
    trk = tracker.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, scene.width, scene.height,
        world, params,
    )
    mapper = local_mapper.LocalMapper(
        world, scene.K.astype(np.float32), scene.baseline,
        local_mapper.LocalMapperConfig(n_levels=params.n_levels, scale=params.scale),
    )

    import jax.numpy as jnp

    # stage every frame pair on device ahead of the loop (the native
    # prefetcher's role in the driver: keep the device fed so the timed
    # loop never pays a host->device image upload)
    frames = [
        jnp.asarray(np.stack(fr)) for fr in _render_frames(scene, n_frames, cache_key)
    ]

    # async local BA (the role of the reference's LocalMapper thread,
    # src/System.cpp:18-19): the whole mapping pipeline is DISPATCHED to the
    # device queue at the KF and its result blobs are consumed one frame
    # later, when their host copies have landed — tracking never blocks on
    # BA latency and no host thread fights the GIL
    pending_ba = [None, -10]  # (handle, dispatch frame)
    BA_LATENCY = 2  # frames to let the async chain age before the fetch
    BA_MAX_LATENCY = 8  # readiness-poll ceiling (mirrors VSlamSystem)

    def consume_ba(f, force=False):
        if pending_ba[0] is None:
            return
        if not force:
            age = f - pending_ba[1]
            if age < BA_LATENCY:
                return
            # publish triangulated landmarks early (mirrors VSlamSystem)
            trk.add_active(mapper.consume_triangulation(pending_ba[0]))
            # past the minimum age, keep deferring while the background
            # prefetch has not landed the result blobs (the blocking
            # fetch mid-chain was the r4 p90 tail); the device-resident
            # map itself was already updated at dispatch
            if age < BA_MAX_LATENCY and not local_mapper.pending_ready(
                pending_ba[0]
            ):
                return
        r = mapper.finish(pending_ba[0])
        pending_ba[0] = None
        trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
        trk.add_active(r["new_lm_ids"])

    def step(f):
        consume_ba(f)
        n_kf = len(trk.new_kf_slots)
        trk.track(frames[f])
        if pending_ba[0] is not None:
            # phase B of a staged BA dispatches BEHIND this frame's step
            pending_ba[0] = mapper.advance(pending_ba[0])
        if len(trk.new_kf_slots) > n_kf and trk.new_kf_slots[-1] > 0:
            consume_ba(f, force=True)  # at most one BA in flight
            pending_ba[0] = mapper.run_async_staged(trk.new_kf_slots[-1])
            pending_ba[1] = f

    for f in range(warmup):
        n_kf = len(trk.new_kf_slots)
        trk.track(frames[f])
        # warmup runs the mapper SYNCHRONOUSLY so its programs compile
        # before the timed section (a first-call compile inside the timed
        # loop would stall the BA chain for seconds, starving the tracker
        # of triangulated landmarks)
        if len(trk.new_kf_slots) > n_kf and trk.new_kf_slots[-1] > 0:
            r = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])

    t0 = time.perf_counter()
    for f in range(warmup, n_frames):
        step(f)
    trk.flush()
    consume_ba(n_frames, force=True)
    dt = time.perf_counter() - t0
    fps = (n_frames - warmup) / dt

    poses = trk.trajectory()
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[: len(poses)], align=False)
    return fps, float(ate), trk, mapper


def measure_ba_solves(trk, mapper, n=6):
    """Dedicated local-BA throughput: back-to-back synchronous solves of
    the live window around the newest keyframe (solves/s, a BASELINE.json
    metric). Each solve is the full pipeline: triangulation dispatch,
    window assembly, fused 2-round Schur BA, write-back, host fetch."""
    slots = [s for s in trk.new_kf_slots if s > 0]
    if not slots:
        return 0.0
    slot = slots[-1]
    mapper.run(slot)  # ensure compiled outside the timed region
    t0 = time.perf_counter()
    for _ in range(n):
        mapper.run(slot)
    return n / (time.perf_counter() - t0)


def run_mono_pipeline(n_frames=60, warmup=12):
    """Monocular-inertial tracking fps + ATE on a lateral-motion scene
    (the regime mono init needs — forward motion gives near-zero central
    parallax; reference mono mode targets the EuRoC drone sequences)."""
    import numpy as np

    from vslam_tpu.models import local_mapper, map_state, tracker
    from vslam_tpu.utils import datasets, synthetic, trajectory

    scene = synthetic.make_scene(
        n_frames=n_frames, n_points=900, width=752, height=480, fps=20.0,
        seed=11, texture="distinct", motion="lateral",
    )
    world = map_state.WorldMap(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=1024)
    params = tracker.TrackerParams(n_features=1024, n_levels=8, active_size=4096)
    imu_cfg = tracker.ImuConfig(
        gyro_noise=1.7e-4, accel_noise=2e-3, gyro_walk=1.9e-5, accel_walk=3e-3,
        hz=200.0, T_bc=np.eye(4, dtype=np.float32),
        gravity_w=synthetic.GRAVITY_W.astype(np.float32),
    )
    trk = tracker.MonoTracker(
        scene.K.astype(np.float32), scene.width, scene.height, world, params,
        imu_cfg=imu_cfg,
    )
    trk.velocity = scene.velocities[0].astype(np.float32)
    mapper = local_mapper.LocalMapper(
        world, scene.K.astype(np.float32), 0.0,
        local_mapper.LocalMapperConfig(n_levels=params.n_levels, scale=params.scale),
    )
    bins = datasets.bin_imu_per_frame(scene.imu, scene.times)

    def dt_rows(f):
        rows = bins[f]
        if rows is None or len(rows) == 0:
            return None
        t = rows[:, 0]
        dts = np.diff(np.concatenate([[t[0] - 1.0 / 200.0], t]))
        return np.concatenate(
            [np.maximum(dts, 0)[:, None], rows[:, 1:7]], axis=1
        ).astype(np.float32)

    frames = _render_frames(scene, n_frames, "mono_752x480_s11_f60_lat")

    def step(f):
        nk = len(trk.new_kf_slots)
        trk.track(frames[f][0], imu=dt_rows(f))
        if getattr(trk, "needs_init_triangulation", False):
            ids = mapper.find_new_points(trk.new_kf_slots[-1], mono=True)
            trk.add_active(ids)
            trk.needs_init_triangulation = False
            trk.last_kf_tracked = max(len(ids), 1)
        elif len(trk.new_kf_slots) > nk and trk.new_kf_slots[-1] > 0:
            ids = mapper.find_new_points(trk.new_kf_slots[-1], mono=True)
            trk.add_active(ids)

    for f in range(warmup):
        step(f)
    t0 = time.perf_counter()
    for f in range(warmup, n_frames):
        step(f)
    trk.flush()
    fps = (n_frames - warmup) / (time.perf_counter() - t0)
    poses = trk.trajectory()
    from vslam_tpu.utils import trajectory as traj

    ate = traj.ate_rmse(poses, scene.poses_c2w[: len(poses)], align=False)
    return fps, float(ate)


def run_loop_circuit(n_frames=360):
    """Drive the closed-circuit scene through the facade with loop
    closure on; returns (closures fired, final ATE after the pose-graph
    corrections)."""
    import tempfile
    import pathlib

    import numpy as np

    from vslam_tpu.models import system as system_mod
    from vslam_tpu.utils import synthetic, trajectory
    from vslam_tpu.utils.config import ConfigFile

    W, H = 512, 384
    loops, wall_radius = 1.2, 10.0
    scene = synthetic.make_loop_scene(
        n_frames=n_frames, width=W, height=H, loops=loops,
        wall_radius=wall_radius,
    )
    # cache key encodes every scene parameter the render depends on —
    # a parameter change can never silently reuse stale frames
    cache_key = (
        f"loop_{W}x{H}_s0_f{n_frames}_l{int(loops * 10)}_wr{int(wall_radius)}"
    )
    cfg = pathlib.Path(tempfile.mkdtemp()) / "c.yaml"
    cfg.write_text(f"""rectified: true
slamMode: 1
dataset: "KITTI"
imagesPath: "/x"
fileExtension: ".png"
Camera: {{width: {W}, height: {H}, fps: 10.0, bl: 0.12}}
Camera_l: {{fx: 460.0, fy: 460.0, cx: {W/2}, cy: {H/2}}}
Camera_r: {{fx: 460.0, fy: 460.0, cx: {W/2}, cy: {H/2}}}
FE: {{nFeatures: 1024, nLevels: 8, imScale: 1.2, edgeThreshold: 19, maxFastThreshold: 20, minFastThreshold: 7}}
""")
    from vslam_tpu.models import tracker as tracker_mod

    # active set smaller than the map: forces the loop-closure path (a
    # roomy active set re-acquires the lap-start landmarks directly and
    # the detector correctly stays idle — see tests/test_loop_closure)
    sys_ = system_mod.VSlamSystem(
        ConfigFile(str(cfg)), async_ba=True, lm_capacity=1 << 15,
        kf_capacity=256, loop_closure=True,
        tracker_params=tracker_mod.TrackerParams(
            n_features=1024, n_levels=8, active_size=1024
        ),
    )
    # the circuit section reports ATE, not fps: consume at a FIXED
    # latency so keyframe cadence and closure timing are deterministic
    # (readiness polling varies run-to-run with thread timing — measured
    # ATE spread 0.058-0.134 on identical settings without this)
    sys_.deterministic_ba_latency = True
    frames = _render_frames(scene, n_frames, cache_key)
    for f in range(n_frames):
        sys_.track_stereo(frames[f][0], frames[f][1])
    sys_.exit()
    poses = sys_.trajectory()
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[: len(poses)], align=False)
    # the driver's normal final step (--global-ba): one full-map polish
    # after the sequence — reported separately from the live number
    sys_.global_ba()
    poses2 = sys_.trajectory()
    ate_gba = trajectory.ate_rmse(
        poses2, scene.poses_c2w[: len(poses2)], align=False
    )
    return int(sys_.loop_closer.closures), float(ate), float(ate_gba)


def main():
    # wall-clock budget (round 2 lesson: the driver's bench slot timed out
    # at 9.5 min and recorded NO number — rc 124, parsed null; a slow
    # optional tail must never zero the primary metric again). The KITTI
    # variant runs only if the budget allows, and the ONE JSON line is
    # printed even if an optional section dies.
    t_start = time.perf_counter()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "330"))
    # per-section wall clocks ride in extra["section_wall_s"] so a skipped
    # section can be diagnosed from the recorded JSON alone (which section
    # ate the budget), without rerunning the bench
    section_wall = {}
    _last_mark = [time.perf_counter()]

    def _mark(name):
        now = time.perf_counter()
        section_wall[name] = round(now - _last_mark[0], 1)
        _last_mark[0] = now

    from vslam_tpu.utils import compile_cache

    compile_cache.setup()
    from vslam_tpu.models import tracker
    from vslam_tpu.utils import synthetic

    # --- EuRoC geometry (the primary metric: 752x480, 20 fps capture) ---
    # MEDIAN OF 3 runs (one sample cannot tell run-to-run variance from
    # a real regression; the median with min/max reported is
    # noise-robust). Repeats are budget-gated so a slow run degrades to
    # fewer samples, never to a missing number.
    n_frames, warmup = 80, 12
    scene = synthetic.make_scene(
        n_frames=n_frames, n_points=900, width=752, height=480, fps=20.0, seed=3
    )
    params = tracker.TrackerParams(n_features=1024, n_levels=8, active_size=4096)
    runs = []
    for rep in range(3):
        runs.append(
            run_pipeline(scene, params, n_frames, warmup, "euroc_752x480_s3_f80")
        )
        # first run pays any cold compiles; stop repeating if the budget
        # cannot fit another repeat plus the optional sections (~190 s)
        if time.perf_counter() - t_start > budget_s - 190:
            break
    _mark("euroc")
    fps_samples = sorted(r[0] for r in runs)
    fps = fps_samples[len(fps_samples) // 2]  # median
    ate, trk, mapper = runs[-1][1], runs[-1][2], runs[-1][3]
    extra = {
        "fps_samples": [round(v, 2) for v in fps_samples],
        "ate_rmse_m_synthetic": round(ate, 4),
        "n_keyframes": trk.world.n_keyframes,
        "n_landmarks": trk.world.n_landmarks,
        "ba_runs": mapper.ba_count,
    }
    try:
        extra["local_ba_solves_per_s"] = round(measure_ba_solves(trk, mapper), 2)
        track_stats = trk.metrics.summary().get("track", {})
        extra["track_ms_p50"] = track_stats.get("p50_ms")
        extra["track_ms_p90"] = track_stats.get("p90_ms")
        _mark("ba_solves")

        # --- loop-closure circuit (detection + pose-graph correction
        # exercised through the LIVE pipeline) ---
        # runs FIRST among the optional sections: it is the newest
        # capability and its first-compile cost must not be starved
        # by the perf variants
        if time.perf_counter() - t_start < budget_s - 120:
            closures, ate_lc, ate_lc_gba = run_loop_circuit()
            extra["loop_closures"] = closures
            extra["loop_circuit_ate_rmse_m"] = round(ate_lc, 4)
            extra["loop_circuit_ate_post_gba_m"] = round(ate_lc_gba, 4)
            _mark("loop")
        else:
            extra["loop_skipped"] = "over time budget"
        # --- KITTI geometry (reference: 2000 features @ 1241x376, 10 fps;
        # padded to 1248x384).
        # Each optional section starts only with headroom for its own
        # cost, so the TOTAL wall stays bounded (round-2 lesson: the
        # driver's bench slot timed out and recorded no number) ---
        if time.perf_counter() - t_start < budget_s - 60:
            nk, wk = 40, 10
            scene_k = synthetic.make_scene(
                n_frames=nk, n_points=900, width=1248, height=384, fps=10.0, seed=5
            )
            params_k = tracker.TrackerParams(
                n_features=2048, n_levels=8, active_size=4096
            )
            fps_kitti, ate_kitti, _, _ = run_pipeline(
                scene_k, params_k, nk, wk, "kitti_1248x384_s5_f40"
            )
            extra["kitti_2048feat_fps"] = round(fps_kitti, 2)
            extra["kitti_vs_10fps_target"] = round(fps_kitti / 10.0, 3)
            extra["kitti_ate_rmse_m"] = round(ate_kitti, 4)
            _mark("kitti")
        else:
            extra["kitti_skipped"] = "over time budget"

        # --- mono-IMU (reference slamMode 2: an fps number and a tight
        # ATE gate) ---
        # headroom 45 s = the measured warm mono cost (~40 s) + margin;
        # the previous 60 s gate skipped mono by 1.8 s on an ordinary
        # warm run (section walls: euroc 142 + loop 75 + kitti 54 = 272)
        if time.perf_counter() - t_start < budget_s - 45:
            fps_m, ate_m = run_mono_pipeline()
            extra["mono_imu_fps"] = round(fps_m, 2)
            extra["mono_imu_ate_rmse_m"] = round(ate_m, 4)
            extra["mono_ate_gate_0p05"] = bool(ate_m <= 0.05)
            _mark("mono")
        else:
            extra["mono_skipped"] = "over time budget"

    except Exception as e:  # still print the metric, then fail below
        extra["optional_section_error"] = repr(e)[:200]

    baseline_fps = 20.0  # EuRoC real-time intent (no published numbers)
    extra["section_wall_s"] = section_wall
    extra["wall_s"] = round(time.perf_counter() - t_start, 1)
    print(
        json.dumps(
            {
                "metric": "tracked_frames_per_s_per_chip",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / baseline_fps, 3),
                "extra": extra,
            }
        )
    )
    if "optional_section_error" in extra:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
