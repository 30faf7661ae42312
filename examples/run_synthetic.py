"""Self-contained end-to-end demo on a rendered synthetic world.

No datasets needed (this is also the verification entry point on
machines without KITTI/EuRoC): renders one of the built-in scenes,
drives the full pipeline — extraction, stereo matching, tracking,
async local BA, optional loop closure / global BA — and prints fps +
ATE against the scene's exact ground truth.

    python examples/run_synthetic.py                 # EuRoC-geometry stereo
    python examples/run_synthetic.py --scene kitti   # KITTI-geometry stereo
    python examples/run_synthetic.py --scene mono    # monocular-inertial
    python examples/run_synthetic.py --scene loop    # closed circuit + loop closure
    python examples/run_synthetic.py --viz map.html  # export the map viewer
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


SCENES = {
    # name: (width, height, fps, n_frames, n_features, description)
    "euroc": (752, 480, 20.0, 80, 1024, "EuRoC-geometry stereo"),
    "kitti": (1248, 384, 10.0, 40, 2048, "KITTI-geometry stereo"),
    "mono": (752, 480, 20.0, 60, 1024, "monocular-inertial (lateral)"),
    "loop": (512, 384, 10.0, 325, 1024, "closed circuit + loop closure"),
}


def _write_config(tmp, W, H, fps, nfeat, slam_mode):
    p = pathlib.Path(tmp) / "config.yaml"
    p.write_text(f"""rectified: true
slamMode: {slam_mode}
dataset: "KITTI"
imagesPath: "/nonexistent"
fileExtension: ".png"
Camera: {{width: {W}, height: {H}, fps: {fps}, bl: 0.12}}
Camera_l: {{fx: 460.0, fy: 460.0, cx: {W / 2}, cy: {H / 2}}}
Camera_r: {{fx: 460.0, fy: 460.0, cx: {W / 2}, cy: {H / 2}}}
FE: {{nFeatures: {nfeat}, nLevels: 8, imScale: 1.2, edgeThreshold: 19, maxFastThreshold: 20, minFastThreshold: 7}}
IMU: {{Hz: 200, gyroscope_noise_density: 1.7e-4, accelerometer_noise_density: 2.0e-3, gyroscope_random_walk: 1.9e-5, accelerometer_random_walk: 3.0e-3, gravity: [0.0, 0.0, -9.81]}}
""")
    return str(p)


def render(scene_name: str = "euroc", n_frames: int = 0):
    """Build `scene_name` and render its frames on the host: (scene,
    frames), frames uint8 like a camera feed (the cast to f32 happens on
    device), stereo pairs or mono images."""
    from vslam_tpu.utils import synthetic

    W, H, fps, n, nfeat, desc = SCENES[scene_name]
    if n_frames:
        n = n_frames
    print(f"[scene] {desc}: {W}x{H} @ {fps} fps, {n} frames, {nfeat} features")
    t0 = time.time()
    if scene_name == "loop":
        scene = synthetic.make_loop_scene(n_frames=n, width=W, height=H, fps=fps)
    elif scene_name == "mono":
        scene = synthetic.make_scene(
            n_frames=n, n_points=900, width=W, height=H, fps=fps, seed=11,
            texture="distinct", motion="lateral",
        )
    else:
        scene = synthetic.make_scene(
            n_frames=n, n_points=900, width=W, height=H, fps=fps,
            seed=3 if scene_name == "euroc" else 5,
        )
    frames = [
        scene.render(f).astype(np.uint8)
        if scene_name == "mono"
        else (
            scene.render(f).astype(np.uint8),
            scene.render(f, right=True).astype(np.uint8),
        )
        for f in range(n)
    ]
    print(f"[scene] built and rendered in {time.time() - t0:.1f}s")
    return scene, frames


def run(
    scene_name: str = "euroc",
    n_frames: int = 0,
    deterministic: bool = False,
    shards=None,
    global_ba: bool = False,
    viz: str | None = None,
    rendered=None,
) -> dict:
    """Drive `scene_name` through VSlamSystem frame by frame and return
    the run's numbers: fps and per-frame latency p50/p90 (host clock
    around each track call; rendering is done before the loop), ATE
    against the exact ground truth, keyframe/landmark/BA counts (local BAs, and how many of them ran
    on the sharded program) and the keyframe poses with their frame indices. `rendered` reuses a
    :func:`render` result; `deterministic` consumes async BA at a fixed
    frame latency (reproducible trajectories); `shards` runs the local BA
    over an N-device mesh."""
    from vslam_tpu.models import system as system_mod
    from vslam_tpu.utils import compile_cache, datasets, trajectory
    from vslam_tpu.utils.config import ConfigFile

    compile_cache.setup()
    W, H, fps, _, nfeat, _ = SCENES[scene_name]
    scene, frames = rendered or render(scene_name, n_frames)
    n = len(frames)
    mono = scene_name == "mono"

    conf = ConfigFile(
        _write_config(tempfile.mkdtemp(), W, H, fps, nfeat, 2 if mono else 1)
    )
    sys_ = system_mod.VSlamSystem(
        conf, async_ba=True, lm_capacity=1 << 15,
        kf_capacity=256 if scene_name == "loop" else 128,
        loop_closure=scene_name == "loop", shards=shards,
    )
    sys_.deterministic_ba_latency = deterministic
    if mono:
        sys_.tracker.velocity = scene.velocities[0].astype(np.float32)
        bins = datasets.bin_imu_per_frame(scene.imu, scene.times)

    per_frame = []
    t0 = time.perf_counter()
    for f in range(n):
        tf = time.perf_counter()
        if mono:
            sys_.track_mono_imu(frames[f], imu=bins[f])
        else:
            sys_.track_stereo(*frames[f])
        per_frame.append(time.perf_counter() - tf)
        if (f + 1) % 50 == 0:
            print(f"  frame {f + 1}/{n}  kfs={sys_.world.n_keyframes}")
    sys_.exit()
    wall = time.perf_counter() - t0
    if global_ba:
        sys_.global_ba()

    poses = sys_.trajectory()
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[: len(poses)], align=False)
    if viz:
        from vslam_tpu.utils import viz as viz_mod

        viz_mod.export_html(viz, sys_.world, poses, active_ids=sys_.tracker.active_ids)
        print(f"[viz] -> {viz}")
    return {
        "size": f"{W}x{H}",
        "frames": n,
        "fps": n / wall,
        "frame_ms_p50": 1e3 * float(np.percentile(per_frame, 50)),
        "frame_ms_p90": 1e3 * float(np.percentile(per_frame, 90)),
        "ate_m": float(ate),
        "keyframes": sys_.world.n_keyframes,
        "landmarks": sys_.world.n_landmarks,
        "local_bas": sys_.mapper.ba_count,
        "sharded_bas": sys_.mapper.counters.get("ba_sharded"),
        "loop_closures": (
            sys_.loop_closer.closures if sys_.loop_closer is not None else None
        ),
        "kf_poses": sys_.world.kf_poses_host[: sys_.world.n_keyframes].copy(),
        "kf_frames": sys_.world.kf_frame_idx[: sys_.world.n_keyframes].copy(),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", choices=sorted(SCENES), default="euroc")
    ap.add_argument("--frames", type=int, default=0, help="override frame count")
    ap.add_argument("--viz", default=None, help="HTML map viewer output path")
    ap.add_argument("--global-ba", action="store_true")
    args = ap.parse_args()

    r = run(args.scene, args.frames, global_ba=args.global_ba, viz=args.viz)
    print(
        f"[result] {r['frames']} frames at {r['fps']:.1f} fps (per-frame "
        f"p50 {r['frame_ms_p50']:.1f} ms, p90 {r['frame_ms_p90']:.1f} ms) | "
        f"ATE RMSE vs exact GT: {r['ate_m']:.4f} m | {r['keyframes']} "
        f"keyframes, {r['landmarks']} landmarks, {r['local_bas']} local BAs"
        + (
            f" | loop closures: {r['loop_closures']}"
            if r["loop_closures"] is not None
            else ""
        )
    )


if __name__ == "__main__":
    main()
