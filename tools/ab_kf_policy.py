"""A/B the keyframe-policy knobs on the bench scenes (measure, don't
argue).

Two knobs, both repo deviations from the reference policy
(src/FeatureTracker.cpp:1262):
- kf_critical_stereo: the low-stereo bypass floor (default 4/5 of
  kf_min_stereo = 64). The r5 coverage-first ANMS lowered steady-state
  stereo-inlier counts into this threshold's band, doubling KF cadence.
- kf_max_interval: the r4 gap ceiling (default 30), suspected in the r4
  fps regression.

Runs the EuRoC bench scene once per variant (warm cache) and prints
fps / ATE / keyframes / BA runs. Usage: python tools/ab_kf_policy.py
"""

import time

import numpy as np


def run_variant(scene, frames_key, crit, max_interval, n_frames=80, warmup=12):
    import bench
    from vslam_tpu.models import tracker

    params = tracker.TrackerParams(
        n_features=1024, n_levels=8, active_size=4096,
        kf_critical_stereo=crit, kf_max_interval=max_interval,
    )
    t0 = time.perf_counter()
    fps, ate, trk, mapper = bench.run_pipeline(
        scene, params, n_frames, warmup, frames_key
    )
    st = trk.metrics.summary().get("track", {})
    return {
        "fps": round(fps, 2),
        "ate": round(ate, 4),
        "kfs": trk.world.n_keyframes,
        "ba_runs": mapper.ba_count,
        "p50": st.get("p50_ms"),
        "p90": st.get("p90_ms"),
        "wall": round(time.perf_counter() - t0, 1),
    }


def main():
    import bench

    from vslam_tpu.utils import compile_cache

    compile_cache.setup()
    from vslam_tpu.utils import synthetic

    scene = synthetic.make_scene(
        n_frames=80, n_points=900, width=752, height=480, fps=20.0, seed=3
    )
    key = "euroc_752x480_s3_f80"
    variants = [
        ("crit=64 gap=30 (r4 defaults)", 64, 30),
        ("crit=48 gap=30", 48, 30),
        ("crit=40 gap=30", 40, 30),
        ("crit=32 gap=30", 32, 30),
        ("crit=48 gap=60", 48, 60),
        ("crit=48 gap=off", 48, 1 << 30),
        ("crit=64 gap=off", 64, 1 << 30),
    ]
    for name, crit, gap in variants:
        r = run_variant(scene, key, crit, gap)
        print(
            f"{name:28s} fps={r['fps']:6.2f} ate={r['ate']:.4f} "
            f"kfs={r['kfs']:3d} ba={r['ba_runs']:3d} "
            f"p50={r['p50']} p90={r['p90']}"
        )


if __name__ == "__main__":
    main()
