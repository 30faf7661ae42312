"""Compare tracked frames/s at pipeline depth 1 vs 2 (no BA) on the live
device, with per-frame time percentiles — isolates the steady-state frame
cost from BA/KF interference."""

import time

import numpy as np


_CACHE = {}


def run(depth: int, n_frames: int = 36):
    import jax

    from vslam_tpu.models import map_state, tracker
    from vslam_tpu.utils import synthetic

    if "scene" not in _CACHE:
        scene = synthetic.make_scene(
            n_frames=n_frames, n_points=900, width=752, height=480, fps=20.0, seed=3
        )
        _CACHE["scene"] = scene
        _CACHE["frames"] = [
            (scene.render(f).astype(np.uint8), scene.render(f, right=True).astype(np.uint8))
            for f in range(n_frames)
        ]
    scene, frames = _CACHE["scene"], _CACHE["frames"]
    params = tracker.TrackerParams(
        n_features=1024, n_levels=8, active_size=4096, pipeline_depth=depth
    )
    world = map_state.WorldMap(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=1024)
    trk = tracker.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, scene.width, scene.height,
        world, params,
    )
    for f in range(10):
        trk.track(*frames[f])
    ts = []
    for f in range(10, n_frames):
        t0 = time.perf_counter()
        trk.track(*frames[f])
        ts.append((time.perf_counter() - t0) * 1000)
    trk.flush()
    ts = np.array(ts)
    kf = len(trk.new_kf_slots)
    print(
        f"depth={depth}: p50={np.percentile(ts,50):6.1f} ms  p90={np.percentile(ts,90):6.1f} ms "
        f"mean={ts.mean():6.1f} ms -> {1000/ts.mean():5.1f} fps  (KFs={kf})"
    )


def main():
    import jax

    from vslam_tpu.utils import compile_cache

    compile_cache.setup()
    print("devices:", jax.devices())
    run(1)
    run(2)


if __name__ == "__main__":
    main()
