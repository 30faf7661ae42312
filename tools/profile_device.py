"""Blocked wall times of the dominant device programs.

Times the track step, the fused local BA and the keyframe triangulation
with block_until_ready on the host clock (the device trace in
utils/metrics.trace gives the per-kernel split).

    python tools/profile_device.py
"""

import time

import numpy as np


def timeit(fn, n=10, warmup=2):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / n * 1000.0


def main():
    import jax

    from vslam_tpu.utils import compile_cache

    compile_cache.setup()
    import jax.numpy as jnp

    from vslam_tpu.models import local_mapper, map_state, tracker
    from vslam_tpu.utils import synthetic

    print("devices:", jax.devices())

    scene = synthetic.make_scene(
        n_frames=24, n_points=900, width=752, height=480, fps=20.0, seed=3
    )
    params = tracker.TrackerParams(n_features=1024, n_levels=8, active_size=4096)
    world = map_state.WorldMap(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=1024)
    trk = tracker.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, scene.width, scene.height,
        world, params,
    )
    mapper = local_mapper.LocalMapper(world, scene.K.astype(np.float32), scene.baseline)
    frames = [
        (scene.render(f).astype(np.uint8), scene.render(f, right=True).astype(np.uint8))
        for f in range(24)
    ]
    for f in range(8):
        n_kf = len(trk.new_kf_slots)
        trk.track(*frames[f])
        if len(trk.new_kf_slots) > n_kf and trk.new_kf_slots[-1] > 0:
            r = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])
    trk.flush()

    p = trk.params
    LR = jnp.asarray(np.stack(frames[9]))
    state0 = trk._state

    def track_step():
        st = {k: (jnp.array(v) if k in ("pose", "prev_pose", "vel", "bias") else v)
              for k, v in state0.items()}
        # re-gather active (donated buffers must be fresh each call)
        st["active"] = trk._gather_active_dev()
        st["miss_age"] = jnp.asarray(trk.miss_age, jnp.int32)
        _, outputs = tracker._track_step(
            LR, st, trk._imu_dummy, trk._imu_const, trk._radii,
            jnp.float32(p.refine_radius), jnp.float32(p.desc_thr), jnp.float32(p.ratio),
            trk.K, trk.baseline, trk.scale_factors, trk._static,
            trk.width, trk.height, p.n_levels, p.min_inliers,
            mono=False, has_imu=False,
        )
        return outputs["blob"]

    t_track = timeit(track_step, n=8)
    print(f"track_step blocked: {t_track:7.2f} ms")

    # fused local BA (assemble once, run the fused program repeatedly)
    slot = trk.new_kf_slots[-1]
    prob = mapper._assemble(slot)[0]
    from vslam_tpu.ops import schur

    def ba():
        p2, err, kill = schur.local_ba_two_rounds(prob, iters1=5, iters2=10)
        return err

    t_ba = timeit(ba, n=5)
    print(f"local_ba fused    : {t_ba:7.2f} ms")

    # triangulation program (warm up first: the initial call pays the
    # compile, which would otherwise be read as device time)
    def tri():
        pend = mapper._dispatch_triangulation(slot)
        ids = mapper._finish_triangulation(pend)
        world = mapper.world
        world.release_landmarks(np.asarray(ids))  # return the spawn budget
        return len(ids)

    tri()
    tri()
    t0 = time.perf_counter()
    for _ in range(5):
        tri()
    t_tri = (time.perf_counter() - t0) / 5 * 1000
    print(f"triangulate+finish: {t_tri:7.2f} ms")


if __name__ == "__main__":
    main()
