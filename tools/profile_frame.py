"""Per-stage timing of the tracking loop on the live device.

Times (a) host->device upload, (b) the fused _track_frame program,
(c) the blob device->host fetch, (d) _prepare_keyframe, (e) one
LocalMapper.run, then a full tracked frame end-to-end — to show whether
the frames/s ceiling is compute or dispatch/transfer latency.
"""

import time

import numpy as np


def timeit(fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1000.0  # ms


def main():
    import jax

    from vslam_tpu.utils import compile_cache

    compile_cache.setup()

    import jax.numpy as jnp

    from vslam_tpu.models import local_mapper, map_state, tracker
    from vslam_tpu.utils import synthetic

    print("devices:", jax.devices())

    n_frames = 30
    scene = synthetic.make_scene(
        n_frames=n_frames, n_points=900, width=752, height=480, fps=20.0, seed=3
    )
    params = tracker.TrackerParams(n_features=1024, n_levels=8, active_size=4096)
    world = map_state.WorldMap(lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=1024)
    trk = tracker.StereoTracker(
        scene.K.astype(np.float32), scene.baseline, scene.width, scene.height, world, params
    )
    mapper = local_mapper.LocalMapper(world, scene.K.astype(np.float32), scene.baseline)

    frames = [
        (scene.render(f).astype(np.uint8), scene.render(f, right=True).astype(np.uint8))
        for f in range(n_frames)
    ]

    # run a few real frames to warm up all programs + state
    for f in range(8):
        n_kf = len(trk.new_kf_slots)
        trk.track(*frames[f])
        if len(trk.new_kf_slots) > n_kf and trk.new_kf_slots[-1] > 0:
            r = mapper.run(trk.new_kf_slots[-1])
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])

    LR_np = np.stack(frames[8])
    LR = jnp.asarray(LR_np).astype(jnp.float32)
    print(f"upload   : {timeit(lambda: jax.block_until_ready(jnp.asarray(LR_np))):8.2f} ms")
    p = trk.params

    def full_host_frame():
        trk.track(*frames[10])

    print(f"frame e2e: {timeit(full_host_frame, n=20):8.2f} ms  (pipelined: dispatch + delayed fetch)")
    trk.flush()

    # keyframe cost
    n_kf = len(trk.new_kf_slots)

    def ba():
        r = mapper.run(trk.new_kf_slots[-1])
        return r

    print(f"mapperrun: {timeit(ba, n=5, warmup=1):8.2f} ms  (find_new_points + local BA + writeback)")

    # breakdown of track program: frontend alone
    def run_frontend():
        kl, st = tracker._frontend(
            LR[0], LR[1], trk.K[0, 0], trk.baseline, trk.scale_factors, trk._static
        )
        jax.block_until_ready(st["depth"])

    print(f"frontend : {timeit(run_frontend):8.2f} ms  (extract x2 + stereo match only)")

    from vslam_tpu.ops import extract as ex

    def one_extract():
        k = ex.extract(LR[0].astype(jnp.float32), n_levels=p.n_levels, scale=p.scale,
                       total=p.n_features, edge_margin=p.edge_margin,
                       fast_hi=p.fast_hi, fast_lo=p.fast_lo)
        jax.block_until_ready(k.xy)

    print(f"extract1 : {timeit(one_extract):8.2f} ms  (one image pyramid+FAST+BRIEF)")


if __name__ == "__main__":
    main()
