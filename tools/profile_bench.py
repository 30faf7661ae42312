"""Per-frame wall time of the exact bench.py loop, with KF/BA markers —
shows where the gap between steady-state frame cost and the bench average
comes from (KF insertion, BA dispatch, BA finish)."""

import time

import numpy as np


def main():
    from vslam_tpu.models import local_mapper, map_state, tracker
    from vslam_tpu.utils import compile_cache, synthetic

    compile_cache.setup()

    n_frames = 80
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

    pending_ba = [None]

    def consume_ba():
        if pending_ba[0] is not None:
            t0 = time.perf_counter()
            r = mapper.finish(pending_ba[0])
            t_fin = time.perf_counter() - t0
            pending_ba[0] = None
            trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
            trk.add_active(r["new_lm_ids"])
            return t_fin, time.perf_counter() - t0 - t_fin
        return 0.0, 0.0

    warmup = 12
    rows = []
    for f in range(n_frames):
        t0 = time.perf_counter()
        t_fin, t_re = consume_ba()
        t1 = time.perf_counter()
        n_kf = len(trk.new_kf_slots)
        trk.track(*frames[f])
        t2 = time.perf_counter()
        t_disp = 0.0
        is_kf = len(trk.new_kf_slots) > n_kf
        if is_kf and trk.new_kf_slots[-1] > 0:
            td0 = time.perf_counter()
            pending_ba[0] = mapper.run_async(trk.new_kf_slots[-1])
            t_disp = time.perf_counter() - td0
        total = time.perf_counter() - t0
        rows.append((f, total, t1 - t0, t2 - t1, t_disp, is_kf))

    steady = [r for r in rows[warmup:]]
    tot = sum(r[1] for r in steady) / len(steady)
    print(f"mean frame (after warmup): {tot*1e3:7.2f} ms  -> {1/tot:5.1f} fps")
    kf = [r for r in steady if r[5]]
    nkf = [r for r in steady if not r[5]]
    print(f"non-KF frames: n={len(nkf)} mean {np.mean([r[1] for r in nkf])*1e3:7.2f} ms  (track {np.mean([r[3] for r in nkf])*1e3:.2f})")
    if kf:
        print(f"KF frames    : n={len(kf)} mean {np.mean([r[1] for r in kf])*1e3:7.2f} ms  "
              f"(consume {np.mean([r[2] for r in kf])*1e3:.2f}, track+insert {np.mean([r[3] for r in kf])*1e3:.2f}, ba_dispatch {np.mean([r[4] for r in kf])*1e3:.2f})")
    # frames right after a KF pay the BA consume
    after = [rows[i] for i in range(warmup, len(rows)) if rows[i - 1][5] and not rows[i][5]]
    if after:
        print(f"frame-after-KF: n={len(after)} mean {np.mean([r[1] for r in after])*1e3:7.2f} ms  (consume {np.mean([r[2] for r in after])*1e3:.2f})")
    print("\nper-frame (f, total ms, consume, track, ba_disp, kf):")
    for r in rows[warmup:]:
        print(f"  {r[0]:3d} {r[1]*1e3:8.2f} {r[2]*1e3:7.2f} {r[3]*1e3:7.2f} {r[4]*1e3:7.2f} {'KF' if r[5] else ''}")


if __name__ == "__main__":
    main()
