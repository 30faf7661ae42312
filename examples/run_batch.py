"""Multi-sequence batch mode demo: S synthetic sequences, ONE device
program per frame (vslam_tpu.parallel.multi_seq; SURVEY.md §7 phase 5).

Usage: python examples/run_batch.py [n_seqs] [n_frames]

Prints per-sequence ATE and the aggregate frames/s. Best suited to
configurations where a single sequence underfills the device (see the
vslam_tpu.parallel.multi_seq docstring).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np

from vslam_tpu.models import local_mapper, map_state, tracker
from vslam_tpu.parallel import multi_seq
from vslam_tpu.utils import synthetic, trajectory


def main():
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    params = tracker.TrackerParams(
        n_features=512, n_levels=4, active_size=1024, kf_min_stereo=60
    )
    scenes = [
        synthetic.make_scene(
            n_frames=n, n_points=400, width=320, height=240, fps=10.0,
            seed=7 + 3 * s,
        )
        for s in range(S)
    ]
    pairs = []
    for sc in scenes:
        world = map_state.WorldMap(
            lm_capacity=8192, kf_capacity=64, keys_per_kf=params.n_features
        )
        trk = tracker.StereoTracker(
            sc.K.astype(np.float32), sc.baseline, sc.width, sc.height,
            world, params,
        )
        mapper = local_mapper.LocalMapper(
            world, sc.K.astype(np.float32), sc.baseline,
            local_mapper.LocalMapperConfig(n_levels=4, scale=1.2),
        )
        pairs.append((trk, mapper))

    front = multi_seq.BatchedStereoFrontend([p[0] for p in pairs])
    frames = [
        [(sc.render(f), sc.render(f, right=True)) for sc in scenes]
        for f in range(n)
    ]
    t0 = time.time()
    for f in range(n):
        nks = [len(p[0].new_kf_slots) for p in pairs]
        front.track(frames[f])
        for s, (trk, mapper) in enumerate(pairs):
            if len(trk.new_kf_slots) > nks[s] and trk.new_kf_slots[-1] > 0:
                r = mapper.run(trk.new_kf_slots[-1])
                trk.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
                trk.add_active(r["new_lm_ids"])
    front.flush()
    wall = time.time() - t0

    for s, (trk, _) in enumerate(pairs):
        poses = trk.trajectory()
        ate = trajectory.ate_rmse(poses, scenes[s].poses_c2w[:n], align=False)
        print(f"seq {s}: {len(poses)} frames, ATE {ate * 100:.2f} cm, "
              f"{trk.world.n_keyframes} kfs, {trk.world.n_landmarks} lms")
    print(f"{S} sequences x {n} frames in {wall:.1f}s "
          f"({S * n / wall:.1f} aggregate frames/s incl. compile)")


if __name__ == "__main__":
    main()
