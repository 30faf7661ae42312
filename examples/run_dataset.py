"""Dataset CLI driver — the VIOSlam/VIOSlamMono equivalent.

Usage:
    python examples/run_dataset.py <config.yaml> [--data-root DIR]
        [--limit N] [--out traj.txt] [--async-ba] [--no-prefetch]
        [--checkpoint ck.npz] [--checkpoint-every N] [--resume ck.npz]
        [--viz map.html] [--ply map.ply] [--global-ba] [--shards N|auto]
        [--loop-closure] [--debug-dir DIR] [--debug-every N]

Mirrors the reference drivers (src/VIOSlam.cpp:141-329,
src/VIOSlamMono.cpp:112-275): loads the YAML config, enumerates the
dataset (KITTI image_0/image_1 dirs or EuRoC mav0 CSVs), parses and bins
IMU samples per frame, rectifies when the config says so, runs the frame
loop, and dumps the trajectory in the reference's KITTI 3x4 format (plus
TUM format for EuRoC evaluation). SIGINT finishes cleanly and still writes
the trajectory (the reference's signal flag, src/VIOSlam.cpp:17-21).

Beyond the reference: frames arrive through the NATIVE IO runtime by
default — a multi-threaded C++ PNG-decode(+rectify) prefetcher
(vslam_tpu/native) that keeps decode latency off the tracking loop (the
reference pays imread+remap inline per frame, src/VIOSlam.cpp:292-306) —
and the run can be checkpointed at keyframe boundaries and resumed
bit-exact (--checkpoint/--resume; SURVEY.md §5 checkpoint mandate).
"""

import argparse
import signal
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np

from vslam_tpu.geometry import camera as cam
from vslam_tpu.models.system import VSlamSystem
from vslam_tpu.utils.config import ConfigFile, SlamMode
from vslam_tpu.utils.datasets import open_dataset
from vslam_tpu.utils import checkpoint as ckpt_io
from vslam_tpu.utils import compile_cache

_stop = False


def _sigint(_sig, _frm):
    global _stop
    _stop = True


def _host_rectify_maps(conf: ConfigFile, mono: bool):
    """(lx, ly, rx, ry) float32 source-coordinate maps for the native
    prefetcher's rectify stage (the reference's initUndistortRectifyMap,
    src/VIOSlam.cpp:282-287), or None when the rig is already rectified."""
    rig = cam.StereoCamera.from_config(conf)
    if rig.left.K is None:
        return None

    def split(c):
        m = cam.init_undistort_rectify_map(
            c.K, c.D, c.R, c.P, rig.width, rig.height
        )
        return (
            np.ascontiguousarray(m[..., 0], np.float32),
            np.ascontiguousarray(m[..., 1], np.float32),
        )

    lx, ly = split(rig.left)
    rx = ry = None
    if not mono:
        rx, ry = split(rig.right)
    return lx, ly, rx, ry


def main():
    compile_cache.setup()
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--async-ba", action="store_true")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="force the PIL decode path (native IO disabled)")
    ap.add_argument("--checkpoint", default=None,
                    help="write the full SLAM state here at exit")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="also checkpoint every N new keyframes")
    ap.add_argument("--resume", default=None,
                    help="restore a checkpoint and continue from its frame")
    ap.add_argument("--viz", default=None, help="HTML map viewer output path")
    ap.add_argument("--viz-every", type=int, default=0, metavar="N",
                    help="with --viz: ALSO rewrite the viewer every N new "
                         "keyframes during the run (atomic replace; the "
                         "headless live-view analog)")
    ap.add_argument("--ply", default=None, help="PLY point-cloud output path")
    ap.add_argument("--global-ba", action="store_true",
                    help="final full-map bundle adjustment before saving")
    ap.add_argument("--shards", default=None,
                    help="shard the local BA over an N-device mesh "
                         "('auto' = all visible devices)")
    ap.add_argument("--loop-closure", action="store_true",
                    help="detect + close trajectory loops at keyframes "
                         "(pose-graph correction, landmark merge)")
    ap.add_argument("--debug-dir", default=None,
                    help="write tracked-keypoint overlay PNGs here")
    ap.add_argument("--debug-every", type=int, default=10, metavar="N",
                    help="overlay every N-th frame (with --debug-dir)")
    args = ap.parse_args()

    conf = ConfigFile(args.config)
    mono = conf.slam_mode in (SlamMode.MONOCULAR, SlamMode.MONO_IMU)

    # native IO: prefetch decode threads; for unrectified rigs the
    # prefetcher also rectifies on the host, so the facade skips its
    # device-side remap
    use_native = not args.no_prefetch
    if use_native:
        from vslam_tpu import native

        use_native = native.available()
        if not use_native:
            print(f"native IO unavailable ({native.build_error()}); PIL fallback")
    maps = None
    if use_native and not conf.rectified:
        maps = _host_rectify_maps(conf, mono)

    shards = args.shards
    if shards is not None and shards != "auto":
        shards = int(shards)
    system = VSlamSystem(
        conf, async_ba=args.async_ba, io_rectified=maps is not None,
        shards=shards, loop_closure=args.loop_closure,
    )
    ds = open_dataset(conf, args.data_root)
    start = 0
    if args.resume:
        meta = ckpt_io.load_checkpoint(args.resume, system.world, system.tracker)
        start = int(meta["frame_idx"])
        print(f"resumed {args.resume}: frame {start}, "
              f"{system.world.n_keyframes} kfs, {system.world.n_landmarks} lms")
    print(f"mode={system.mode.name} frames={len(ds)} "
          f"rig={system.rig.width}x{system.rig.height} "
          f"io={'native' if use_native else 'pil'}")

    debug_hook = None
    if args.debug_dir:
        from vslam_tpu.utils import debug_view

        debug_hook = debug_view.make_tracker_hook(
            args.debug_dir, every=max(args.debug_every, 1)
        )
        system.tracker.debug_hook = debug_hook

    signal.signal(signal.SIGINT, _sigint)
    times = []
    t0 = time.time()
    n = 0
    kfs_at_ckpt = system.world.n_keyframes
    live_viz = None
    if args.viz and args.viz_every > 0:
        from vslam_tpu.utils import viz as viz_mod

        live_viz = viz_mod.LiveMapWriter(
            args.viz, system.world, every_n_kf=args.viz_every
        )
    for frame in ds.frames(args.limit, maps=maps, prefetch=use_native):
        if _stop:
            break
        times.append(frame.t)
        if frame.index < start:
            continue  # already in the resumed state
        if debug_hook is not None:
            # processing lags dispatch by the pipeline depth — keep a few
            # recent left frames for the overlay writer
            debug_hook.cache[frame.index] = np.asarray(frame.left)
            for k in list(debug_hook.cache):
                if k < frame.index - 8:
                    del debug_hook.cache[k]
        if mono:
            system.track_mono_imu(frame.left, imu=frame.imu)
        else:
            system.track_stereo(frame.left, frame.right, imu=frame.imu)
        n += 1
        if (
            args.checkpoint
            and args.checkpoint_every > 0
            and system.world.n_keyframes - kfs_at_ckpt >= args.checkpoint_every
        ):
            system.exit()  # drain in-flight BA so the snapshot is consistent
            ckpt_io.save_checkpoint(args.checkpoint, system.world, system.tracker)
            kfs_at_ckpt = system.world.n_keyframes
        if live_viz is not None:
            live_viz.maybe_export(system.tracker)
        if n % 50 == 0:
            fps = n / (time.time() - t0)
            print(f"frame {n}  {fps:.1f} fps  kfs={system.world.n_keyframes} lms={system.world.n_landmarks}")

    system.exit()
    if args.global_ba:
        r = system.global_ba()
        if r is not None:
            print(f"global BA: {len(r['window'])} kfs, err={r['error']:.1f}, "
                  f"killed={r['n_killed']}")
    wall = time.time() - t0
    if args.checkpoint:
        ckpt_io.save_checkpoint(args.checkpoint, system.world, system.tracker)
        print(f"checkpoint -> {args.checkpoint}")
    system.save_trajectory(args.out, np.asarray(times))
    if args.viz or args.ply:
        from vslam_tpu.utils import viz

        poses = system.trajectory()
        if args.viz:
            viz.export_html(
                args.viz, system.world, poses,
                active_ids=system.tracker.active_ids,
            )
            print(f"viz -> {args.viz}")
        if args.ply:
            viz.export_ply(
                args.ply, system.world, poses,
                active_ids=system.tracker.active_ids,
            )
            print(f"ply -> {args.ply}")
    print(f"done: {n} frames in {wall:.1f}s ({n/max(wall,1e-9):.1f} fps) -> {args.out}")
    import json

    stages = system.tracker.metrics.summary() | system.mapper.metrics.summary()
    counts = system.tracker.counters.summary() | system.mapper.counters.summary()
    if stages:
        print("stages:", json.dumps(stages))
        print("counters:", json.dumps(counts))


if __name__ == "__main__":
    sys.exit(main())
