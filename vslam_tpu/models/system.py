"""System facade: configuration -> components -> per-frame API.

Equivalent of reference VSlamSystem (include/System.h:15-57,
src/System.cpp): wires cameras/extraction/tracker/map from one YAML config,
dispatches TrackStereo / TrackStereoIMU / TrackMonoIMU per mode, runs the
local mapper per keyframe (synchronously by default; with async_ba=True the
BA is dispatched to the device queue and its results are consumed one frame
later — the role the reference's LocalMapper thread plays,
src/System.cpp:18-19, without a host thread fighting the GIL), and saves
trajectories in the reference's KITTI 3x4 format (src/System.cpp:87-124).
"""

from __future__ import annotations


import jax.numpy as jnp
import numpy as np

from vslam_tpu.geometry import camera as cam
from vslam_tpu.models import local_mapper, map_state, tracker
from vslam_tpu.utils.config import ConfigFile, SlamMode
from vslam_tpu.utils import trajectory as traj_io


class VSlamSystem:
    def __init__(
        self,
        conf: ConfigFile,
        mode: SlamMode | None = None,
        async_ba: bool = False,
        lm_capacity: int = 1 << 16,
        kf_capacity: int = 1024,
        tracker_params: tracker.TrackerParams | None = None,
        io_rectified: bool = False,
        shards: int | str | None = None,
        loop_closure: bool = False,
    ):
        """`io_rectified=True` declares that incoming frames were already
        undistorted+rectified by the IO pipeline (native prefetcher with
        rectify maps) — the facade then skips its device-side remap even
        for an unrectified config.

        `shards`: run the local BA SHARDED over an N-device mesh
        (`"auto"` = all visible devices) — the production path to the
        distributed Schur BA (vslam_tpu.parallel.sharded_ba); the
        reference's single GTSAM thread (src/System.cpp:18-19) has no
        analog. None/1 = single-device BA.

        `loop_closure`: detect revisits at every keyframe (descriptor
        retrieval + geometric verification) and correct the whole
        trajectory with an SE(3) pose graph + landmark merge
        (models/loop_closure.py). The reference's loop-closure state is
        vestigial — no detector ever drives it (SURVEY.md §2 quirks).
        Opt-in: the retrieval sweep costs one batched Hamming pass over
        the keyframe tables per inserted keyframe (driver
        --loop-closure)."""
        self.conf = conf
        self.mode = mode if mode is not None else conf.slam_mode
        self.rig = cam.StereoCamera.from_config(conf)
        K = self.rig.left.intrinsics.astype(np.float32)

        fe_total = int(conf.get("FE", "nFeatures", default=2048))
        params = tracker_params or tracker.TrackerParams(
            n_features=_round_pow2(fe_total),
            n_levels=int(conf.get("FE", "nLevels", default=8)),
            scale=float(conf.get("FE", "imScale", default=1.2)),
            fast_hi=float(conf.get("FE", "maxFastThreshold", default=20)),
            fast_lo=float(conf.get("FE", "minFastThreshold", default=7)),
            edge_margin=int(conf.get("FE", "edgeThreshold", default=19)),
        )
        self.world = map_state.WorldMap(
            lm_capacity=lm_capacity,
            kf_capacity=kf_capacity,
            keys_per_kf=params.n_features,
        )

        # IMU config (STEREO_IMU / MONO_IMU modes; reference IMU YAML block +
        # T_bc1, config/config_MH_01.yaml:18-24, 112-115)
        imu_cfg = None
        self._imu_hz = 200.0
        if self.mode in (SlamMode.STEREO_IMU, SlamMode.MONO_IMU):
            hz = float(conf.get("IMU", "Hz", default=200))
            self._imu_hz = hz
            T_bc = conf.get_matrix("T_bc1", default=None)
            if T_bc is None:
                T_bc = np.eye(4, dtype=np.float32)
            imu_cfg = tracker.ImuConfig(
                gyro_noise=float(conf.get("IMU", "gyroscope_noise_density", default=1.7e-4)),
                accel_noise=float(conf.get("IMU", "accelerometer_noise_density", default=2e-3)),
                gyro_walk=float(conf.get("IMU", "gyroscope_random_walk", default=1.9e-5)),
                accel_walk=float(conf.get("IMU", "accelerometer_random_walk", default=3e-3)),
                hz=hz,
                T_bc=np.asarray(T_bc, np.float32).reshape(4, 4),
                gravity_w=np.array([0.0, 0.0, -9.81], np.float32),
            )
        self._last_imu_t: float | None = None
        self._gravity_set = False

        if self.mode == SlamMode.MONOCULAR:
            self.tracker = tracker.MonoTracker(
                K, self.rig.width, self.rig.height, self.world, params,
                imu_cfg=imu_cfg,
            )
        else:
            self.tracker = tracker.StereoTracker(
                K, self.rig.baseline, self.rig.width, self.rig.height, self.world,
                params, imu_cfg=imu_cfg,
            )
        # optional explicit world gravity (config `IMU.gravity: [x,y,z]`):
        # the reference's init is a hardcoded axis permutation of the
        # first accel sample that assumes EuRoC's sensor mounting
        # (src/VIOSlam.cpp:274) — any other rig needs the true vector
        g = conf.get("IMU", "gravity", default=None)
        if g is not None and imu_cfg is not None:
            self.tracker.set_gravity(np.asarray(g, np.float32))
            self._gravity_set = True
        mesh = None
        if shards is not None and shards != 1:
            import jax

            from vslam_tpu.parallel import mesh as mesh_mod, sharded_ba

            n = len(jax.devices()) if shards == "auto" else int(shards)
            if n > 1:
                mesh = mesh_mod.make_mesh(n, axis=sharded_ba.AXIS)
        self.mapper = local_mapper.LocalMapper(
            self.world,
            K,
            self.rig.baseline,
            local_mapper.LocalMapperConfig(
                n_levels=params.n_levels, scale=params.scale
            ),
            mesh=mesh,
        )

        # rectification (EuRoC-style unrectified rigs)
        self._maps = None
        if not io_rectified and not conf.rectified and self.rig.left.K is not None:
            ml = cam.init_undistort_rectify_map(
                self.rig.left.K, self.rig.left.D, self.rig.left.R, self.rig.left.P,
                self.rig.width, self.rig.height,
            )
            mr = cam.init_undistort_rectify_map(
                self.rig.right.K, self.rig.right.D, self.rig.right.R, self.rig.right.P,
                self.rig.width, self.rig.height,
            )
            self._maps = (jnp.asarray(ml), jnp.asarray(mr))

        # post-closure polish: run a full-map BA after an applied closure
        # (see _try_loop_closure). Overridable for callers that schedule
        # their own polish (or cannot afford it mid-run). Rate-limited:
        # a multi-loop trajectory closes against the same region every
        # few keyframes, and a full-map BA per closure at a grown map is
        # wasted work — the polish runs only when the map gained at
        # least `polish_min_new_kfs` keyframes since the last one (the
        # pose graph + merge still apply on every closure).
        self.closure_polish = True
        self.polish_min_new_kfs = 4
        self._last_polish_nkf = -(1 << 30)  # first closure always polishes
        self.loop_closer = None
        if loop_closure:
            from vslam_tpu.models import loop_closure as lc_mod

            self.loop_closer = lc_mod.LoopCloser(
                self.world, K, self.rig.baseline
            )
        self._async = async_ba
        self._pending_ba: dict | None = None
        self._ba_dispatch_frame = -1
        self._frame_count = 0
        # frames to let an async BA age before its (blocking) consume: the
        # staged device chain spans two frames (phase A at the KF, phase B
        # behind the next frame's step), so consuming earlier would block
        # on it; at 2+ frames the result copies have usually landed
        self.ba_latency_frames = 2
        # past the minimum age the consume additionally POLLS the result
        # blobs (background-prefetch Future.done) and keeps deferring
        # while the device chain is still running — the BA writeback
        # already updated the device-resident map at dispatch, so only
        # the host-side reanchor and new-landmark publication wait. A
        # hard ceiling bounds the staleness (a consume that blocks
        # mid-chain puts the whole chain into one frame's latency)
        self.ba_max_latency_frames = 8
        # readiness polling makes the consume frame — hence KF cadence
        # and loop-closure timing — depend on wall-clock thread timing.
        # True: skip the poll and consume (blocking) at exactly
        # ba_latency_frames — a deterministic trajectory for ATE
        # benchmarking and reproducibility tests, at some fps cost
        # (measured circuit ATE spread 0.058-0.134 across identical
        # nondeterministic runs)
        self.deterministic_ba_latency = False

    # ------------------------------------------------------------------
    def _rectify(self, left, right):
        if self._maps is None:
            return left, right
        L = cam.remap_bilinear(jnp.asarray(left, jnp.float32), self._maps[0])
        R = cam.remap_bilinear(jnp.asarray(right, jnp.float32), self._maps[1])
        return np.asarray(L), np.asarray(R)

    def _consume_ba_results(self, force: bool = False):
        """Finish the in-flight local-BA dispatch, if any. The device runs
        the whole pipeline asynchronously after run_async; the consume is
        deferred `ba_latency_frames` frames so the result copies have
        usually landed and the fetch does not block mid-chain
        (the reference gets the same overlap from its LocalMapper thread,
        src/System.cpp:18-19 — here the device queue IS the second thread,
        without fighting the host GIL)."""
        if self._pending_ba is None:
            return
        if not force:
            age = self._frame_count - self._ba_dispatch_frame
            if age < self.ba_latency_frames:
                return
            # publish the triangulated landmarks NOW, independent of BA
            # readiness: their blob landed at phase A + a transfer, and
            # waiting for the full chain starves tracking through hard
            # stretches (measured: 1000-frame adversarial ATE 0.07->0.12)
            self.tracker.add_active(
                self.mapper.consume_triangulation(self._pending_ba)
            )
            if (
                not self.deterministic_ba_latency
                and age < self.ba_max_latency_frames
                and not local_mapper.pending_ready(self._pending_ba)
            ):
                return  # chain still running on device; poll next frame
        r = self.mapper.finish(self._pending_ba)
        self._pending_ba = None
        self.tracker.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
        self.tracker.add_active(r.get("new_lm_ids", ()))
        self._try_loop_closure(r["kf_slot"])

    def _try_loop_closure(self, kf_slot: int):
        """Post-BA loop detection for the newest keyframe; on a verified
        closure the whole trajectory is pose-graph corrected, duplicate
        landmarks merge, and the tracker re-anchors on the corrected
        map — then (closure_polish, default on) a full-map BA polishes
        the now-consistent geometry. The pose graph distributes drift
        along the chain but moves landmarks only rigidly with their
        anchor keyframes; the follow-up BA is what actually re-converges
        structure across the seam."""
        if self.loop_closer is None:
            return
        r = self.loop_closer.try_close(kf_slot)
        if r is None:
            return
        self.tracker.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
        self.tracker.refresh_after_ba()
        nkf = self.world.n_keyframes
        if (
            self.closure_polish
            # mono: a projection-only global BA has no scale gauge (see
            # _dispatch_ba) — pose graph + merge only
            and self.mode != SlamMode.MONOCULAR
            and nkf - self._last_polish_nkf >= self.polish_min_new_kfs
        ):
            g = self.mapper.run_global()
            if g is not None:
                self._last_polish_nkf = nkf
                self.tracker.reanchor(g["kf_slot"], g["old_pose"], g["new_pose"])
                self.tracker.refresh_after_ba()

    # ------------------------------------------------------------------
    def _imu_to_dt_rows(self, rows) -> np.ndarray | None:
        """Absolute-timestamp IMU rows (K,7) [t,w,a] -> (K,7) [dt,w,a] rows
        for the tracker, with the reference's first-sample 1/Hz fallback
        (src/FeatureTracker.cpp:337-350). Also performs the one-time gravity
        init from the first accel sample (src/VIOSlam.cpp:274)."""
        if rows is None or len(rows) == 0:
            return None
        rows = np.asarray(rows, np.float64)
        if not self._gravity_set:
            a = rows[0, 4:7]
            self.tracker.set_gravity(np.array([a[1], -a[0], a[2]]))
            self._gravity_set = True
        t = rows[:, 0]
        prev = self._last_imu_t if self._last_imu_t is not None else t[0] - 1.0 / self._imu_hz
        dts = np.diff(np.concatenate([[prev], t]))
        self._last_imu_t = float(t[-1])
        return np.concatenate(
            [np.maximum(dts, 0.0)[:, None], rows[:, 1:7]], axis=1
        ).astype(np.float32)

    def track_stereo(self, left: np.ndarray, right: np.ndarray, imu=None) -> np.ndarray:
        """Process one frame; returns the (4,4) cam-to-world pose
        (reference TrackStereo/TrackStereoIMU, src/System.cpp:72-85)."""
        left, right = self._rectify(left, right)
        if imu is not None and self.mode in (SlamMode.STEREO_IMU, SlamMode.MONO_IMU):
            imu = self._imu_to_dt_rows(imu)
        else:
            imu = None
        if self._async:
            self._consume_ba_results()
        n_kf_before = len(self.tracker.new_kf_slots)
        pose = self.tracker.track(left, right, imu)
        self._advance_ba()  # phase B of a staged BA, behind this frame's step
        self._dispatch_ba(n_kf_before, mono=False)
        return pose

    def track_mono_imu(self, left: np.ndarray, imu=None) -> np.ndarray:
        """Monocular-inertial frame (reference TrackMonoIMU,
        src/System.cpp:82-85). Handles the bootstrap's initial multi-view
        triangulation and per-KF mono mapping."""
        if self._maps is not None:
            left = np.asarray(
                cam.remap_bilinear(jnp.asarray(left, jnp.float32), self._maps[0])
            )
        imu = self._imu_to_dt_rows(imu) if imu is not None else None
        if self._async:
            self._consume_ba_results()
        n_kf_before = len(self.tracker.new_kf_slots)
        pose = self.tracker.track(left, imu=imu)
        if getattr(self.tracker, "needs_init_triangulation", False):
            slot = self.tracker.new_kf_slots[-1]
            ids = self.mapper.find_new_points(slot, mono=True)
            self.tracker.add_active(ids)
            self.tracker.needs_init_triangulation = False
            self.tracker.last_kf_tracked = max(len(ids), 1)
        else:
            self._advance_ba()
            self._dispatch_ba(n_kf_before, mono=True)
        return pose

    def _advance_ba(self):
        """Dispatch phase B (BA + write-back) of a staged async BA — called
        one frame after the keyframe so the intervening tracking step's
        program sits between the two chain halves in the device queue
        (LocalMapper.run_async_staged)."""
        if self._pending_ba is not None:
            self._pending_ba = self.mapper.advance(self._pending_ba)

    def _dispatch_ba(self, n_kf_before: int, mono: bool):
        self._frame_count += 1
        if len(self.tracker.new_kf_slots) > n_kf_before:
            slot = self.tracker.new_kf_slots[-1]
            if slot > 0:  # BA needs at least 2 KFs
                if mono:
                    # NO monocular local BA — reference parity
                    # (src/System.cpp:11-20: mono mode creates no
                    # LocalMapper) and MEASURED: the projection-only
                    # window BA has no scale gauge in mono (nothing pins
                    # the metric scale once the window slides off the
                    # IMU-anchored bootstrap), and it AMPLIFIES drift
                    # ~100x — 1.02 m vs 0.012 m at frame 200 of the long
                    # lateral run. Keyframe mapping is multi-view
                    # triangulation only; scale rides on the per-frame
                    # CombinedImuFactor solve. (A visual-inertial BA with
                    # per-KF velocity/bias states is the documented
                    # follow-up, like the Sim(3) mono pose graph.)
                    ids = self.mapper.find_new_points(slot, mono=True)
                    self.tracker.add_active(ids)
                    self._try_loop_closure(slot)
                elif self._async:
                    # at most one BA in flight
                    self._consume_ba_results(force=True)
                    self._pending_ba = self.mapper.run_async_staged(
                        slot, mono=mono
                    )
                    self._ba_dispatch_frame = self._frame_count
                else:
                    r = self.mapper.run(slot, mono=mono)
                    self.tracker.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
                    self.tracker.add_active(r["new_lm_ids"])
                    self._try_loop_closure(slot)

    def exit(self):
        """Drain the pipeline and the in-flight BA (the reference's
        ExitSystem is an empty stub, src/System.cpp:67-70 — here it actually
        finishes the outstanding work)."""
        self.tracker.flush()
        self._consume_ba_results(force=True)

    def global_ba(self) -> dict | None:
        """Full-map refinement: one 2-round Schur LM over every keyframe
        and landmark (LocalMapper.run_global — a capability the
        reference's fixed ~11-KF window never had). Drains in-flight work
        first; re-anchors the live tracker to the refined last-KF pose so
        tracking can continue afterwards."""
        self.exit()
        r = self.mapper.run_global()
        if r is not None:
            self.tracker.reanchor(r["kf_slot"], r["old_pose"], r["new_pose"])
        return r

    # ------------------------------------------------------------------
    def trajectory(self) -> np.ndarray:
        return self.tracker.trajectory()

    def save_trajectory(self, path: str, times: np.ndarray | None = None):
        poses = self.trajectory()
        traj_io.save_kitti_trajectory(path, poses)
        if times is not None:
            traj_io.save_tum_trajectory(path + ".tum", times[: len(poses)], poses)


def _round_pow2(n: int) -> int:
    """Round feature counts to a power of two for tiling-friendly shapes."""
    p = 1
    while p < n:
        p *= 2
    return p
