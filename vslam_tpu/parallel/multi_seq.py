"""Multi-sequence batch mode: S sequences as one batched device program.

The reference processes one dataset sequence per process (reference
src/VIOSlam.cpp:141-329). Here S same-resolution sequences ride ONE
vmapped frame program — one compile, one dispatch, one result fetch per
frame for the whole batch (SURVEY.md §7 phase 5). Typical use:
batch-evaluating several sequences on one device, or sharding the
sequence axis over several. Batching pays where one sequence's frame
program underfills the device (small frames, few features); its gain at
full EuRoC shapes is not measured.

Design: each sequence keeps its own StereoTracker (host bookkeeping, KF
policy, world map, local mapper) — those are per-sequence and event-
driven. Only the HOT per-frame device program (_track_step) is batched:
before each frame the per-sequence device states are stacked (one jitted
stack program), the vmapped step runs once, and each tracker is handed
its slice of the outputs through its normal pending-queue pipeline, so
keyframe insertion, BA hand-off, re-anchoring and recovery behave
exactly as in single-sequence mode.

Constraints: all sequences must share resolution and tracker config
(static shapes); per-sequence intrinsics/baselines are supported
(batched operands). Stereo and stereo-IMU modes batch; per-sequence
IMU constants (gravity after each sequence's one-time init, T_bc,
noise params) ride as batched operands, per-frame IMU sample bins as a
stacked (S, max_samples, 7) array.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.models import tracker as tracker_mod


class BatchedStereoFrontend:
    """Drive S StereoTrackers (or S MonoTrackers) with one batched frame
    program. Mono sequences batch the same `_track_step` with mono=True;
    each MonoTracker's
    BOOTSTRAP runs unbatched through its own track() — it is host-driven,
    per-sequence event logic — and the batch kicks in once every
    sequence has initialized."""

    def __init__(self, trackers: list[tracker_mod.StereoTracker]):
        assert len(trackers) >= 1
        t0 = trackers[0]
        p0 = t0.params
        self._mono = bool(getattr(t0, "_mono", False))
        for t in trackers[1:]:
            p = t.params
            assert (
                (p.n_features, p.n_levels, p.active_size, t.width, t.height)
                == (p0.n_features, p0.n_levels, p0.active_size, t0.width, t0.height)
            ), "batched sequences must share resolution and tracker shapes"
            assert (t.imu_cfg is None) == (t0.imu_cfg is None), (
                "all batched sequences must agree on IMU mode"
            )
            if t.imu_cfg is not None:
                assert t.imu_cfg.max_samples == t0.imu_cfg.max_samples, (
                    "batched IMU sequences must share max_samples"
                )
            assert bool(getattr(t, "_mono", False)) == self._mono, (
                "batched sequences must agree on mono vs stereo mode"
            )
        self.trackers = trackers
        self.S = len(trackers)
        self._has_imu = t0.imu_cfg is not None
        self._K_b = jnp.stack([t.K for t in trackers])
        self._bl_b = jnp.stack(
            [jnp.asarray(t.baseline, jnp.float32) for t in trackers]
        )
        self._imu_b = jnp.stack([t._imu_dummy for t in trackers])
        self._stack = jax.jit(
            lambda *states: jax.tree.map(lambda *xs: jnp.stack(xs), *states)
        )
        # batched IMU constants: gravity differs per sequence once each
        # one-time gravity init ran (set_gravity replaces the tracker's
        # _imu_const tuple), so the stack is rebuilt lazily whenever any
        # tracker's tuple identity changed
        self._const_b = None
        self._const_ids = None

        p = p0

        mono = self._mono

        def step(LR, state, imu, imu_const, radii, K, baseline):
            return tracker_mod._track_step(
                LR,
                state,
                imu,
                imu_const,
                radii,
                jnp.float32(p.refine_radius),
                jnp.float32(t0._desc_thr),
                jnp.float32(t0._ratio),
                K,
                baseline,
                t0.scale_factors,
                t0._static,
                t0.width,
                t0.height,
                p.n_levels,
                p.min_inliers,
                mono=mono,
                has_imu=self._has_imu,
            )

        self._vstep = jax.jit(
            jax.vmap(step, in_axes=(0, 0, 0, 0, None, 0, 0))
        )

    def _imu_const_b(self):
        ids = tuple(id(t._imu_const) for t in self.trackers)
        if ids != self._const_ids:
            self._const_b = self._stack(*[t._imu_const for t in self.trackers])
            self._const_ids = ids
        return self._const_b

    # ------------------------------------------------------------------
    def track(self, frames, imu=None) -> list[np.ndarray]:
        """One frame for every sequence. `frames` = list of (left, right)
        numpy pairs (stereo) or left images (mono), or a pre-staged
        (S, 2|1, H, W) device array. `imu` = list of per-sequence
        [dt, gyro, accel] row arrays (None entries allowed) when the
        batch runs with IMU. Returns the newest PROCESSED pose per
        sequence (lagging by each tracker's pipeline depth, exactly as
        single-sequence track()).

        Mono: while ANY sequence is still bootstrapping, every sequence
        runs unbatched through its own track() (host-driven per-sequence
        init); the caller must service `needs_init_triangulation` exactly
        as in single-sequence mode."""
        ts = self.trackers
        bootstrapping = self._mono and any(
            not getattr(t, "initialized", True) for t in ts
        )
        if ts[0].frame_idx == 0 or bootstrapping:
            # per-sequence init (frame-0 stereo map seed / mono bootstrap)
            for i, t in enumerate(ts):
                f = frames[i]
                rows = imu[i] if imu is not None else None
                if self._mono:
                    left = f[0] if isinstance(f, (list, tuple)) else f
                    t.track(np.asarray(left), imu=rows)
                else:
                    t.track(np.asarray(f[0]), np.asarray(f[1]), imu=rows)
            return [t.pose.copy() for t in ts]

        for t in ts:
            t.counters.inc("frames")
        batched = self._stack(*[t._state for t in ts])
        if isinstance(frames, (list, tuple)):
            if self._mono:
                LR = jnp.asarray(
                    np.stack(
                        [
                            np.asarray(
                                f[0] if isinstance(f, (list, tuple)) else f
                            )[None]
                            for f in frames
                        ]
                    )
                )
            else:
                LR = jnp.asarray(
                    np.stack([np.stack([f[0], f[1]]) for f in frames])
                )
        else:
            LR = jnp.asarray(frames)
        if self._has_imu and imu is not None:
            Sm = ts[0].imu_cfg.max_samples
            pad = np.zeros((self.S, Sm, 7), np.float32)
            for i, rows in enumerate(imu):
                if rows is None:
                    continue  # dt==0 pads are no-ops in the preintegrator
                r = np.asarray(rows, np.float32)[:Sm]
                pad[i, : len(r)] = r
            imu_b = jnp.asarray(pad)
        else:
            imu_b = self._imu_b
        radii = ts[0]._radii_first if ts[0].frame_idx == 1 else ts[0]._radii
        new_state, outputs = self._vstep(
            LR, batched, imu_b, self._imu_const_b(), radii, self._K_b, self._bl_b
        )
        outputs["blob"].copy_to_host_async()
        for s, t in enumerate(ts):
            t._state = jax.tree.map(lambda a: a[s], new_state)
            out_s = jax.tree.map(lambda a: a[s], outputs)
            t._pending.append(
                (t.frame_idx, out_s, t.active_ids.copy(), t._D.copy())
            )
            t.frame_idx += 1
            while len(t._pending) > t.params.pipeline_depth:
                t._process(*t._pending.popleft())
        return [t.pose.copy() for t in ts]

    def flush(self):
        for t in self.trackers:
            t.flush()
