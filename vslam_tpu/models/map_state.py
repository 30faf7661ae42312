"""World map: preallocated structure-of-arrays with functional updates.

Re-design of the reference's pointer-based world model
(Map/MapPoint at include/Map.h:19-138, KeyFrame at include/KeyFrame.h:17-82):
hash maps of heap objects become fixed-capacity device arrays + host-side
slot counters; the tracker<->mapper mutex+flag protocol
(include/Map.h:115-135) becomes snapshot semantics — BA reads a gather of
the arrays and writes back with a single scatter, so there is no shared
mutable aliasing and no race class to detect (SURVEY.md §5).

Layout:
- landmarks: position, representative descriptor (+-1 int8 matmul form),
  scale-distance band (MapPoint::maxScaleDist/minScaleDist,
  src/Map.cpp:13-23), validity;
- keyframes: pose + fixed-size per-KF observation table (pixel obs, octave,
  stereo flag, landmark id) — the equivalent of KeyFrame::localMapPoints /
  MapPoint::kFMatches back-pointers, stored flat;
- host mirrors: slot counters, per-KF landmark-id table (numpy) for
  covisibility queries, per-landmark bookkeeping (outlier ages, activity)
  that steers host control flow without device round-trips.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.ops import hamming


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MapArrays:
    """Device-resident map storage (a pytree; all updates functional)."""

    lm_pos: jax.Array  # (P, 3) f32 world positions
    lm_desc: jax.Array  # (P, 256) int8 +-1
    lm_maxdist: jax.Array  # (P,) f32 scale band upper
    lm_mindist: jax.Array  # (P,) f32 scale band lower
    lm_valid: jax.Array  # (P,) bool
    # running per-bit sum of +-1 descriptors over the observation set +
    # observation count: the representative descriptor is the per-bit
    # MAJORITY = the true binary median the reference recomputes from
    # scratch per observation set (MapPoint::calcDescriptor,
    # src/Map.cpp:145-210) — here O(1) incremental
    lm_bitsum: jax.Array  # (P, 256) int16
    lm_nobs: jax.Array  # (P,) int16
    kf_pose: jax.Array  # (W, 4, 4) f32 cam-to-world
    kf_valid: jax.Array  # (W,) bool
    obs_uv: jax.Array  # (W, K, 3) f32 [u_l, v_l, u_r]
    obs_oct: jax.Array  # (W, K) int32
    obs_stereo: jax.Array  # (W, K) bool
    obs_lm: jax.Array  # (W, K) int32 landmark slot or -1
    obs_desc: jax.Array  # (W, K, 8) uint32 bit-packed per-KF key descriptors
    # (32x smaller than the former +-1 int8 form; matchers unpack per
    # block via ops/hamming.unpack_signed right before the Hamming matmul)
    obs_valid: jax.Array  # (W, K) bool — key slot holds a real detection
    # RIGHT-camera-only observations (landmarks matched in the right image
    # at predR but unmatched in the left — left-border exits, left
    # occlusions; reference MapPoint::predR + the right-branch projection
    # factors, include/Map.h:57, src/OptimizationBA.cpp:592-740)
    obs_r_uv: jax.Array  # (W, Kr, 2) f32 [u_r, v_r]
    obs_r_oct: jax.Array  # (W, Kr) int32
    obs_r_lm: jax.Array  # (W, Kr) int32 landmark slot or -1


def make_map(
    lm_capacity: int = 1 << 16,
    kf_capacity: int = 512,
    keys_per_kf: int = 2048,
    right_obs_per_kf: int = 256,
) -> MapArrays:
    P, W, K, Kr = lm_capacity, kf_capacity, keys_per_kf, right_obs_per_kf
    return MapArrays(
        lm_pos=jnp.zeros((P, 3), jnp.float32),
        lm_desc=jnp.zeros((P, 256), jnp.int8),
        lm_maxdist=jnp.zeros((P,), jnp.float32),
        lm_mindist=jnp.zeros((P,), jnp.float32),
        lm_valid=jnp.zeros((P,), bool),
        lm_bitsum=jnp.zeros((P, 256), jnp.int16),
        lm_nobs=jnp.zeros((P,), jnp.int16),
        kf_pose=jnp.tile(jnp.eye(4, dtype=jnp.float32), (W, 1, 1)),
        kf_valid=jnp.zeros((W,), bool),
        obs_uv=jnp.zeros((W, K, 3), jnp.float32),
        obs_oct=jnp.zeros((W, K), jnp.int32),
        obs_stereo=jnp.zeros((W, K), bool),
        obs_lm=jnp.full((W, K), -1, jnp.int32),
        obs_desc=jnp.zeros((W, K, 8), jnp.uint32),
        obs_valid=jnp.zeros((W, K), bool),
        obs_r_uv=jnp.zeros((W, Kr, 2), jnp.float32),
        obs_r_oct=jnp.zeros((W, Kr), jnp.int32),
        obs_r_lm=jnp.full((W, Kr), -1, jnp.int32),
    )


@jax.jit
def scatter_landmarks(
    m: MapArrays,
    slots: jax.Array,  # (S,) int32 target slots (may repeat a dump slot)
    pos: jax.Array,  # (S, 3)
    desc: jax.Array,  # (S, 256) int8
    maxdist: jax.Array,  # (S,)
    mindist: jax.Array,  # (S,)
    valid: jax.Array,  # (S,) bool — invalid rows scatter to the dump slot
) -> MapArrays:
    """Insert/overwrite landmarks. Invalid rows are redirected to the last
    slot (a scratch slot that is never marked valid)."""
    P = m.lm_pos.shape[0]
    dump = P - 1
    s = jnp.where(valid, slots, dump)
    return dataclasses.replace(
        m,
        lm_pos=m.lm_pos.at[s].set(pos),
        lm_desc=m.lm_desc.at[s].set(desc),
        lm_maxdist=m.lm_maxdist.at[s].set(maxdist),
        lm_mindist=m.lm_mindist.at[s].set(mindist),
        lm_valid=m.lm_valid.at[s].set(valid).at[dump].set(False),
        lm_bitsum=m.lm_bitsum.at[s].set(desc.astype(jnp.int16)),
        lm_nobs=m.lm_nobs.at[s].set(1),
    )


@functools.partial(jax.jit, static_argnames=("majority",))
def refresh_descriptors(
    m: MapArrays, ids: jax.Array, desc: jax.Array, majority: bool = True
) -> MapArrays:
    """Fold one new view's descriptor per landmark into the landmark's
    representative descriptor (MapPoint::calcDescriptor analog,
    src/Map.cpp:145-210). majority=True keeps the reference's semantics —
    the observation-set MEDIAN descriptor, which for +-1 bits is the
    per-bit majority, maintained as an O(1) incremental bit-sum (ties
    fall to the newest view's bit). majority=False refreshes to the
    newest view outright (cheaper; tracks appearance drift faster but
    flickers under viewpoint oscillation). The bit-sum accumulator is
    maintained either way so the policy can be switched per call.
    ids < 0 are dropped."""
    P = m.lm_pos.shape[0]
    s = jnp.where(ids >= 0, ids, P)  # out of range -> dropped
    d16 = desc.astype(jnp.int16)
    bitsum = m.lm_bitsum.at[s].add(d16, mode="drop")
    nobs = m.lm_nobs.at[s].add(1, mode="drop")
    if majority:
        safe = jnp.where(ids >= 0, ids, 0)
        bs = bitsum[safe]
        new_desc = jnp.where(bs > 0, 1, jnp.where(bs < 0, -1, desc)).astype(jnp.int8)
    else:
        new_desc = desc
    lm_desc = m.lm_desc.at[s].set(new_desc, mode="drop")
    return dataclasses.replace(
        m, lm_desc=lm_desc, lm_bitsum=bitsum, lm_nobs=nobs
    )


@jax.jit
def scatter_keyframe(
    m: MapArrays,
    kf_slot: jax.Array,  # () int32
    pose: jax.Array,  # (4, 4)
    obs_uv: jax.Array,  # (K, 3)
    obs_oct: jax.Array,  # (K,)
    obs_stereo: jax.Array,  # (K,)
    obs_lm: jax.Array,  # (K,) landmark slot or -1
    obs_desc: jax.Array,  # (K, 8) uint32 bit-packed
    obs_valid: jax.Array,  # (K,) bool
    obs_r_uv: jax.Array,  # (Kr, 2) right-camera pixel obs
    obs_r_oct: jax.Array,  # (Kr,)
    obs_r_lm: jax.Array,  # (Kr,) landmark slot or -1
) -> MapArrays:
    return dataclasses.replace(
        m,
        kf_pose=m.kf_pose.at[kf_slot].set(pose),
        kf_valid=m.kf_valid.at[kf_slot].set(True),
        obs_uv=m.obs_uv.at[kf_slot].set(obs_uv),
        obs_oct=m.obs_oct.at[kf_slot].set(obs_oct),
        obs_stereo=m.obs_stereo.at[kf_slot].set(obs_stereo),
        obs_lm=m.obs_lm.at[kf_slot].set(obs_lm),
        obs_desc=m.obs_desc.at[kf_slot].set(obs_desc),
        obs_valid=m.obs_valid.at[kf_slot].set(obs_valid),
        obs_r_uv=m.obs_r_uv.at[kf_slot].set(obs_r_uv),
        obs_r_oct=m.obs_r_oct.at[kf_slot].set(obs_r_oct),
        obs_r_lm=m.obs_r_lm.at[kf_slot].set(obs_r_lm),
    )


@jax.jit
def writeback_ba(
    m: MapArrays,
    kf_slots: jax.Array,  # (Wb,) int32 (pad with kf capacity-1 + valid mask)
    kf_valid: jax.Array,  # (Wb,) bool
    new_poses: jax.Array,  # (Wb, 4, 4)
    lm_slots: jax.Array,  # (Lb,) int32
    lm_keep: jax.Array,  # (Lb,) bool — landmarks to keep (others untouched)
    new_pts: jax.Array,  # (Lb, 3)
    obs_kill_kf: jax.Array,  # (Ob,) int32 kf slot of observations to sever
    obs_kill_key: jax.Array,  # (Ob,) int32 key slot
    obs_kill: jax.Array,  # (Ob,) bool
    obs_r_kill_kf: jax.Array,  # (Obr,) int32 — right-obs rows to sever
    obs_r_kill_key: jax.Array,  # (Obr,) int32
    obs_r_kill: jax.Array,  # (Obr,) bool
) -> MapArrays:
    """Apply local-BA results under snapshot semantics (replaces the
    write-back under mapMutex at reference src/OptimizationBA.cpp:875-938):
    set optimized KF poses and landmark positions, sever wrong matches
    (left and right observation tables)."""
    # invalid rows redirect OUT OF RANGE and are dropped by the scatter —
    # a "scratch last slot" would be wrong here: the last KF slot is a
    # real keyframe once the capacity fills (the allocator grows only on
    # overflow), and aliasing it with live rows makes the duplicate-index
    # write order undefined
    W = m.kf_pose.shape[0]
    ks = jnp.where(kf_valid, kf_slots, W)
    kf_pose = m.kf_pose.at[ks].set(new_poses, mode="drop")
    P = m.lm_pos.shape[0]
    # P-1 IS a genuine scratch slot for landmarks (never allocated), but
    # drop-mode is uniform and avoids the dummy gather
    ls = jnp.where(lm_keep, lm_slots, P)
    lm_pos = m.lm_pos.at[ls].set(new_pts, mode="drop")
    kk = jnp.where(obs_kill, obs_kill_kf, W)
    obs_lm = m.obs_lm.at[kk, obs_kill_key].set(-1, mode="drop")
    rkk = jnp.where(obs_r_kill, obs_r_kill_kf, W)
    obs_r_lm = m.obs_r_lm.at[rkk, obs_r_kill_key].set(-1, mode="drop")
    # majority-descriptor upkeep: a severed (wrong-match) observation
    # leaves the landmark's observation set, so its descriptor leaves the
    # running bit-sum too — the reference gets this for free by
    # recomputing the median from the surviving kFMatches
    # (src/Map.cpp:145-210); without the subtraction one chi-squared-
    # killed wrong match would poison the majority forever. Right-camera
    # observations never contribute descriptors (the right table stores
    # no BRIEF), so only left kills are folded.
    kkf_s = jnp.where(obs_kill, obs_kill_kf, 0)
    kkey_s = jnp.where(obs_kill, obs_kill_key, 0)
    lm_of = m.obs_lm[kkf_s, kkey_s]  # pre-sever landmark of each killed row
    d16 = hamming.unpack_signed(m.obs_desc[kkf_s, kkey_s]).astype(jnp.int16)
    P_lm = m.lm_pos.shape[0]
    tgt = jnp.where(obs_kill & (lm_of >= 0), lm_of, P_lm)
    lm_bitsum = m.lm_bitsum.at[tgt].add(-d16, mode="drop")
    lm_nobs = m.lm_nobs.at[tgt].add(-1, mode="drop")
    tgt_safe = jnp.where(tgt < P_lm, tgt, 0)
    bs = lm_bitsum[tgt_safe]
    maj = jnp.where(bs > 0, 1, jnp.where(bs < 0, -1, m.lm_desc[tgt_safe])).astype(jnp.int8)
    lm_desc = m.lm_desc.at[tgt].set(maj, mode="drop")
    return dataclasses.replace(
        m, kf_pose=kf_pose, lm_pos=lm_pos, obs_lm=obs_lm, obs_r_lm=obs_r_lm,
        lm_bitsum=lm_bitsum, lm_nobs=lm_nobs, lm_desc=lm_desc,
    )


@functools.partial(jax.jit, static_argnames=("size",))
def gather_active(m: MapArrays, ids: jax.Array, size: int):
    """Compact (A,) landmark slots -> active-set arrays for tracking.
    ids must be padded with -1 to `size`."""
    valid = ids >= 0
    safe = jnp.where(valid, ids, 0)
    return {
        "ids": ids,
        "pos": m.lm_pos[safe],
        "desc": m.lm_desc[safe],
        "maxdist": m.lm_maxdist[safe],
        "mindist": m.lm_mindist[safe],
        "valid": valid & m.lm_valid[safe],
    }


class WorldMap:
    """Host-side facade: slot allocation, covisibility, host mirrors.

    The device arrays live in `self.arrays`; everything here is cheap
    numpy bookkeeping (the reference's Map id counters and KeyFrame
    covisibility graph, src/Map.cpp:295-300, src/KeyFrame.cpp:103-145).
    """

    def __init__(self, lm_capacity=1 << 16, kf_capacity=512, keys_per_kf=2048, right_obs_per_kf=256):
        self.arrays = make_map(lm_capacity, kf_capacity, keys_per_kf, right_obs_per_kf)
        self.lm_capacity = lm_capacity
        self.kf_capacity = kf_capacity
        self.keys_per_kf = keys_per_kf
        self.right_obs_per_kf = right_obs_per_kf
        self.n_landmarks = 0
        self.n_keyframes = 0
        self._alloc_lock = threading.Lock()
        # serializes read-modify-write updates of self.arrays (tracker KF
        # commits vs async local-BA write-backs; the reference's mapMutex,
        # include/Map.h:135 — here held only across the update *dispatch*,
        # never across device execution)
        self.update_lock = threading.RLock()
        # host mirrors
        self.kf_obs_lm = np.full((kf_capacity, keys_per_kf), -1, np.int64)
        self.kf_obs_r_lm = np.full((kf_capacity, right_obs_per_kf), -1, np.int64)
        self.kf_frame_idx = np.full(kf_capacity, -1, np.int64)
        self.kf_poses_host = np.tile(np.eye(4, dtype=np.float32), (kf_capacity, 1, 1))
        self.lm_first_kf = np.full(lm_capacity, -1, np.int64)

    def alloc_landmarks(self, count: int) -> np.ndarray:
        """Reserve `count` slots (the reference's map->pIdx counter). Grows
        the landmark axis when full — the reference's hash maps grow
        implicitly; here growth is a one-time array reallocation plus one
        recompile of the map-shaped programs."""
        while True:
            with self._alloc_lock:
                start = self.n_landmarks
                if start + count <= self.lm_capacity - 1:  # P-1 is the dump slot
                    self.n_landmarks = start + count
                    return np.arange(start, start + count, dtype=np.int32)
                need = start + count + 1
            # grow OUTSIDE _alloc_lock: the grow path takes update_lock, and
            # finish-paths take update_lock before _alloc_lock — keeping the
            # order one-way avoids a lock-order inversion
            self.grow_landmarks(need)

    def release_landmarks(self, slots: np.ndarray):
        """Return an unused contiguous tail of slots to the allocator (only
        possible while they are still the topmost allocation — e.g. the
        async tracker thread has not allocated past them)."""
        if len(slots) == 0:
            return
        with self._alloc_lock:
            if slots[-1] == self.n_landmarks - 1 and slots[0] + len(slots) == self.n_landmarks:
                self.n_landmarks = int(slots[0])

    def alloc_keyframe(self, frame_idx: int) -> int:
        slot = self.n_keyframes
        if slot >= self.kf_capacity:
            # long sequences (KITTI 00: ~4.5k frames, up to ~900 KFs) must
            # not hit a hard wall
            self.grow_keyframes(slot + 1)
        self.n_keyframes += 1
        self.kf_frame_idx[slot] = frame_idx
        return slot

    def grow_landmarks(self, min_capacity: int):
        """Double the landmark axis (device arrays + host mirrors) until it
        holds `min_capacity`. The old dump slot becomes an ordinary
        allocatable slot (it is never lm_valid, and a future scatter
        overwrites it)."""
        with self.update_lock:
            if min_capacity <= self.lm_capacity:
                return  # another thread grew first
            P_new = self.lm_capacity
            while P_new < min_capacity:
                P_new *= 2
            add = P_new - self.lm_capacity
            m = self.arrays
            self.arrays = dataclasses.replace(
                m,
                lm_pos=jnp.concatenate([m.lm_pos, jnp.zeros((add, 3), jnp.float32)]),
                lm_desc=jnp.concatenate([m.lm_desc, jnp.zeros((add, 256), jnp.int8)]),
                lm_maxdist=jnp.concatenate([m.lm_maxdist, jnp.zeros((add,), jnp.float32)]),
                lm_mindist=jnp.concatenate([m.lm_mindist, jnp.zeros((add,), jnp.float32)]),
                lm_valid=jnp.concatenate([m.lm_valid, jnp.zeros((add,), bool)]),
                lm_bitsum=jnp.concatenate([m.lm_bitsum, jnp.zeros((add, 256), jnp.int16)]),
                lm_nobs=jnp.concatenate([m.lm_nobs, jnp.zeros((add,), jnp.int16)]),
            )
            self.lm_first_kf = np.concatenate(
                [self.lm_first_kf, np.full(add, -1, np.int64)]
            )
            self.lm_capacity = P_new

    def grow_keyframes(self, min_capacity: int):
        """Double the keyframe axis (device arrays + host mirrors) until it
        holds `min_capacity`."""
        with self.update_lock:
            if min_capacity <= self.kf_capacity:
                return
            W_new = self.kf_capacity
            while W_new < min_capacity:
                W_new *= 2
            add = W_new - self.kf_capacity
            K, Kr = self.keys_per_kf, self.right_obs_per_kf
            m = self.arrays
            self.arrays = dataclasses.replace(
                m,
                kf_pose=jnp.concatenate(
                    [m.kf_pose, jnp.tile(jnp.eye(4, dtype=jnp.float32), (add, 1, 1))]
                ),
                kf_valid=jnp.concatenate([m.kf_valid, jnp.zeros((add,), bool)]),
                obs_uv=jnp.concatenate([m.obs_uv, jnp.zeros((add, K, 3), jnp.float32)]),
                obs_oct=jnp.concatenate([m.obs_oct, jnp.zeros((add, K), jnp.int32)]),
                obs_stereo=jnp.concatenate([m.obs_stereo, jnp.zeros((add, K), bool)]),
                obs_lm=jnp.concatenate([m.obs_lm, jnp.full((add, K), -1, jnp.int32)]),
                obs_desc=jnp.concatenate([m.obs_desc, jnp.zeros((add, K, 8), jnp.uint32)]),
                obs_valid=jnp.concatenate([m.obs_valid, jnp.zeros((add, K), bool)]),
                obs_r_uv=jnp.concatenate([m.obs_r_uv, jnp.zeros((add, Kr, 2), jnp.float32)]),
                obs_r_oct=jnp.concatenate([m.obs_r_oct, jnp.zeros((add, Kr), jnp.int32)]),
                obs_r_lm=jnp.concatenate([m.obs_r_lm, jnp.full((add, Kr), -1, jnp.int32)]),
            )
            self.kf_obs_lm = np.concatenate(
                [self.kf_obs_lm, np.full((add, K), -1, np.int64)]
            )
            self.kf_obs_r_lm = np.concatenate(
                [self.kf_obs_r_lm, np.full((add, Kr), -1, np.int64)]
            )
            self.kf_frame_idx = np.concatenate(
                [self.kf_frame_idx, np.full(add, -1, np.int64)]
            )
            self.kf_poses_host = np.concatenate(
                [self.kf_poses_host, np.tile(np.eye(4, dtype=np.float32), (add, 1, 1))]
            )
            self.kf_capacity = W_new

    def covisible_kfs(self, kf_slot: int, max_n: int = 10, min_weight: int = 15) -> np.ndarray:
        """Covisibility neighbors by shared-landmark count (reference
        KeyFrame::calcConnections weight >= 15, src/KeyFrame.cpp:103-145;
        N-best at 87-101). Returns slots sorted by weight, excluding self."""
        weights = self.covis_weights(kf_slot)
        if weights is None:
            return np.zeros((0,), np.int64)
        others = np.arange(self.n_keyframes)
        cand = others[(weights >= min_weight) & (others != kf_slot)]
        cand = cand[np.argsort(-weights[cand])]
        if len(cand) == 0:
            # fall back to the most recent previous KF so BA always has >= 2
            prev = kf_slot - 1
            return np.array([prev], np.int64) if prev >= 0 else np.zeros((0,), np.int64)
        return cand[:max_n]

    def covis_weights(self, kf_slot: int) -> np.ndarray | None:
        """Shared-landmark counts of every KF against `kf_slot`, as ONE
        vectorized membership test over the whole observation table —
        O(KFs x K log K) instead of the per-pair python loop that scaled
        O(KFs x K) python iterations (reference
        walks per-landmark observer maps instead, src/KeyFrame.cpp:103-145).
        Returns (n_keyframes,) int64 or None when covisibility is undefined."""
        ids = self.kf_obs_lm[kf_slot]
        ids = ids[ids >= 0]
        if len(ids) == 0 or self.n_keyframes <= 1:
            return None
        tbl = self.kf_obs_lm[: self.n_keyframes]  # (n, K)
        shared = np.isin(tbl, ids) & (tbl >= 0)
        return shared.sum(axis=1).astype(np.int64)

    def observers_of(self, lm_ids: np.ndarray, exclude: np.ndarray, max_n: int) -> np.ndarray:
        """KF slots (outside `exclude`) that observe any of `lm_ids`, sorted
        by observation count descending, at most `max_n`. Used to collect the
        gauge-anchor keyframes of local BA (the reference adds every
        out-of-window observer as a fixed pose,
        src/OptimizationBA.cpp:445-516)."""
        if len(lm_ids) == 0 or self.n_keyframes == 0:
            return np.zeros((0,), np.int64)
        tbl = self.kf_obs_lm[: self.n_keyframes]
        counts = (np.isin(tbl, lm_ids) & (tbl >= 0)).sum(axis=1)
        counts[np.asarray(exclude, np.int64)] = 0
        cand = np.nonzero(counts > 0)[0]
        cand = cand[np.argsort(-counts[cand], kind="stable")]
        return cand[:max_n].astype(np.int64)
