"""Loop closure: detection, landmark merge, pose-graph correction.

The reference carries loop-closure STATE (include/Map.h:122-127,
KeyFrame::LCPose) and checks its flags in both threads — but no detector
ever sets them; LC is vestigial (SURVEY.md §2 quirks). This module makes
it real, as batched device programs:

1. DETECT — when a new keyframe is inserted, its stored observation
   descriptors sweep every keyframe's table (models/reloc.keyframe_votes,
   a lax.map of Hamming matmuls), excluding the covisible set and the
   `min_gap` most recent keyframes (those match trivially).
2. VERIFY — the candidate must pass the geometric check: the new KF's
   keys matched to the old KF's landmark-bearing keys, then a motion-only
   LM from the old KF's pose must find a chi-squared-consistent inlier
   set. This yields the new camera's pose IN THE OLD (drift-free-er) part
   of the map, i.e. the loop edge measurement.
3. CORRECT — an SE(3) pose graph (models/pose_graph) over all keyframes:
   the odometry chain (relative poses from current estimates, the same
   self-referential construction the reference's BetweenFactor chain
   uses) plus the verified loop edge. This distributes the accumulated
   drift along the trajectory — global BA alone cannot do it (the stiff
   odometry chain holds the drifted shape and the chi-squared sweep kills
   the loop landmarks' huge residuals).
4. MERGE + RE-ANCHOR — duplicate landmarks (the new KF re-observed old
   structure under new ids) are merged old<-new by a device-side id remap
   over the observation tables, and every landmark moves rigidly with its
   first observing keyframe's pose-graph correction. A follow-up
   `LocalMapper.run_global` then polishes the now-consistent map.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.models import map_state, pose_graph, reloc
from vslam_tpu.ops import hamming

MIN_GAP = 12  # keyframes that must separate a loop pair (else it's covis)
ODO_WEIGHT = 100.0  # 1/sigma of the chain edges (reference sigma 0.01)
LOOP_WEIGHT = 100.0


@jax.jit
def _apply_correction(
    m: map_state.MapArrays,
    new_poses: jax.Array,  # (Wg, 4, 4) pose-graph output (padded)
    kf_valid: jax.Array,  # (Wg,) bool
    delta: jax.Array,  # (Wg, 4, 4) T_new @ inv(T_old) per keyframe
    lm_anchor: jax.Array,  # (P,) int32 first observing KF (or 0)
    lm_touch: jax.Array,  # (P,) bool — landmarks to move
    remap: jax.Array,  # (P,) int32 landmark id remap (identity + merges)
    merged_away: jax.Array,  # (P,) bool — ids merged into another id
):
    """One fused write-back: keyframe poses, rigidly-moved landmarks,
    observation-table id remap, merged-slot invalidation."""
    W = m.kf_pose.shape[0]
    Wg = new_poses.shape[0]
    idx = jnp.arange(Wg)
    ks = jnp.where(kf_valid, idx, W)
    kf_pose = m.kf_pose.at[ks].set(new_poses, mode="drop")

    d = delta[jnp.clip(lm_anchor, 0, Wg - 1)]  # (P, 4, 4)
    moved = jnp.einsum("pij,pj->pi", d[:, :3, :3], m.lm_pos) + d[:, :3, 3]
    lm_pos = jnp.where(lm_touch[:, None], moved, m.lm_pos)

    obs_lm = jnp.where(m.obs_lm >= 0, remap[jnp.clip(m.obs_lm, 0, None)], -1)
    obs_r_lm = jnp.where(
        m.obs_r_lm >= 0, remap[jnp.clip(m.obs_r_lm, 0, None)], -1
    )
    lm_valid = m.lm_valid & ~merged_away
    # fold each merged-away landmark's descriptor accumulator into its
    # remap target: the merged observations now belong to the target's
    # observation set, and writeback_ba SUBTRACTS a killed observation's
    # descriptor from lm_bitsum[obs_lm] — without this fold a post-merge
    # chi-squared kill would subtract a never-added descriptor, drifting
    # lm_nobs negative and corrupting the majority descriptor (same
    # invariant _apply_triangulation documents for the add side).
    P = m.lm_pos.shape[0]
    contrib = jnp.where(merged_away[:, None], m.lm_bitsum, 0)
    cnt = jnp.where(merged_away, m.lm_nobs, 0)
    tgt = jnp.where(merged_away, remap, P)
    lm_bitsum = m.lm_bitsum.at[tgt].add(contrib, mode="drop")
    lm_nobs = m.lm_nobs.at[tgt].add(cnt, mode="drop")
    tgt_safe = jnp.where(merged_away, remap, 0)
    bs = lm_bitsum[tgt_safe]
    maj = jnp.where(
        bs > 0, 1, jnp.where(bs < 0, -1, m.lm_desc[tgt_safe])
    ).astype(jnp.int8)
    lm_desc = m.lm_desc.at[tgt].set(maj, mode="drop")
    return dataclasses.replace(
        m,
        kf_pose=kf_pose,
        lm_pos=lm_pos,
        obs_lm=obs_lm.astype(jnp.int32),
        obs_r_lm=obs_r_lm.astype(jnp.int32),
        lm_valid=lm_valid,
        lm_bitsum=lm_bitsum,
        lm_nobs=lm_nobs,
        lm_desc=lm_desc,
    )


MIN_MERGED = 30  # duplicate-landmark pairs a closure must find: a real
# revisit re-observes old STRUCTURE, so dozens of its new landmarks are
# duplicates of old ones; an aliased verification (a wrong pose that
# happened to pass the chi-squared check) finds few. Measured on the
# bench circuit: genuine closures merged 95-152 pairs, the one bad edge
# (which quadrupled the final ATE) merged 21. An absolute pose-graph
# error gate cannot do this job — genuinely-large drift also relaxes to
# a large residual (the split-map test's 24 cm offset leaves 1.3/edge).


class LoopCloser:
    def __init__(self, world: map_state.WorldMap, K, baseline, min_votes: int = 60, min_inliers: int = 30, min_gap: int = MIN_GAP):
        self.world = world
        self.K = np.asarray(K, np.float32)
        self.baseline = float(baseline)
        self.min_votes = min_votes
        self.min_inliers = min_inliers
        self.min_gap = min_gap
        self.closures = 0
        self._last_cand = None  # (kf_slot, old_kf) of the last detection
        # keyframe slot before which detection stays suppressed after an
        # APPLIED closure: the seam was just closed and polished — the
        # immediately following keyframes would re-derive essentially the
        # same edge from the same evidence. Kept SHORT (4 keyframes):
        # MIN_MERGED is the defense against bad edges, and a long
        # cooldown measurably hurts — suppressing re-closures for
        # min_gap=12 KFs left the final 0.2 lap of the bench circuit
        # uncorrected (ATE 0.096 vs 0.058 with closures allowed).
        self.cooldown_kfs = 4
        self._cooldown_until = -1
        # ACCEPTED loop-edge measurements, persisted across closures: a
        # multi-loop run re-optimizes the graph with the PREVIOUS loop
        # edges included (up to 3 + the new one), so distributing a new
        # closure's drift cannot silently re-open an old seam — relative
        # measurements are coordinate-free, and an already-applied edge
        # sits at ~zero residual, pinning its seam while the chain flexes
        self._edges: list[tuple[int, int, np.ndarray]] = []

    # ------------------------------------------------------------------
    def detect(self, kf_slot: int) -> tuple[int, np.ndarray | None]:
        """Candidate old keyframe for a loop at `kf_slot`, with the
        geometrically-verified pose of kf_slot's camera in the old map
        region. Returns (-1, None) if none."""
        w = self.world
        n = w.n_keyframes
        if n < self.min_gap + 2 or kf_slot < self.min_gap:
            return -1, None
        if kf_slot < self._cooldown_until:
            return -1, None
        keys = types.SimpleNamespace(
            desc=hamming.unpack_signed(w.arrays.obs_desc[kf_slot]),
            valid=w.arrays.obs_valid[kf_slot],
            xy=w.arrays.obs_uv[kf_slot][:, :2],
        )
        # sweep only the live keyframe prefix, padded to a doubling menu
        # of static shapes (the full kf_capacity sweep wastes W/n of the
        # work and the per-shape recompiles are log2-bounded)
        Wc = 16
        while Wc < n and Wc < w.kf_capacity:
            Wc *= 2
        Wc = min(Wc, w.kf_capacity)
        votes = np.zeros(max(w.kf_capacity, Wc), np.int64)
        votes[:Wc] = np.array(
            reloc.keyframe_votes(
                w.arrays.obs_desc[:Wc],
                w.arrays.obs_valid[:Wc],
                w.arrays.kf_valid[:Wc],
                keys.desc,
                keys.valid,
            )
        )
        votes[n:] = 0
        # exclude the trivially-matching neighborhood: recent KFs + every
        # TRULY covisible KF (uncapped, weight >= the reference's
        # covisibility threshold, src/KeyFrame.cpp:133). The threshold
        # matters at both ends: a capped top-N once let a weakly-covis
        # keyframe through as a "loop" (self-similar-corridor false
        # positive), while excluding at weight >= 1 suppressed a TRUE
        # revisit — re-observing a handful of boundary landmarks is
        # exactly what closing a loop looks like, not a trivial match
        votes_raw = votes.copy()
        # SYMMETRIC temporal exclusion: detection runs deferred (after the
        # async-BA consume), so keyframes NEWER than kf_slot can already
        # exist — and trivially match it. A one-sided window let slot 38
        # retrieve as a "loop" for slot 37 on the bench circuit (caught by
        # the merge gate, but it must never reach verification).
        votes[max(0, kf_slot - self.min_gap) : kf_slot + self.min_gap + 1] = 0
        covis = w.covisible_kfs(kf_slot, max_n=n, min_weight=15)
        votes[covis] = 0
        best = int(np.argmax(votes))
        if votes[best] < self.min_votes:
            return -1, None
        # contiguity support: a real revisit re-observes a RUN of old
        # keyframes (the visible arc spans several), so the neighbors of
        # the peak must vote too; an aliasing spike is solitary. Support
        # is evaluated on the PRE-exclusion votes: a neighbor can fall
        # inside the just-zeroed covisible/recent window and its zeroed
        # count would wrongly suppress a true peak (its raw votes are
        # still honest evidence of the revisit's spatial extent).
        lo, hi = max(0, best - 2), min(n, best + 3)
        neighbors = np.delete(votes_raw[lo:hi], best - lo)
        if (neighbors >= self.min_votes // 2).sum() < 1:
            return -1, None
        T_opt, n_inl, n_match = reloc._verify_candidate(
            w.arrays,
            jnp.int32(best),
            keys.xy,
            keys.desc,
            keys.valid,
            jnp.asarray(self.K),
            jnp.float32(self.baseline),
        )
        if (
            int(n_inl) < self.min_inliers
            or int(n_inl) < reloc.MIN_INLIER_FRAC * int(n_match)
        ):
            return -1, None
        T_opt = np.asarray(T_opt)
        if not np.isfinite(T_opt).all():
            return -1, None
        return best, T_opt

    # ------------------------------------------------------------------
    def close(self, kf_slot: int, old_kf: int, T_loop: np.ndarray) -> dict:
        """Apply the closure: pose graph over all keyframes with the loop
        edge inv(pose_old) @ T_loop between (old_kf, kf_slot), rigid
        landmark re-anchoring, duplicate-landmark merge. Returns
        re-anchoring info ({kf_slot, old_pose, new_pose}) for the
        tracker."""
        w = self.world
        n = w.n_keyframes
        old_last = w.kf_poses_host[kf_slot].copy()

        # ---- structural gate (computed BEFORE any map mutation): a real
        # revisit finds many duplicate landmarks; too few means the
        # verified pose is an aliasing accident (see MIN_MERGED) ----
        pairs = self._merge_pairs(kf_slot, old_kf)
        if len(pairs) < MIN_MERGED:
            print(
                f"[loop_closure] REJECT edge {old_kf}->{kf_slot}: only "
                f"{len(pairs)} duplicate landmarks (< {MIN_MERGED}) — "
                f"aliased verification"
            )
            return None

        # ---- pose graph ----
        Wg = 1
        while Wg < n:
            Wg *= 2
        poses = np.tile(np.eye(4, dtype=np.float32), (Wg, 1, 1))
        poses[:n] = w.kf_poses_host[:n]
        valid = np.zeros(Wg, bool)
        valid[:n] = True
        inv_poses = np.linalg.inv(poses[:n])
        chain_rel = np.tile(np.eye(4, dtype=np.float32), (max(Wg - 1, 1), 1, 1))
        chain_rel[: n - 1] = np.einsum(
            "kij,kjl->kil", inv_poses[:-1], poses[1:n]
        )
        chain_w = np.zeros(max(Wg - 1, 1), np.float32)
        chain_w[: n - 1] = ODO_WEIGHT
        rel_loop = inv_poses[old_kf] @ T_loop

        if float(self.baseline) == 0.0:
            # MONOCULAR closure: Sim(3) graph (Strasdat / ORB-SLAM) —
            # mono drifts in SCALE too, and an SE(3) loop edge cannot
            # absorb a scale discrepancy (measured: closing a
            # scale-drifted mono leg over SE(3) warps the map,
            # BASELINE.md "Mono drift envelope"). The loop edge's
            # relative scale comes from a scaled Umeyama fit of the
            # merged duplicate-landmark pairs — the Horn-alignment Sim3
            # measurement. Landmarks move by the FULL Sim(3) per-KF
            # delta; camera poses keep the SE(3) part.
            from vslam_tpu.geometry import sim3 as sim3_mod
            from vslam_tpu.utils import trajectory as traj_mod

            lm_pos = np.asarray(w.arrays.lm_pos)
            new_ids = np.asarray([a for a, _ in pairs])
            old_ids = np.asarray([b for _, b in pairs])
            R_c, t_c, s_c = traj_mod.umeyama_alignment(
                lm_pos[new_ids], lm_pos[old_ids], with_scale=True
            )
            S_corr = np.eye(4, dtype=np.float32)
            S_corr[:3, :3] = (s_c * R_c).astype(np.float32)
            S_corr[:3, 3] = t_c.astype(np.float32)
            # measured loop edge: Z = S_o^-1 S_corr S_n (at the optimum
            # S_n' = S_corr S_n with S_o held)
            S_o = poses[old_kf].copy()
            S_n = poses[kf_slot].copy()
            Z_loop = (np.linalg.inv(S_o) @ S_corr @ S_n).astype(np.float32)
            li, lj, lrel, lw = self._loop_edge_arrays(old_kf, kf_slot, Z_loop)
            S_opt, err = pose_graph.optimize_sim3_chain(
                jnp.asarray(poses),
                jnp.asarray(valid),
                jnp.asarray(chain_rel),
                jnp.asarray(chain_w),
                jnp.asarray(li),
                jnp.asarray(lj),
                jnp.asarray(lrel),
                jnp.asarray(lw),
                iters=30,
            )
            new_poses = sim3_mod.to_se3(S_opt)
            # landmark correction: full Sim(3) delta per anchor keyframe
            sim3_delta = np.asarray(
                S_opt @ sim3_mod.inverse(jnp.asarray(poses))
            ).astype(np.float32)
        elif n > 128:
            # chain+loops structure: O(P)/iteration block-Thomas +
            # Woodbury path (the dense (P,P,6,6) Hessian is 604 MB at
            # P=2048) — equivalence-tested against
            # the dense path in tests/test_loop_closure.py
            li, lj, lrel, lw = self._loop_edge_arrays(
                old_kf, kf_slot, rel_loop
            )
            new_poses, err = pose_graph.optimize_chain(
                jnp.asarray(poses),
                jnp.asarray(valid),
                jnp.asarray(chain_rel),
                jnp.asarray(chain_w),
                jnp.asarray(li),
                jnp.asarray(lj),
                jnp.asarray(lrel),
                jnp.asarray(lw),
                iters=25,
            )
        else:
            li, lj, lrel, lw = self._loop_edge_arrays(
                old_kf, kf_slot, rel_loop
            )
            E = Wg + len(li)  # n-1 chain edges + loop edges, padded
            ei = np.zeros(E, np.int32)
            ej = np.zeros(E, np.int32)
            rel = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
            ew = np.zeros(E, np.float32)
            ei[: n - 1] = np.arange(n - 1)
            ej[: n - 1] = np.arange(1, n)
            rel[: n - 1] = chain_rel[: n - 1]
            ew[: n - 1] = ODO_WEIGHT
            ei[n - 1 : n - 1 + len(li)] = li
            ej[n - 1 : n - 1 + len(lj)] = lj
            rel[n - 1 : n - 1 + len(li)] = lrel
            ew[n - 1 : n - 1 + len(li)] = lw
            new_poses, err = pose_graph.optimize(
                jnp.asarray(poses),
                jnp.asarray(valid),
                jnp.asarray(ei),
                jnp.asarray(ej),
                jnp.asarray(rel),
                jnp.asarray(ew),
                iters=25,
            )
        new_poses_np = np.asarray(new_poses)
        if not (
            np.isfinite(float(err))
            and np.isfinite(new_poses_np[:n]).all()
        ):
            # a diverged pose graph must never be written into the map
            # (one NaN keyframe pose poisons every descendant frame pose)
            return None

        # ---- landmark anchors: first observing keyframe (left AND
        # right-camera tables — a landmark observed only in the right
        # table must still move with its keyframe, else it is left at its
        # drifted position while every pose moves) ----
        P = w.lm_capacity
        anchor = np.full(P, -1, np.int64)
        for k in range(n - 1, -1, -1):  # descending: earliest KF wins
            ids = w.kf_obs_lm[k]
            ids = ids[ids >= 0]
            anchor[ids] = k
            ids_r = w.kf_obs_r_lm[k]
            ids_r = ids_r[ids_r >= 0]
            anchor[ids_r] = k
        touched = anchor >= 0
        if float(self.baseline) == 0.0:
            delta = sim3_delta  # full Sim(3) per-KF correction (mono)
        else:
            delta = np.einsum(
                "kij,kjl->kil",
                new_poses_np[:Wg],
                np.linalg.inv(poses[:Wg]),
            ).astype(np.float32)

        # ---- duplicate merge: new KF's landmarks vs old KF's, matched by
        # descriptor among the verified region (old id wins) ----
        remap = np.arange(P, dtype=np.int64)
        merged = np.zeros(P, bool)
        for new_id, old_id in pairs:
            if new_id != old_id and not merged[old_id]:
                remap[new_id] = old_id
                merged[new_id] = True

        with w.update_lock:
            w.arrays = _apply_correction(
                w.arrays,
                new_poses,
                jnp.asarray(valid),
                jnp.asarray(delta),
                jnp.asarray(np.maximum(anchor, 0), jnp.int32),
                jnp.asarray(touched),
                jnp.asarray(remap, jnp.int32),
                jnp.asarray(merged),
            )
            w.kf_poses_host[:n] = new_poses_np[:n]
            live = w.kf_obs_lm >= 0
            w.kf_obs_lm[live] = remap[w.kf_obs_lm[live]]
            live_r = w.kf_obs_r_lm >= 0
            w.kf_obs_r_lm[live_r] = remap[w.kf_obs_r_lm[live_r]]
        self.closures += 1
        # persist the accepted edge (Sim(3)-valued in mono — same (4,4)
        # representation) for subsequent closures' graphs
        self._edges.append(
            (
                old_kf,
                kf_slot,
                (Z_loop if float(self.baseline) == 0.0 else rel_loop).copy(),
            )
        )
        return {
            "kf_slot": kf_slot,
            "old_kf": old_kf,
            "old_pose": old_last,
            "new_pose": w.kf_poses_host[kf_slot].copy(),
            "pose_graph_error": float(err),
            "n_merged": int(merged.sum()),
        }

    def _loop_edge_arrays(self, old_kf: int, kf_slot: int, rel: np.ndarray):
        """Padded (4,)-slot loop-edge arrays: the NEW edge in slot 0 plus
        up to 3 previously-accepted edges (see self._edges). The new edge
        is NOT yet persisted — close() appends it only after the
        correction is actually written back."""
        L = 4
        li = np.zeros(L, np.int32)
        lj = np.zeros(L, np.int32)
        lrel = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        lw = np.zeros(L, np.float32)
        li[0], lj[0], lrel[0], lw[0] = old_kf, kf_slot, rel, LOOP_WEIGHT
        for k, (i, j, z) in enumerate(self._edges[-(L - 1):], start=1):
            li[k], lj[k], lrel[k], lw[k] = i, j, z, LOOP_WEIGHT
        return li, lj, lrel, lw

    def _merge_pairs(self, kf_new: int, kf_old: int) -> list[tuple[int, int]]:
        """(new_lm, old_lm) pairs: keys of the two keyframes matched by
        descriptor where both carry landmarks."""
        w = self.world
        dn = hamming.unpack_signed_np(w.arrays.obs_desc[kf_new]).astype(np.int32)
        do = hamming.unpack_signed_np(w.arrays.obs_desc[kf_old]).astype(np.int32)
        vn = np.array(w.arrays.obs_valid[kf_new])
        vo = np.array(w.arrays.obs_valid[kf_old])
        ln = w.kf_obs_lm[kf_new]
        lo = w.kf_obs_lm[kf_old]
        d = (dn.shape[1] - dn @ do.T) * 0.5  # Hamming
        d[~vn | (ln < 0)] = 1e9
        d[:, ~vo | (lo < 0)] = 1e9
        best = np.argmin(d, axis=1)
        bd = d[np.arange(len(best)), best]
        ok = bd <= reloc.RETRIEVAL_DESC_THR
        return [
            (int(ln[i]), int(lo[best[i]]))
            for i in np.nonzero(ok)[0]
            if ln[i] >= 0 and lo[best[i]] >= 0
        ]

    # ------------------------------------------------------------------
    def try_close(self, kf_slot: int) -> dict | None:
        old_kf, T_loop = self.detect(kf_slot)
        if old_kf < 0:
            return None
        # temporal consistency: two CONSECUTIVE keyframes must retrieve
        # the same old region (within the visible-arc span) before a
        # closure is applied — systematic aliasing can fake one
        # geometric verification, but two agreeing verifications from
        # different poses make the loop edge trustworthy (the same
        # consecutive-detection rule ORB-SLAM's DBoW detector uses).
        prev = self._last_cand
        self._last_cand = (kf_slot, old_kf)
        if prev is None or kf_slot - prev[0] > 3 or abs(old_kf - prev[1]) > 4:
            return None
        r = self.close(kf_slot, old_kf, T_loop)
        if r is not None:
            self._last_cand = None  # don't chain off a just-closed loop
            self._cooldown_until = kf_slot + self.cooldown_kfs
        return r
