"""Relocalization: descriptor retrieval against every keyframe.

The reference has NO relocalization — lost tracking dead-reckons forever
(SURVEY.md §5 failure-detection row; its loop-closure state is vestigial
and never driven). This module adds a batched version of the
standard recovery: when the tracker has refused `reseed_after`
consecutive solves, the current frame's descriptors are matched against
the observation tables of EVERY keyframe — one masked Hamming sweep,
expressed as a `lax.map` of (N x K) matmuls over keyframe slots — and
the best-voted keyframe re-anchors tracking: pose reset to that
keyframe, active set reloaded with its (and its covisible neighbors')
landmarks, and the normal wide-radius matching re-acquires on the OLD
map. Only if retrieval finds nothing does the tracker fall back to the
map re-seed (which starts a new, rigidly-offset map).

Retrieval cost: W x (N x K x 256) int8 matmuls ~ 0.5 GFLOP per 128
keyframes, paid once per loss event.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.ops import hamming

RETRIEVAL_DESC_THR = 50.0  # Hamming distance counted as a vote
MIN_VOTES = 50  # matched keys needed to accept a retrieved keyframe
MIN_INLIER_FRAC = 0.25  # verified-inlier fraction of ratio-tested matches


@functools.partial(jax.jit, static_argnames=())
def keyframe_votes(
    obs_desc: jax.Array,  # (W, K, 8) uint32 bit-packed per-KF key descriptors
    obs_valid: jax.Array,  # (W, K) bool
    kf_valid: jax.Array,  # (W,) bool
    frame_desc: jax.Array,  # (N, 256) int8 +-1 current-frame descriptors
    frame_valid: jax.Array,  # (N,) bool
) -> jax.Array:
    """(W,) votes: how many current-frame keys have a Hamming match
    < RETRIEVAL_DESC_THR among keyframe w's keys. lax.map keeps the
    (N, W*K) distance matrix from ever materializing (it would be
    ~0.5 GB at driver scale)."""
    fd = frame_desc.astype(jnp.float32)
    n_bits = frame_desc.shape[1]

    def one_kf(args):
        kd, kv, ok = args
        kd_s = hamming.unpack_signed(kd)  # (K, 256) from the packed store
        dot = fd @ kd_s.astype(jnp.float32).T  # (N, K)
        d = (n_bits - dot) * 0.5
        d = jnp.where(frame_valid[:, None] & kv[None, :], d, 1e9)
        best = jnp.min(d, axis=1)  # (N,)
        return jnp.where(ok, jnp.sum(best < RETRIEVAL_DESC_THR), 0).astype(
            jnp.int32
        )

    return jax.lax.map(one_kf, (obs_desc, obs_valid, kf_valid))


@jax.jit
def _verify_candidate(
    m, kf_slot, keys_xy, keys_desc, keys_valid, K, baseline
):
    """PnP-style geometric verification of a retrieved keyframe: match the
    frame's keys to the keyframe's LANDMARK-bearing keys by descriptor,
    then run the motion-only LM from the keyframe's pose. Descriptor
    votes alone false-positive across unrelated scenes (corner
    descriptors cluster by texture family); a pose with a chi-squared
    consistent inlier set cannot. Returns (T_opt, n_inliers)."""
    from vslam_tpu.ops import lm

    kd = hamming.unpack_signed(m.obs_desc[kf_slot])
    kv = m.obs_valid[kf_slot] & (m.obs_lm[kf_slot] >= 0)
    d = hamming.hamming_matrix(keys_desc, kd, keys_valid, kv)
    best = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best[:, None], 1)[:, 0]
    # best/second RATIO test (the reference runs one on every projection
    # matcher, include/FeatureMatcher.h:27-30; without it, descriptor-
    # family aliasing floods the verification solve with wrong
    # correspondences — measured: a self-retrieval on a rendered scene
    # matched 738 keys onto 144 landmark-bearing ones and the LM
    # diverged 24 m with zero inliers). The second-best is taken OUTSIDE
    # a 3 px radius of the best match: multi-octave duplicate keys of the
    # same corner carry near-identical descriptors, and counting them as
    # "second" vetoes true matches (same exclusion
    # _triangulate_new_points_mono uses).
    kxy = m.obs_uv[kf_slot][:, :2]
    best_xy = kxy[jnp.clip(best, 0, kxy.shape[0] - 1)]  # (N, 2)
    near = (
        jnp.sum((kxy[None, :, :] - best_xy[:, None, :]) ** 2, axis=-1) < 9.0
    )  # (N, K)
    second_d = jnp.min(jnp.where(near, hamming.INVALID, d), axis=1)
    match = (best_d <= RETRIEVAL_DESC_THR) & (best_d <= 0.8 * second_d)
    safe = jnp.where(match, best, 0)
    lm_ids = m.obs_lm[kf_slot][safe]
    P = m.lm_pos.shape[0]
    pts = m.lm_pos[jnp.clip(lm_ids, 0, P - 1)]
    match = match & (lm_ids >= 0) & m.lm_valid[jnp.clip(lm_ids, 0, P - 1)]
    N = keys_xy.shape[0]
    obs = jnp.concatenate(
        [keys_xy[:, :2], jnp.full((N, 1), -1.0)], axis=-1
    )
    w8 = jnp.ones((N,), jnp.float32)
    T0 = m.kf_pose[kf_slot]
    T_opt, chi2, inl, _st, _ = lm.motion_only_ba(
        T0, pts, obs, w8,
        jnp.zeros((N,), bool), jnp.zeros((N,), bool), match,
        K, baseline, max_iters=50,
    )
    return T_opt, jnp.sum(inl), jnp.sum(match)


def retrieve(world, keys, n_keyframes: int, K, baseline=0.0, min_inliers: int = 25):
    """Best keyframe slot for the current frame's keys, geometrically
    verified. Returns (slot, votes, T_opt) — slot=-1 when no keyframe
    clears MIN_VOTES or the verification solve finds < min_inliers
    chi-squared-consistent matches."""
    # sweep only the live keyframe prefix, padded to a doubling menu of
    # static shapes (log2-bounded recompiles; the full-capacity sweep
    # wastes capacity/n of the work)
    Wc = 16
    while Wc < n_keyframes and Wc < world.kf_capacity:
        Wc *= 2
    Wc = min(Wc, world.kf_capacity)
    votes = np.zeros(max(world.kf_capacity, Wc), np.int64)
    votes[:Wc] = np.array(
        keyframe_votes(
            world.arrays.obs_desc[:Wc],
            world.arrays.obs_valid[:Wc],
            world.arrays.kf_valid[:Wc],
            keys.desc,
            keys.valid,
        )
    )
    votes[n_keyframes:] = 0
    best = int(np.argmax(votes))
    if votes[best] < MIN_VOTES:
        return -1, int(votes[best]), None
    T_opt, n_inl, n_match = _verify_candidate(
        world.arrays,
        jnp.int32(best),
        keys.xy,
        keys.desc,
        keys.valid,
        jnp.asarray(K, jnp.float32),
        jnp.float32(baseline),
    )
    # absolute floor AND inlier FRACTION of the ratio-tested matches: a
    # genuine revisit verifies most of its matches (measured ~0.5+ on a
    # self-retrieval), while a false candidate's chi-squared-consistent
    # subset is a small accident of the match cloud (measured ~0.08 on a
    # teleport scene) — the fraction separates them where the absolute
    # count alone false-positives
    if (
        int(n_inl) < min_inliers
        or int(n_inl) < MIN_INLIER_FRAC * int(n_match)
        or not np.isfinite(np.asarray(T_opt)).all()
    ):
        return -1, int(votes[best]), None
    return best, int(votes[best]), np.asarray(T_opt)
