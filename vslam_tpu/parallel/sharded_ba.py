"""Distributed local/global bundle adjustment over a device mesh.

The Schur-complement reduced camera system is a sum over landmarks of
per-landmark outer products,

    S = Hpp - sum_l Hpl[:, l] Hll[l]^-1 Hpl[:, l]^T,

and the blocked normal equations are a sum over OBSERVATIONS of
per-observation outer products — so sharding the observation rows over
the mesh makes each device linearize only its own slice (the O(O)
Jacobian work), one psum assembles the full normal equations, and the
dominant O(W^2 L) reduction is sharded over landmark slabs inside
``ops.schur._schur_solve``. Poses and landmarks stay replicated (they
are small), as does the 6Wx6W dense solve.

This wraps the SAME kernel the single-device mapper runs
(:func:`vslam_tpu.ops.schur.local_ba_two_rounds` with ``axis_name``), so
the sharded solve keeps the full semantics — LM accept/reject on psum'd
errors, GTSAM relativeErrorTol early exit, the 2-round chi-squared sweep
— and matches the single-device result to float reduction order. It
scales the reference's single-threaded GTSAM window BA over several
devices (SURVEY.md §5 long-context mapping); the same shard_map runs over
a multi-process mesh (tests/test_distributed.py).
"""

from __future__ import annotations

import functools

import jax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from vslam_tpu.ops import schur

AXIS = "ba"


def sharded_two_rounds(
    mesh: Mesh, iters1: int = 5, iters2: int = 10, n_slabs: int = 1
):
    """Build a jitted sharded 2-round local BA over `mesh`.

    ALL inputs are replicated — the sharding is over the COMPUTATION's
    landmark dimension (each shard scatter-assembles and reduces only its
    landmark slab; see ops.schur._assemble). That means no input
    resharding, no observation-partition preprocessing, and the only
    collectives are the psum of the (6W)^2 reduced system and the
    all_gather of landmark deltas. The landmark count must be divisible
    by the mesh size. Returns (poses, pts, err, kill), all replicated.

    `n_slabs > 1` additionally chunks each shard's Schur reduction over
    sequential landmark slabs (schur._schur_solve_sharded_slabbed) — the
    map-scale global-BA composition: per-shard memory holds one
    (W, L/n_slabs, 6, 3) slab while reduction compute still scales
    1/mesh. Requires L % (n_slabs * mesh_size) == 0.
    """
    n_in = 16

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=tuple(P() for _ in range(n_in)),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    def run(poses, fixed, pose_valid, pts, pt_valid,
            obs_kf, obs_lm, obs_uv, obs_stereo, obs_right, obs_w, obs_valid,
            K, baseline, odo_rel, odo_valid):
        p = schur.BAProblem(
            poses=poses, fixed=fixed, pose_valid=pose_valid,
            pts=pts, pt_valid=pt_valid,
            obs_kf=obs_kf, obs_lm=obs_lm, obs_uv=obs_uv,
            obs_stereo=obs_stereo, obs_right=obs_right,
            obs_w=obs_w, obs_valid=obs_valid,
            K=K, baseline=baseline,
            odo_rel=odo_rel, odo_valid=odo_valid,
        )
        p2, err, kill = schur.local_ba_two_rounds(
            p, iters1=iters1, iters2=iters2, axis_name=AXIS, n_slabs=n_slabs
        )
        return p2.poses, p2.pts, err, kill

    return jax.jit(run)


def run_problem(step_fn, p: schur.BAProblem):
    """Apply a :func:`sharded_two_rounds` function to a BAProblem.
    Returns (p2, err, kill) exactly like ``schur.local_ba_two_rounds``."""
    poses, pts, err, kill = step_fn(
        p.poses, p.fixed, p.pose_valid, p.pts, p.pt_valid,
        p.obs_kf, p.obs_lm, p.obs_uv, p.obs_stereo, p.obs_right,
        p.obs_w, p.obs_valid, p.K, p.baseline, p.odo_rel, p.odo_valid,
    )
    return p._replace(poses=poses, pts=pts), err, kill
