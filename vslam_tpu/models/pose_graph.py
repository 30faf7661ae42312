"""SE(3) pose-graph optimization (loop-closure correction).

Given keyframe poses, a chain of odometry edges (relative poses taken
from the current estimates, like the reference's BetweenFactor chain,
src/OptimizationBA.cpp:750-768) and one or more LOOP edges (relative
poses measured by geometrically-verified relocalization against an old
keyframe), minimize

    sum_e || log( Z_e^-1 * T_i^-1 * T_j ) ||^2 * w_e

over all poses with pose 0 fixed. This distributes the accumulated loop
error along the trajectory BEFORE bundle adjustment — running global BA
directly on a drifted loop fails, because the self-referential odometry
chain holds the drifted shape while the chi-squared sweep kills the
merged landmarks' (large) reprojection residuals.

Fixed shapes: P pose slots + E edge slots, masked; one Gauss-Newton
iteration is a dense (6P x 6P) solve (P <= ~1k keyframes -> <= 6k x 6k,
fine on one chip). The whole loop is a lax.while_loop with accept/reject
damping like ops/schur.

The reference has no pose graph at all — its loop-closure fields are
vestigial (include/Map.h:122-127, never driven; SURVEY.md quirks).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vslam_tpu.geometry import se3


def _edge_residuals(poses, ei, ej, rel, w):
    """(E, 6) weighted log-residuals of relative-pose edges."""

    def one(i, j, Z, wt):
        r = se3.se3_logmap(
            se3.inverse(Z) @ se3.inverse(poses[i]) @ poses[j]
        )
        return r * wt

    return jax.vmap(one)(ei, ej, rel, w)


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize(
    poses: jax.Array,  # (P, 4, 4) cam-to-world
    pose_valid: jax.Array,  # (P,) bool
    edges_i: jax.Array,  # (E,) int32
    edges_j: jax.Array,  # (E,) int32
    edges_rel: jax.Array,  # (E, 4, 4) measured T_i^-1 T_j
    edges_w: jax.Array,  # (E,) sqrt-information (0 = padding)
    iters: int = 20,
    lambda0: float = 1e-6,
):
    """Damped Gauss-Newton over the pose graph; pose 0 stays fixed (world
    gauge). Returns (optimized poses, final error)."""
    P = poses.shape[0]
    free = pose_valid & (jnp.arange(P) > 0)

    def error(ps):
        r = _edge_residuals(ps, edges_i, edges_j, edges_rel, edges_w)
        return 0.5 * jnp.sum(r * r)

    def assemble(ps, lam):
        zeros6 = jnp.zeros(6, jnp.float32)

        def res_of(di, dj, i, j, Z, wt):
            Ti = se3.retract(ps[i], di)
            Tj = se3.retract(ps[j], dj)
            return se3.se3_logmap(se3.inverse(Z) @ se3.inverse(Ti) @ Tj) * wt

        def per_edge(i, j, Z, wt):
            r = res_of(zeros6, zeros6, i, j, Z, wt)
            Ji = jax.jacfwd(lambda d: res_of(d, zeros6, i, j, Z, wt))(zeros6)
            Jj = jax.jacfwd(lambda d: res_of(zeros6, d, i, j, Z, wt))(zeros6)
            return r, Ji, Jj

        r, Ji, Jj = jax.vmap(per_edge)(edges_i, edges_j, edges_rel, edges_w)
        Ji = Ji * free[edges_i][:, None, None]
        Jj = Jj * free[edges_j][:, None, None]
        H = jnp.zeros((P, P, 6, 6))
        H = H.at[edges_i, edges_i].add(jnp.einsum("eik,eil->ekl", Ji, Ji))
        H = H.at[edges_j, edges_j].add(jnp.einsum("eik,eil->ekl", Jj, Jj))
        H = H.at[edges_i, edges_j].add(jnp.einsum("eik,eil->ekl", Ji, Jj))
        H = H.at[edges_j, edges_i].add(jnp.einsum("eik,eil->ekl", Jj, Ji))
        g = jnp.zeros((P, 6)).at[edges_i].add(jnp.einsum("eik,ei->ek", Ji, r))
        g = g.at[edges_j].add(jnp.einsum("eik,ei->ek", Jj, r))

        eye6 = jnp.eye(6)
        diag = jnp.einsum("ppii->p", H.reshape(P, P, 6, 6))
        H = H + lam * eye6[None, None] * jnp.where(
            jnp.eye(P, dtype=bool)[:, :, None, None],
            jnp.maximum(diag / 6.0, 1e-8)[:, None, None, None],
            0.0,
        )
        fm = free[:, None] & free[None, :]
        H = jnp.where(fm[:, :, None, None], H, 0.0)
        H = H + jnp.where(
            (jnp.eye(P, dtype=bool) & ~jnp.diag(free))[:, :, None, None],
            eye6,
            0.0,
        )
        g = jnp.where(free[:, None], g, 0.0)
        Hd = H.transpose(0, 2, 1, 3).reshape(6 * P, 6 * P)
        delta = -jnp.linalg.solve(Hd, g.reshape(-1)).reshape(P, 6)
        return delta

    def cond(c):
        _, _, _, it, done = c
        return (it < iters) & ~done

    def body(c):
        ps, lam, err, it, _ = c
        delta = assemble(ps, lam)
        ps_new = jax.vmap(se3.retract)(ps, delta)
        err_new = error(ps_new)
        improved = err_new < err
        ps = jax.tree.map(lambda a, b: jnp.where(improved, b, a), ps, ps_new)
        lam = jnp.clip(jnp.where(improved, lam * 0.3, lam * 10.0), 1e-9, 1e5)
        done = improved & (err - err_new <= 1e-9 * jnp.maximum(err, 1e-12))
        err = jnp.where(improved, err_new, err)
        return (ps, lam, err, it + 1, done)

    ps, _, err, _, _ = jax.lax.while_loop(
        cond, body,
        (poses, jnp.float32(lambda0), error(poses), jnp.int32(0), jnp.bool_(False)),
    )
    return ps, err


# ---------------------------------------------------------------------------
# Sparse (chain + loop-edge) path.
#
# A SLAM pose graph is an odometry CHAIN plus a handful of loop edges: its
# Hessian is block-tridiagonal T plus an exact low-rank Gram correction
# Jl^T Jl from the loop rows (each loop edge is one 6-dim residual touching
# two poses). Instead of materializing the dense (P, P, 6, 6) Hessian
# (604 MB at P=2048) and solving 6Px6P dense (O(P^3)), each Gauss-Newton
# step solves
#
#   (T + Jl^T Jl) d = -g
#
# by Woodbury:  d = T\g' - T\Jl^T (I + Jl T\Jl^T)^{-1} Jl T\g'
#
# where T\* is a block-Thomas solve (two lax.scans of 6x6 ops, O(P),
# batched over all RHS columns at once). Cost per iteration: O(P) with
# tiny constants + one (6L)^2 solve for L loop edges — seconds for a
# 2048-KF graph on the CPU tier, vs minutes/OOM for the dense path.
# ---------------------------------------------------------------------------


def _block_thomas(D, B, rhs):
    """Solve the symmetric block-tridiagonal system T x = rhs.

    D: (P, d, d) diagonal blocks; B: (P-1, d, d) super-diagonal blocks
    (T[i, i+1] = B[i], T[i+1, i] = B[i]^T); rhs: (P, d, R) — R right-hand
    sides solved simultaneously. Block size d comes from the inputs
    (6 for SE(3), 7 for the Sim(3) mono path). Returns (P, d, R)."""

    P, d = D.shape[0], D.shape[1]
    R = rhs.shape[2]
    # step i consumes B[i-1] (forward elimination) and B[i] (to form
    # c_i = M_i^{-1} B_i with the SAME factorization solve as d_i — the
    # two are concatenated into one multi-RHS dx(R+d) solve per step)
    B_prev = jnp.concatenate([jnp.zeros((1, d, d), D.dtype), B], 0)
    B_next = jnp.concatenate([B, jnp.zeros((1, d, d), D.dtype)], 0)

    def fwd(carry, inp):
        c_prev, d_prev = carry  # (d, d), (d, R)
        Di, Bp, Bn, bi = inp
        M = Di - Bp.T @ c_prev  # Schur-reduced diagonal
        sol = jnp.linalg.solve(
            M, jnp.concatenate([bi - Bp.T @ d_prev, Bn], 1)
        )
        d_i, c_i = sol[:, :R], sol[:, R:]
        return (c_i, d_i), (c_i, d_i)

    _, (cs, ds) = jax.lax.scan(
        fwd,
        (jnp.zeros((d, d), D.dtype), jnp.zeros((d, R), D.dtype)),
        (D, B_prev, B_next, rhs),
    )

    def back(x_next, inp):
        c_i, d_i = inp
        x_i = d_i - c_i @ x_next
        return x_i, x_i

    _, xs = jax.lax.scan(
        back, jnp.zeros((d, R), D.dtype), (cs, ds), reverse=True
    )
    return xs


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_chain(
    poses: jax.Array,  # (P, 4, 4) cam-to-world, slots 0..n-1 live
    pose_valid: jax.Array,  # (P,) bool
    chain_rel: jax.Array,  # (P-1, 4, 4) measured T_i^-1 T_{i+1}
    chain_w: jax.Array,  # (P-1,) sqrt-information (0 = padding)
    loop_i: jax.Array,  # (L,) int32
    loop_j: jax.Array,  # (L,) int32
    loop_rel: jax.Array,  # (L, 4, 4)
    loop_w: jax.Array,  # (L,) sqrt-information (0 = padding)
    iters: int = 25,
    lambda0: float = 1e-6,
):
    """Damped Gauss-Newton over a chain+loops pose graph in O(P) per
    iteration (see module comment). Pose 0 fixed (world gauge). Returns
    (optimized poses, final error) — same contract as :func:`optimize`,
    equivalence-tested against it in tests/test_loop_closure.py."""
    P = poses.shape[0]
    free = pose_valid & (jnp.arange(P) > 0)
    ci = jnp.arange(P - 1, dtype=jnp.int32)
    zeros6 = jnp.zeros(6, jnp.float32)

    def edge_res(ps, i, j, Z, wt):
        return se3.se3_logmap(se3.inverse(Z) @ se3.inverse(ps[i]) @ ps[j]) * wt

    def error(ps):
        rc = jax.vmap(lambda i, Z, wt: edge_res(ps, i, i + 1, Z, wt))(
            ci, chain_rel, chain_w
        )
        rl = jax.vmap(lambda i, j, Z, wt: edge_res(ps, i, j, Z, wt))(
            loop_i, loop_j, loop_rel, loop_w
        )
        return 0.5 * (jnp.sum(rc * rc) + jnp.sum(rl * rl))

    def jac_pair(ps, i, j, Z, wt):
        def res_of(di, dj):
            Ti = se3.retract(ps[i], di)
            Tj = se3.retract(ps[j], dj)
            return se3.se3_logmap(se3.inverse(Z) @ se3.inverse(Ti) @ Tj) * wt

        r = res_of(zeros6, zeros6)
        Ji = jax.jacfwd(lambda d: res_of(d, zeros6))(zeros6)
        Jj = jax.jacfwd(lambda d: res_of(zeros6, d))(zeros6)
        return r, Ji, Jj

    def assemble_solve(ps, lam):
        # chain: block-tridiagonal T
        rc, Jci, Jcj = jax.vmap(
            lambda i, Z, wt: jac_pair(ps, i, i + 1, Z, wt)
        )(ci, chain_rel, chain_w)
        Jci = Jci * free[ci][:, None, None]
        Jcj = Jcj * free[ci + 1][:, None, None]
        D = jnp.zeros((P, 6, 6))
        D = D.at[ci].add(jnp.einsum("eik,eil->ekl", Jci, Jci))
        D = D.at[ci + 1].add(jnp.einsum("eik,eil->ekl", Jcj, Jcj))
        B = jnp.einsum("eik,eil->ekl", Jci, Jcj)  # (P-1, 6, 6) = T[i, i+1]
        g = jnp.zeros((P, 6))
        g = g.at[ci].add(jnp.einsum("eik,ei->ek", Jci, rc))
        g = g.at[ci + 1].add(jnp.einsum("eik,ei->ek", Jcj, rc))

        # loop rows (kept ENTIRELY in the low-rank term, diagonal blocks
        # included — T stays exactly the chain part, so T + U^T U == H)
        rl, Jli, Jlj = jax.vmap(
            lambda i, j, Z, wt: jac_pair(ps, i, j, Z, wt)
        )(loop_i, loop_j, loop_rel, loop_w)
        Jli = Jli * free[loop_i][:, None, None]
        Jlj = Jlj * free[loop_j][:, None, None]
        g = g.at[loop_i].add(jnp.einsum("eik,ei->ek", Jli, rl))
        g = g.at[loop_j].add(jnp.einsum("eik,ei->ek", Jlj, rl))

        # damping on the TOTAL diagonal (chain + loop contributions), so
        # the step matches the dense path's Levenberg scaling
        diag_loop = jnp.zeros(P)
        diag_loop = diag_loop.at[loop_i].add(
            jnp.einsum("eik,eik->e", Jli, Jli)
        )
        diag_loop = diag_loop.at[loop_j].add(
            jnp.einsum("eik,eik->e", Jlj, Jlj)
        )
        trace = jnp.einsum("pii->p", D) + diag_loop
        eye6 = jnp.eye(6)
        D = D + (lam * jnp.maximum(trace / 6.0, 1e-8))[:, None, None] * eye6
        # clamped (non-free) poses: identity rows, zero coupling
        D = jnp.where(free[:, None, None], D, eye6[None])
        link = (free[ci] & free[ci + 1])[:, None, None]
        B = jnp.where(link, B, 0.0)

        # Woodbury: the stacked loop-row Jacobian U is (6L, 6P) with two
        # nonzero 6x6 blocks per edge; built densely via one-hot einsum
        # (L*P*36 floats — 1.2 MB even at P=2048, L=16)
        L = loop_i.shape[0]
        onehot_i = (loop_i[:, None] == jnp.arange(P)[None]).astype(jnp.float32)
        onehot_j = (loop_j[:, None] == jnp.arange(P)[None]).astype(jnp.float32)
        U4 = jnp.einsum("ep,eik->epik", onehot_i, Jli) + jnp.einsum(
            "ep,eik->epik", onehot_j, Jlj
        )  # (L, P, 6_res, 6_param)
        UT = U4.transpose(1, 3, 0, 2).reshape(P, 6, 6 * L)  # T \ U^T panel
        # T \ [g | U^T] in ONE batched Thomas solve: R = 1 + 6L columns
        rhs = jnp.concatenate([g[:, :, None], UT], axis=2)  # (P, 6, 1+6L)
        sol = _block_thomas(D, B, rhs)
        x_g, X_U = sol[:, :, 0], sol[:, :, 1:]  # (P,6), (P,6,6L)
        # S = I + U T\U^T  (6L x 6L)
        U_flat = U4.transpose(0, 2, 1, 3).reshape(6 * L, 6 * P)
        S = jnp.eye(6 * L) + U_flat @ X_U.reshape(P * 6, 6 * L)
        Ux = U_flat @ x_g.reshape(-1)
        corr = X_U.reshape(P * 6, 6 * L) @ jnp.linalg.solve(S, Ux)
        delta = -(x_g.reshape(-1) - corr).reshape(P, 6)
        return jnp.where(free[:, None], delta, 0.0)

    def cond(c):
        _, _, _, it, done = c
        return (it < iters) & ~done

    def body(c):
        ps, lam, err, it, _ = c
        delta = assemble_solve(ps, lam)
        ps_new = jax.vmap(se3.retract)(ps, delta)
        err_new = error(ps_new)
        improved = err_new < err
        ps = jax.tree.map(lambda a, b: jnp.where(improved, b, a), ps, ps_new)
        lam = jnp.clip(jnp.where(improved, lam * 0.3, lam * 10.0), 1e-9, 1e5)
        done = improved & (err - err_new <= 1e-9 * jnp.maximum(err, 1e-12))
        err = jnp.where(improved, err_new, err)
        return (ps, lam, err, it + 1, done)

    ps, _, err, _, _ = jax.lax.while_loop(
        cond, body,
        (poses, jnp.float32(lambda0), error(poses), jnp.int32(0), jnp.bool_(False)),
    )
    return ps, err


# ---------------------------------------------------------------------------
# Sim(3) chain path — monocular loop closure (scale-drift-aware).
#
# A mono loop accumulates SCALE drift as well as pose drift, and an SE(3)
# loop edge cannot absorb a scale discrepancy — closing over SE(3) warps
# the map (measured; BASELINE.md "Mono drift envelope"). Following
# Strasdat et al. / ORB-SLAM, mono closures optimize over Sim(3): 7-dof
# states (pose + log-scale), chain edges with scale 1 from the current
# estimates, and a loop edge whose similarity is estimated by a scaled
# Umeyama fit of the merged duplicate-landmark pairs. Same O(P)/iteration
# block-Thomas + Woodbury structure as optimize_chain, with 7x7 blocks.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_sim3_chain(
    poses: jax.Array,  # (P, 4, 4) cam-to-world SE(3), slots 0..n-1 live
    pose_valid: jax.Array,  # (P,) bool
    chain_rel: jax.Array,  # (P-1, 4, 4) measured Sim(3) (scale-1 from estimates)
    chain_w: jax.Array,  # (P-1,) sqrt-information (0 = padding)
    loop_i: jax.Array,  # (L,) int32
    loop_j: jax.Array,  # (L,) int32
    loop_rel: jax.Array,  # (L, 4, 4) measured Sim(3) relative transforms
    loop_w: jax.Array,  # (L,) sqrt-information (0 = padding)
    iters: int = 25,
    lambda0: float = 1e-6,
):
    """Damped Gauss-Newton over a Sim(3) chain+loops graph. States are
    initialized at scale 1 from the SE(3) poses; pose 0 stays fixed.
    Returns (optimized Sim(3) states (P, 4, 4), final error). Callers
    take `sim3.to_se3(S)` as the corrected camera poses and apply the
    full Sim(3) delta `S' @ inverse(S)` to the landmarks."""
    from vslam_tpu.geometry import sim3

    P = poses.shape[0]
    free = pose_valid & (jnp.arange(P) > 0)
    ci = jnp.arange(P - 1, dtype=jnp.int32)
    zeros7 = jnp.zeros(7, jnp.float32)
    states0 = sim3.from_se3(poses)

    def edge_res(ps, i, j, Z, wt):
        return sim3.logmap(sim3.inverse(Z) @ sim3.inverse(ps[i]) @ ps[j]) * wt

    def error(ps):
        rc = jax.vmap(lambda i, Z, wt: edge_res(ps, i, i + 1, Z, wt))(
            ci, chain_rel, chain_w
        )
        rl = jax.vmap(lambda i, j, Z, wt: edge_res(ps, i, j, Z, wt))(
            loop_i, loop_j, loop_rel, loop_w
        )
        return 0.5 * (jnp.sum(rc * rc) + jnp.sum(rl * rl))

    def jac_pair(ps, i, j, Z, wt):
        def res_of(di, dj):
            Si = sim3.retract(ps[i], di)
            Sj = sim3.retract(ps[j], dj)
            return sim3.logmap(sim3.inverse(Z) @ sim3.inverse(Si) @ Sj) * wt

        r = res_of(zeros7, zeros7)
        Ji = jax.jacfwd(lambda d: res_of(d, zeros7))(zeros7)
        Jj = jax.jacfwd(lambda d: res_of(zeros7, d))(zeros7)
        return r, Ji, Jj

    def assemble_solve(ps, lam):
        rc, Jci, Jcj = jax.vmap(
            lambda i, Z, wt: jac_pair(ps, i, i + 1, Z, wt)
        )(ci, chain_rel, chain_w)
        Jci = Jci * free[ci][:, None, None]
        Jcj = Jcj * free[ci + 1][:, None, None]
        D = jnp.zeros((P, 7, 7))
        D = D.at[ci].add(jnp.einsum("eik,eil->ekl", Jci, Jci))
        D = D.at[ci + 1].add(jnp.einsum("eik,eil->ekl", Jcj, Jcj))
        B = jnp.einsum("eik,eil->ekl", Jci, Jcj)
        g = jnp.zeros((P, 7))
        g = g.at[ci].add(jnp.einsum("eik,ei->ek", Jci, rc))
        g = g.at[ci + 1].add(jnp.einsum("eik,ei->ek", Jcj, rc))

        rl, Jli, Jlj = jax.vmap(
            lambda i, j, Z, wt: jac_pair(ps, i, j, Z, wt)
        )(loop_i, loop_j, loop_rel, loop_w)
        Jli = Jli * free[loop_i][:, None, None]
        Jlj = Jlj * free[loop_j][:, None, None]
        g = g.at[loop_i].add(jnp.einsum("eik,ei->ek", Jli, rl))
        g = g.at[loop_j].add(jnp.einsum("eik,ei->ek", Jlj, rl))

        diag_loop = jnp.zeros(P)
        diag_loop = diag_loop.at[loop_i].add(jnp.einsum("eik,eik->e", Jli, Jli))
        diag_loop = diag_loop.at[loop_j].add(jnp.einsum("eik,eik->e", Jlj, Jlj))
        trace = jnp.einsum("pii->p", D) + diag_loop
        eye7 = jnp.eye(7)
        D = D + (lam * jnp.maximum(trace / 7.0, 1e-8))[:, None, None] * eye7
        D = jnp.where(free[:, None, None], D, eye7[None])
        link = (free[ci] & free[ci + 1])[:, None, None]
        B = jnp.where(link, B, 0.0)

        L = loop_i.shape[0]
        onehot_i = (loop_i[:, None] == jnp.arange(P)[None]).astype(jnp.float32)
        onehot_j = (loop_j[:, None] == jnp.arange(P)[None]).astype(jnp.float32)
        U4 = jnp.einsum("ep,eik->epik", onehot_i, Jli) + jnp.einsum(
            "ep,eik->epik", onehot_j, Jlj
        )  # (L, P, 7_res, 7_param)
        UT = U4.transpose(1, 3, 0, 2).reshape(P, 7, 7 * L)
        rhs = jnp.concatenate([g[:, :, None], UT], axis=2)
        sol = _block_thomas(D, B, rhs)
        x_g, X_U = sol[:, :, 0], sol[:, :, 1:]
        U_flat = U4.transpose(0, 2, 1, 3).reshape(7 * L, 7 * P)
        S = jnp.eye(7 * L) + U_flat @ X_U.reshape(P * 7, 7 * L)
        Ux = U_flat @ x_g.reshape(-1)
        corr = X_U.reshape(P * 7, 7 * L) @ jnp.linalg.solve(S, Ux)
        delta = -(x_g.reshape(-1) - corr).reshape(P, 7)
        return jnp.where(free[:, None], delta, 0.0)

    def cond(c):
        _, _, _, it, done = c
        return (it < iters) & ~done

    def body(c):
        ps, lam, err, it, _ = c
        delta = assemble_solve(ps, lam)
        ps_new = jax.vmap(sim3.retract)(ps, delta)
        err_new = error(ps_new)
        improved = err_new < err
        ps = jax.tree.map(lambda a, b: jnp.where(improved, b, a), ps, ps_new)
        lam = jnp.clip(jnp.where(improved, lam * 0.3, lam * 10.0), 1e-9, 1e5)
        done = improved & (err - err_new <= 1e-9 * jnp.maximum(err, 1e-12))
        err = jnp.where(improved, err_new, err)
        return (ps, lam, err, it + 1, done)

    ps, _, err, _, _ = jax.lax.while_loop(
        cond, body,
        (
            states0,
            jnp.float32(lambda0),
            error(states0),
            jnp.int32(0),
            jnp.bool_(False),
        ),
    )
    return ps, err
