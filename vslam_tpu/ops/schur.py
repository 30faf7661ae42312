"""Local bundle adjustment: batched LM with an explicit Schur complement.

Re-design of the reference's GTSAM local BA
(LocalMapper::localBA, src/OptimizationBA.cpp:426-940). The reference
builds a NonlinearFactorGraph with projection factors per (landmark, KF)
observation, NonlinearEquality gauge on fixed KFs, a sequential-KF odometry
BetweenFactor chain (sigma 0.01, lines 750-768), and relies on a
landmarks-first elimination ordering (770-771, 942-953) — an implicit
Schur complement.

Here the Schur complement is explicit, blocked, dense linear algebra (the
BASELINE.json north star): per-observation Jacobians are batched with
vmap(jacfwd); landmark 3x3 blocks are eliminated analytically; the reduced
camera system is a dense (6W x 6W) solve; landmark updates come from
back-substitution. Everything is fixed-shape: W pose slots, L landmark
slots, O observation slots, all masked. One LM iteration = one fused XLA
program; the 5/10-iteration rounds with the inter-round chi-squared sweep
(reference 543-873) are driven by the caller.

This same kernel is what vslam_tpu.parallel shards across the device mesh:
the reduced-system assembly is a sum over landmark blocks, so each shard
computes partial (6W x 6W) contributions that are combined with psum.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.scipy.linalg
import jax.numpy as jnp

from vslam_tpu.geometry import se3

CHI2_THR = 7.815  # reference include/OptimizationBA.h:44
ODOMETRY_SIGMA = 0.01  # reference src/OptimizationBA.cpp:751


class BAProblem(NamedTuple):
    poses: jax.Array  # (W, 4, 4) cam-to-world
    fixed: jax.Array  # (W,) bool — gauge-fixed KFs (NonlinearEquality analog)
    pose_valid: jax.Array  # (W,) bool
    pts: jax.Array  # (L, 3)
    pt_valid: jax.Array  # (L,) bool
    obs_kf: jax.Array  # (O,) int32 -> pose slot
    obs_lm: jax.Array  # (O,) int32 -> landmark slot
    obs_uv: jax.Array  # (O, 3) [u_l, v_l, u_r] ([u_r, v_r, -] when right)
    obs_stereo: jax.Array  # (O,) bool — has right-x row
    obs_right: jax.Array  # (O,) bool — RIGHT-camera-only projection
    #   (reference right-branch projection factors with the body_P_sensor
    #   extrinsic, src/OptimizationBA.cpp:592-740)
    obs_w: jax.Array  # (O,) sqrt information (1/sigma, octave-scaled)
    obs_valid: jax.Array  # (O,) bool
    K: jax.Array  # (3, 3)
    baseline: jax.Array  # ()
    odo_rel: jax.Array  # (W-1, 4, 4) measured relative poses T_i^-1 T_{i+1}
    odo_valid: jax.Array  # (W-1,) bool — consecutive-KF chain links


def _project_residual(T_wc, pt, uv, is_stereo, is_right, K, baseline):
    """(3,) residual [du, dv, du_r] for one observation: left projection
    (+ right-x row when stereo), or right-camera projection when
    is_right."""
    T_cw = se3.inverse(T_wc)
    pc = T_cw[:3, :3] @ pt + T_cw[:3, 3]
    z = jnp.maximum(pc[2], 0.05)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u_l = fx * pc[0] / z + cx
    u_r = fx * (pc[0] - baseline) / z + cx
    r_u = jnp.where(is_right, u_r, u_l) - uv[0]
    r_v = fy * pc[1] / z + cy - uv[1]
    r_ur = jnp.where(is_stereo, u_r - uv[2], 0.0)
    # behind-camera observations must COST, not vanish: a zero residual
    # for behind rows makes "push the landmark (or the camera) past the
    # other" a zero-cost direction — a degenerate global minimum the LM
    # happily falls into on bad correspondence sets (same bug class as
    # ops/lm.stereo_residuals, fixed together). The z-clamped projection
    # already explodes the pixel residual; clip at +-512 px so one
    # behind row dominates a good row without overflowing f32 sums.
    return jnp.clip(jnp.stack([r_u, r_v, r_ur]), -512.0, 512.0)


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def _obs_residual_and_jacobians(p: BAProblem):
    """Batched residuals (O,3) and Jacobians (O,3,6) wrt pose tangent,
    (O,3,3) wrt point, all pre-weighted by obs_w and masked."""
    T_o = p.poses[p.obs_kf]  # (O,4,4)
    pt_o = p.pts[p.obs_lm]  # (O,3)

    def f(T, pt, uv, st, rt, dpose, dpt):
        return _project_residual(
            se3.retract(T, dpose), pt + dpt, uv, st, rt, p.K, p.baseline
        )

    zeros6 = jnp.zeros(6, jnp.float32)
    zeros3 = jnp.zeros(3, jnp.float32)

    def per_obs(T, pt, uv, st, rt):
        r = f(T, pt, uv, st, rt, zeros6, zeros3)
        Jp = jax.jacfwd(lambda d: f(T, pt, uv, st, rt, d, zeros3))(zeros6)
        Jl = jax.jacfwd(lambda d: f(T, pt, uv, st, rt, zeros6, d))(zeros3)
        return r, Jp, Jl

    r, Jp, Jl = jax.vmap(per_obs)(T_o, pt_o, p.obs_uv, p.obs_stereo, p.obs_right)
    w = jnp.where(p.obs_valid, p.obs_w, 0.0)[:, None]
    return r * w, Jp * w[..., None], Jl * w[..., None]


def _odometry_residual_and_jacobians(p: BAProblem):
    """Between-factor chain: r = log(odo_rel^-1 (T_i^-1 T_j)) / sigma,
    with Jacobians wrt both pose tangents. Returns (W-1,6) residuals and
    (W-1,6,6) J_i, J_j."""
    Ti = p.poses[:-1]
    Tj = p.poses[1:]

    def f(Ti_, Tj_, rel, di, dj):
        Ti_r = se3.retract(Ti_, di)
        Tj_r = se3.retract(Tj_, dj)
        return se3.se3_logmap(se3.inverse(rel) @ se3.inverse(Ti_r) @ Tj_r)

    z6 = jnp.zeros(6, jnp.float32)

    def per_link(Ti_, Tj_, rel):
        r = f(Ti_, Tj_, rel, z6, z6)
        Ji = jax.jacfwd(lambda d: f(Ti_, Tj_, rel, d, z6))(z6)
        Jj = jax.jacfwd(lambda d: f(Ti_, Tj_, rel, z6, d))(z6)
        return r, Ji, Jj

    r, Ji, Jj = jax.vmap(per_link)(Ti, Tj, p.odo_rel)
    w = jnp.where(p.odo_valid, 1.0 / ODOMETRY_SIGMA, 0.0)[:, None]
    return r * w, Ji * w[..., None], Jj * w[..., None]


def _obs_slice(p: BAProblem, axis_name: str | None):
    """This shard's observation-row slice (the full problem when
    unsharded). Inputs are replicated; the SLICE is what makes the O(O)
    linearization scale with the mesh."""
    if axis_name is None:
        return p
    O = p.obs_kf.shape[0]
    n = jax.lax.psum(1, axis_name)
    i = jax.lax.axis_index(axis_name)
    Oloc = O // n
    off = i * Oloc
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, off, Oloc, axis=0)
    return p._replace(
        obs_kf=sl(p.obs_kf),
        obs_lm=sl(p.obs_lm),
        obs_uv=sl(p.obs_uv),
        obs_stereo=sl(p.obs_stereo),
        obs_right=sl(p.obs_right),
        obs_w=sl(p.obs_w),
        obs_valid=sl(p.obs_valid),
    )


def ba_error(p: BAProblem, axis_name: str | None = None) -> jax.Array:
    """Total error; each shard sums its observation-row slice and one
    psum replicates the result (uniform accept/reject branches)."""
    ps = _obs_slice(p, axis_name)
    r, _, _ = _obs_residual_and_jacobians(ps)
    err = jnp.sum(r * r)
    err = _psum(err, axis_name)
    ro, _, _ = _odometry_residual_and_jacobians(p)
    return 0.5 * (err + jnp.sum(ro * ro))


def _slab(axis_name: str | None, L: int):
    """(slab size, slab offset) of this shard's landmark slab — the full
    range when unsharded."""
    if axis_name is None:
        return L, 0
    n = jax.lax.psum(1, axis_name)
    i = jax.lax.axis_index(axis_name)
    return L // n, i * (L // n)


def _slab_system(p: BAProblem, r, Jp, Jl, off, Lloc: int):
    """Landmark-slab blocks for slab [off, off+Lloc): Hll (Lloc,3,3),
    Hpl (W,Lloc,6,3), gl (Lloc,3). Out-of-slab rows scatter to index
    Lloc, dropped by mode="drop" (explicit sentinel — negative indices
    would wrap under default jnp indexing). `off` may be traced (the
    slab loop of the chunked reduction) — only Lloc must be static."""
    W = p.poses.shape[0]
    in_slab = (p.obs_lm >= off) & (p.obs_lm < off + Lloc)
    lm_loc = jnp.where(in_slab, p.obs_lm - off, Lloc)
    Hll = jnp.zeros((Lloc, 3, 3)).at[lm_loc].add(
        jnp.einsum("oik,oil->okl", Jl, Jl), mode="drop"
    )
    Hpl = jnp.zeros((W, Lloc, 6, 3)).at[p.obs_kf, lm_loc].add(
        jnp.einsum("oik,oil->okl", Jp, Jl), mode="drop"
    )
    gl = jnp.zeros((Lloc, 3)).at[lm_loc].add(
        jnp.einsum("oik,oi->ok", Jl, r), mode="drop"
    )
    return Hll, Hpl, gl


def _add_odometry(p: BAProblem, Hpp, gp, free):
    """Fold the odometry BetweenFactor chain into the pose blocks
    (reference src/OptimizationBA.cpp:750-768). Called once on replicated
    blocks — after the psum when sharded."""
    W = p.poses.shape[0]
    ro, Ji, Jj = _odometry_residual_and_jacobians(p)
    Ji = Ji * free[:-1][:, None, None]
    Jj = Jj * free[1:][:, None, None]
    idx_i = jnp.arange(W - 1)
    idx_j = idx_i + 1
    Hpp = Hpp.at[idx_i, idx_i].add(jnp.einsum("oik,oil->okl", Ji, Ji))
    Hpp = Hpp.at[idx_j, idx_j].add(jnp.einsum("oik,oil->okl", Jj, Jj))
    Hpp = Hpp.at[idx_i, idx_j].add(jnp.einsum("oik,oil->okl", Ji, Jj))
    Hpp = Hpp.at[idx_j, idx_i].add(jnp.einsum("oik,oil->okl", Jj, Ji))
    gp = gp.at[idx_i].add(jnp.einsum("oik,oi->ok", Ji, ro))
    gp = gp.at[idx_j].add(jnp.einsum("oik,oi->ok", Jj, ro))
    return Hpp, gp


def _pose_system(p: BAProblem, r, Jp, free):
    """Replicated pose blocks: Hpp (W,W,6,6) and gp (W,6), including the
    odometry BetweenFactor chain (reference src/OptimizationBA.cpp:750-768)."""
    W = p.poses.shape[0]
    Hpp = jnp.zeros((W, W, 6, 6))
    Hpp = Hpp.at[p.obs_kf, p.obs_kf].add(jnp.einsum("oik,oil->okl", Jp, Jp))
    gp = jnp.zeros((W, 6)).at[p.obs_kf].add(jnp.einsum("oik,oi->ok", Jp, r))
    return _add_odometry(p, Hpp, gp, free)


def _assemble(p: BAProblem, axis_name: str | None = None):
    """Build the blocked normal equations.

    Sharding scheme (inside a shard_map over `axis_name`, ALL inputs
    replicated): BOTH big dimensions are sharded. Each shard linearizes
    only its OBSERVATION-ROW slice (the O(O) Jacobian work — on a real
    chip this dominates the iteration, so replicating it capped 1->2
    scaling at ~1.2x), scatter-assembles full-L blocks from its rows,
    and a psum_scatter (reduce_scatter) lands each shard's LANDMARK SLAB
    fully summed — where the O(W^2 L) Schur reduction then runs. The
    small pose blocks (Hpp, gp) psum whole. Communication per LM
    iteration: reduce_scatter of the (W, L, 6, 3) Hpl partials + psum of
    Hpp and of the (6W)^2 reduced system + all_gather of landmark deltas
    (the scaling-book recipe: shard the big dims, let collectives carry
    summed block quantities)."""
    L = p.pts.shape[0]
    free = (~p.fixed) & p.pose_valid

    if axis_name is None:
        r, Jp, Jl = _obs_residual_and_jacobians(p)
        Jp = Jp * free[p.obs_kf][:, None, None]
        Hll, Hpl, gl = _slab_system(p, r, Jp, Jl, 0, L)
        Hpp, gp = _pose_system(p, r, Jp, free)
        return Hpp, Hll, Hpl, gp, gl

    ps = _obs_slice(p, axis_name)
    r, Jp, Jl = _obs_residual_and_jacobians(ps)
    Jp = Jp * free[ps.obs_kf][:, None, None]

    W = p.poses.shape[0]
    # full-L blocks from this shard's rows (obs_lm is always in [0, L))
    Hll = jnp.zeros((L, 3, 3)).at[ps.obs_lm].add(
        jnp.einsum("oik,oil->okl", Jl, Jl)
    )
    Hpl = jnp.zeros((W, L, 6, 3)).at[ps.obs_kf, ps.obs_lm].add(
        jnp.einsum("oik,oil->okl", Jp, Jl)
    )
    gl = jnp.zeros((L, 3)).at[ps.obs_lm].add(jnp.einsum("oik,oi->ok", Jl, r))
    Hpp = jnp.zeros((W, W, 6, 6)).at[ps.obs_kf, ps.obs_kf].add(
        jnp.einsum("oik,oil->okl", Jp, Jp)
    )
    gp = jnp.zeros((W, 6)).at[ps.obs_kf].add(jnp.einsum("oik,oi->ok", Jp, r))

    # reduce_scatter the landmark dimension; psum the pose blocks
    Hll = jax.lax.psum_scatter(Hll, axis_name, scatter_dimension=0, tiled=True)
    Hpl = jax.lax.psum_scatter(Hpl, axis_name, scatter_dimension=1, tiled=True)
    gl = jax.lax.psum_scatter(gl, axis_name, scatter_dimension=0, tiled=True)
    Hpp, gp = jax.lax.psum((Hpp, gp), axis_name)

    # odometry chain added ONCE, after the psum (it is replicated)
    Hpp, gp = _add_odometry(p, Hpp, gp, free)
    return Hpp, Hll, Hpl, gp, gl


def _damped_inv3(Hll, lam):
    """LM-damped, observedness-guarded batched 3x3 inverse of landmark
    blocks; returns (Hll_inv, observed). Deterministic in (Hll, lam) so
    the chunked reduction can recompute it per slab in both passes."""
    eye3 = jnp.eye(3)
    Hll_d = Hll + lam * eye3[None] * jnp.maximum(
        jnp.einsum("lii->l", Hll)[:, None, None] / 3.0, 1e-6
    )
    observed = jnp.einsum("lii->l", Hll) > 1e-12
    Hll_d = jnp.where(observed[:, None, None], Hll_d, eye3[None])
    return _inv3(Hll_d), observed


def _inv3(A: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse (adjugate / determinant) — pure
    elementwise math that fuses, where jnp.linalg.inv lowers to a batched
    pivoted LU; same accuracy for well-conditioned damped Hessian
    blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = jnp.stack(
        [
            e * i - f * h, c * h - b * i, b * f - c * e,
            f * g - d * i, a * i - c * g, c * d - a * f,
            d * h - e * g, b * g - a * h, a * e - b * d,
        ],
        axis=-1,
    ).reshape(*A.shape[:-2], 3, 3)
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    return co / det[..., None, None]


def _solve_reduced(p: BAProblem, Hpp, gp, S_red, b_red, lam):
    """Solve the damped reduced camera system S dp = -b with fixed poses
    frozen. S_red is the summed Schur reduction (6W,6W), b_red (W,6)."""
    W = p.poses.shape[0]
    eye6 = jnp.eye(6)
    S = Hpp - S_red.reshape(W, 6, W, 6).transpose(0, 2, 1, 3)
    b = gp - b_red

    free = (~p.fixed) & p.pose_valid
    diagW = jnp.einsum("aaii->a", S.reshape(W, W, 6, 6)[:, :, :, :])
    S = S + lam * eye6[None, None] * jnp.where(
        jnp.eye(W, dtype=bool)[:, :, None, None],
        jnp.maximum(diagW / 6.0, 1e-6)[:, None, None, None],
        0.0,
    )
    # freeze fixed/invalid poses: identity rows/cols
    fm = free[:, None] & free[None, :]
    S = jnp.where(fm[:, :, None, None], S, 0.0)
    S = S + jnp.where(
        (jnp.eye(W, dtype=bool) & ~jnp.diag(free))[:, :, None, None], eye6, 0.0
    )
    b = jnp.where(free[:, None], b, 0.0)

    # S is symmetric positive definite after damping + identity rows for
    # frozen poses — Cholesky does half the work of the pivoted LU in
    # jnp.linalg.solve
    S_dense = S.transpose(0, 2, 1, 3).reshape(6 * W, 6 * W)
    chol = jax.scipy.linalg.cho_factor(S_dense)
    return jax.scipy.linalg.cho_solve(chol, -b.reshape(-1)).reshape(W, 6)


def _schur_solve(p: BAProblem, Hpp, Hll, Hpl, gp, gl, lam, axis_name=None):
    """Damped Schur-complement solve -> (delta_pose (W,6), delta_pt (L,3)).

    Hll/Hpl/gl arrive in slab form (this shard's landmark slice; the full
    arrays when unsharded). The reduction S = Hpp - sum_l Hpl_l Hll_l^-1
    Hpl_l^T runs on the slab and one psum of the (6W)^2 reduced system +
    reduced gradient assembles the full system; landmark deltas are
    computed per slab and all_gather'd."""
    W = p.poses.shape[0]
    L = p.pts.shape[0]
    eye6 = jnp.eye(6)
    Lloc, off = _slab(axis_name, L)

    # LM damping on block diagonals; invalid/unobserved landmark blocks
    # become identity (delta stays 0: g=0)
    Hll_inv, observed = _damped_inv3(Hll, lam)

    # reduced camera system S = Hpp - Hpl Hll^-1 Hlp (sum over landmarks),
    # written as ONE (6W, 3Lloc) x (3Lloc, 6W) matmul instead of lowering
    # the 4-operand einsum to small batched GEMMs
    M = jnp.einsum("alij,ljk->alik", Hpl, Hll_inv)  # (W, Lloc, 6, 3)
    M2 = M.transpose(0, 2, 1, 3).reshape(6 * W, 3 * Lloc)
    H2 = Hpl.transpose(0, 2, 1, 3).reshape(6 * W, 3 * Lloc)
    b_red = jnp.einsum("alik,lk->ai", M, gl)
    S_red, b_red = _psum((M2 @ H2.T, b_red), axis_name)
    delta_p = _solve_reduced(p, Hpp, gp, S_red, b_red, lam)

    # back-substitute landmarks: dl = Hll^-1 (-gl - Hlp dp), per slab
    rhs = -gl - jnp.einsum("alij,ai->lj", Hpl, delta_p)
    delta_l = jnp.einsum("ljk,lk->lj", Hll_inv, rhs)
    if axis_name is None:
        pt_valid_s = p.pt_valid
    else:
        pt_valid_s = jax.lax.dynamic_slice_in_dim(p.pt_valid, off, Lloc)
    delta_l = jnp.where((observed & pt_valid_s)[:, None], delta_l, 0.0)
    if axis_name is not None:
        delta_l = jax.lax.all_gather(delta_l, axis_name, axis=0, tiled=True)
    return delta_p, delta_l


def _schur_solve_slabbed(p: BAProblem, lam, n_slabs: int):
    """One damped Schur LM step with the LANDMARK dimension processed in
    `n_slabs` sequential slabs on one device (the single-device analog of
    the mesh-sharded reduction in _assemble/_schur_solve — same slab
    math, a fori_loop instead of psum). Peak memory holds ONE
    (W, L/n_slabs, 6, 3) Hpl slab instead of the full (W, L, 6, 3)
    block, which at global-BA scale (hundreds of KFs x 10^5 landmarks)
    is multi-GB. The O-row linearization is computed once; each slab
    pass re-scatters it, so compute grows by ~2x scatter work while
    memory drops by n_slabs."""
    W = p.poses.shape[0]
    L = p.pts.shape[0]
    Lloc = L // n_slabs
    r, Jp, Jl = _obs_residual_and_jacobians(p)
    free = (~p.fixed) & p.pose_valid
    Jp = Jp * free[p.obs_kf][:, None, None]
    Hpp, gp = _pose_system(p, r, Jp, free)

    def reduce_slab(i, carry):
        S_acc, b_acc = carry
        off = i * Lloc
        Hll, Hpl, gl = _slab_system(p, r, Jp, Jl, off, Lloc)
        Hll_inv, _ = _damped_inv3(Hll, lam)
        M = jnp.einsum("alij,ljk->alik", Hpl, Hll_inv)
        M2 = M.transpose(0, 2, 1, 3).reshape(6 * W, 3 * Lloc)
        H2 = Hpl.transpose(0, 2, 1, 3).reshape(6 * W, 3 * Lloc)
        return S_acc + M2 @ H2.T, b_acc + jnp.einsum("alik,lk->ai", M, gl)

    S_red, b_red = jax.lax.fori_loop(
        0, n_slabs, reduce_slab,
        (jnp.zeros((6 * W, 6 * W)), jnp.zeros((W, 6))),
    )
    delta_p = _solve_reduced(p, Hpp, gp, S_red, b_red, lam)

    def backsub_slab(i, dl):
        off = i * Lloc
        Hll, Hpl, gl = _slab_system(p, r, Jp, Jl, off, Lloc)
        Hll_inv, observed = _damped_inv3(Hll, lam)
        rhs = -gl - jnp.einsum("alij,ai->lj", Hpl, delta_p)
        dls = jnp.einsum("ljk,lk->lj", Hll_inv, rhs)
        pt_valid_s = jax.lax.dynamic_slice_in_dim(p.pt_valid, off, Lloc)
        dls = jnp.where((observed & pt_valid_s)[:, None], dls, 0.0)
        return jax.lax.dynamic_update_slice(dl, dls, (off, 0))

    delta_l = jax.lax.fori_loop(0, n_slabs, backsub_slab, jnp.zeros((L, 3)))
    return delta_p, delta_l


def _schur_solve_sharded_slabbed(p: BAProblem, lam, n_slabs: int, axis_name: str):
    """One damped Schur LM step, mesh-sharded AND slab-chunked — the
    composition run_global needs at map scale: each
    shard linearizes only its OBSERVATION-ROW slice (the O(O) work that
    dominates once the Schur reduction is fast), and the landmark dimension is processed in
    `n_slabs` sequential GLOBAL slabs. Within each slab the shard
    scatter-assembles (W, L/n_slabs, 6, 3) partial blocks from its rows
    and a psum_scatter lands it a fully-summed SUB-slab of
    L/(n_slabs * mesh) landmarks, where the O(W^2 L) reduction runs —
    so reduction compute scales 1/mesh AND peak memory holds one slab
    instead of the full (W, L, 6, 3) block (multi-GB at map scale).
    Collectives per LM iteration: n_slabs x (reduce_scatter of Hll/Hpl/gl
    slab partials) + one psum of the (6W)^2 reduced system + n_slabs x
    all_gather of landmark deltas. Requires L % (n_slabs * mesh) == 0."""
    W = p.poses.shape[0]
    L = p.pts.shape[0]
    Lslab = L // n_slabs
    ps = _obs_slice(p, axis_name)
    r, Jp, Jl = _obs_residual_and_jacobians(ps)
    free = (~p.fixed) & p.pose_valid
    Jp = Jp * free[ps.obs_kf][:, None, None]

    # pose blocks from this shard's rows -> psum -> odometry added once
    Hpp = jnp.zeros((W, W, 6, 6)).at[ps.obs_kf, ps.obs_kf].add(
        jnp.einsum("oik,oil->okl", Jp, Jp)
    )
    gp = jnp.zeros((W, 6)).at[ps.obs_kf].add(jnp.einsum("oik,oi->ok", Jp, r))
    Hpp, gp = jax.lax.psum((Hpp, gp), axis_name)
    Hpp, gp = _add_odometry(p, Hpp, gp, free)

    def slab_blocks(off):
        """This shard's fully-summed SUB-slab blocks of slab [off, off+Lslab):
        Hll (Lsub,3,3), Hpl (W,Lsub,6,3), gl (Lsub,3), with Lsub =
        Lslab / mesh (static from the psum_scatter output shape)."""
        Hll, Hpl, gl = _slab_system(ps, r, Jp, Jl, off, Lslab)
        Hll = jax.lax.psum_scatter(Hll, axis_name, scatter_dimension=0, tiled=True)
        Hpl = jax.lax.psum_scatter(Hpl, axis_name, scatter_dimension=1, tiled=True)
        gl = jax.lax.psum_scatter(gl, axis_name, scatter_dimension=0, tiled=True)
        return Hll, Hpl, gl

    def reduce_slab(i, carry):
        S_acc, b_acc = carry
        off = i * Lslab
        Hll, Hpl, gl = slab_blocks(off)
        Hll_inv, _ = _damped_inv3(Hll, lam)
        Lsub = Hll.shape[0]
        M = jnp.einsum("alij,ljk->alik", Hpl, Hll_inv)
        M2 = M.transpose(0, 2, 1, 3).reshape(6 * W, 3 * Lsub)
        H2 = Hpl.transpose(0, 2, 1, 3).reshape(6 * W, 3 * Lsub)
        return S_acc + M2 @ H2.T, b_acc + jnp.einsum("alik,lk->ai", M, gl)

    S_red, b_red = jax.lax.fori_loop(
        0, n_slabs, reduce_slab,
        (jnp.zeros((6 * W, 6 * W)), jnp.zeros((W, 6))),
    )
    # each shard reduced only its sub-slabs: one psum completes the sum
    S_red, b_red = jax.lax.psum((S_red, b_red), axis_name)
    delta_p = _solve_reduced(p, Hpp, gp, S_red, b_red, lam)

    def backsub_slab(i, dl):
        off = i * Lslab
        Hll, Hpl, gl = slab_blocks(off)
        Hll_inv, observed = _damped_inv3(Hll, lam)
        rhs = -gl - jnp.einsum("alij,ai->lj", Hpl, delta_p)
        dls = jnp.einsum("ljk,lk->lj", Hll_inv, rhs)
        Lsub = dls.shape[0]
        off_sub = off + jax.lax.axis_index(axis_name) * Lsub
        pt_valid_s = jax.lax.dynamic_slice_in_dim(p.pt_valid, off_sub, Lsub)
        dls = jnp.where((observed & pt_valid_s)[:, None], dls, 0.0)
        gathered = jax.lax.all_gather(dls, axis_name, axis=0, tiled=True)
        return jax.lax.dynamic_update_slice(dl, gathered, (off, 0))

    delta_l = jax.lax.fori_loop(0, n_slabs, backsub_slab, jnp.zeros((L, 3)))
    return delta_p, delta_l


@functools.partial(jax.jit, static_argnames=("iters", "axis_name", "n_slabs"))
def local_ba(
    p: BAProblem, iters: int = 5, lambda0: float = 1e-4, rel_tol: float = 1e-5,
    axis_name: str | None = None, n_slabs: int = 1,
):
    """Run up to `iters` LM iterations; returns (updated problem, final
    error, final lambda). Accept/reject per iteration like GTSAM LM, with
    GTSAM's relativeErrorTol early exit (the reference sets 1e-5,
    src/OptimizationBA.cpp:772-777) — a lax.while_loop, so a converged
    window (the common steady-state case: it changed by one KF since the
    last solve) costs 1-2 iterations instead of the full budget.

    With `axis_name` (inside shard_map, observations sharded over that
    axis): the accept/reject and convergence logic runs on psum'd errors,
    so every shard takes identical branches and the loop stays uniform.

    With `n_slabs > 1` the Schur reduction runs slab-chunked for bounded
    memory — the global-BA path at map scale. Slab chunking COMPOSES with
    `axis_name`: sharded linearization + per-slab psum_scatter reduction
    (see _schur_solve_sharded_slabbed)."""
    err0 = ba_error(p, axis_name)

    def cond(carry):
        _, _, _, i, done = carry
        return (i < iters) & ~done

    def body(carry):
        p, lam, err, i, _ = carry
        if n_slabs > 1 and axis_name is not None:
            dp, dl = _schur_solve_sharded_slabbed(p, lam, n_slabs, axis_name)
        elif n_slabs > 1:
            dp, dl = _schur_solve_slabbed(p, lam, n_slabs)
        else:
            Hpp, Hll, Hpl, gp, gl = _assemble(p, axis_name)
            dp, dl = _schur_solve(p, Hpp, Hll, Hpl, gp, gl, lam, axis_name)
        new_poses = jax.vmap(se3.retract)(p.poses, dp)
        new_pts = p.pts + dl
        p_new = p._replace(poses=new_poses, pts=new_pts)
        new_err = ba_error(p_new, axis_name)
        # NaN-safe accept/reject: a non-finite trial (degenerate Schur solve)
        # is rejected and must not poison the running error
        improved = new_err < err  # False when new_err is NaN
        # converged per GTSAM relativeErrorTol, on an ACCEPTED step only
        done = improved & (err - new_err <= rel_tol * jnp.maximum(err, 1e-12))
        p = jax.tree.map(lambda a, b: jnp.where(improved, b, a), p, p_new)
        lam = jnp.clip(
            jnp.where(improved, lam * 0.1, lam * 10.0), 1e-9, 1e6
        )
        err = jnp.where(improved, new_err, err)
        return (p, lam, err, i + 1, done)

    p, lam, err, _, _ = jax.lax.while_loop(
        cond, body, (p, jnp.float32(lambda0), err0, jnp.int32(0), jnp.bool_(False))
    )
    return p, err, lam


@functools.partial(
    jax.jit, static_argnames=("iters1", "iters2", "axis_name", "n_slabs")
)
def local_ba_two_rounds(
    p: BAProblem, iters1: int = 5, iters2: int = 10,
    axis_name: str | None = None, n_slabs: int = 1,
):
    """The reference's full 2-round schedule as ONE device program: round 1
    LM -> chi-squared outlier sweep -> round 2 LM -> final chi-squared kill
    mask (reference src/OptimizationBA.cpp:543-873). Fusing the rounds
    removes 3 of the 4 host->device dispatches per local-BA run.

    With `axis_name` the SAME schedule runs sharded (the chi-squared sweep
    is per-observation and therefore shard-local); with `n_slabs > 1` it
    runs memory-chunked on one device (run_global at map scale)."""
    p1, _, _ = local_ba(p, iters=iters1, axis_name=axis_name, n_slabs=n_slabs)
    keep = p1.obs_valid & (obs_chi2(p1) < CHI2_THR)
    p1 = p1._replace(obs_valid=keep)
    p2, err, _ = local_ba(p1, iters=iters2, axis_name=axis_name, n_slabs=n_slabs)
    kill = p2.obs_valid & (obs_chi2(p2) >= CHI2_THR)
    return p2, err, kill


@functools.partial(jax.jit, static_argnames=("iters1",))
def local_ba_round1(p: BAProblem, iters1: int = 5):
    """Round 1 + the inter-round chi-squared sweep as its OWN program —
    the first half of :func:`local_ba_two_rounds`, bit-identical when
    chained with :func:`local_ba_round2` (each round restarts lambda at
    lambda0 in the fused form too). Split so the staged async pipeline
    can interleave a tracking step between the rounds: the fused program
    is the single largest block in the device queue and the dominant
    driver-visible p90 contributor (BASELINE.md)."""
    p1, _, _ = local_ba(p, iters=iters1)
    keep = p1.obs_valid & (obs_chi2(p1) < CHI2_THR)
    return p1._replace(obs_valid=keep)


@functools.partial(jax.jit, static_argnames=("iters2",))
def local_ba_round2(p1: BAProblem, iters2: int = 10):
    """Round 2 + the final kill mask — the second half of
    :func:`local_ba_two_rounds`."""
    p2, err, _ = local_ba(p1, iters=iters2)
    kill = p2.obs_valid & (obs_chi2(p2) >= CHI2_THR)
    return p2, err, kill


@jax.jit
def obs_chi2(p: BAProblem) -> jax.Array:
    """Per-observation chi^2 (unwhitened pixel errors x information), for
    the inter-round outlier sweep (reference src/OptimizationBA.cpp:788-871)."""
    T_o = p.poses[p.obs_kf]
    pt_o = p.pts[p.obs_lm]
    r = jax.vmap(
        lambda T, pt, uv, st, rt: _project_residual(
            T, pt, uv, st, rt, p.K, p.baseline
        )
    )(T_o, pt_o, p.obs_uv, p.obs_stereo, p.obs_right)
    chi2 = jnp.sum(r * r, axis=-1) * (p.obs_w**2)
    # a behind-camera row can never classify as an inlier
    T_cw = jax.vmap(se3.inverse)(T_o)
    z = jnp.einsum("oi,oi->o", T_cw[:, 2, :3], pt_o) + T_cw[:, 2, 3]
    return jnp.where(z <= 0.05, 1e12, chi2)
