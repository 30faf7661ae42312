"""Sim(3) — similarity transforms for monocular loop closure.

Monocular SLAM drifts in SCALE as well as pose, and an SE(3) loop edge
cannot absorb a scale discrepancy: closing a mono loop over SE(3) warps
the map (measured on the live mono circuit — BASELINE.md "Mono drift
envelope"). ORB-SLAM closes mono loops over Sim(3) for exactly this
reason (Strasdat et al., "Scale Drift-Aware Large Scale Monocular
SLAM"); this module is the (jit/jacfwd-differentiable,
branchless) Sim(3) core used by models/pose_graph.optimize_sim3_chain.

Representation: a (4, 4) matrix [[s*R, t], [0, 1]] — composition is a
plain matmul (vmappable), the group action on points is
the same einsum the SE(3) map-correction kernel already uses, and the
scale is recovered as det(sR)^(1/3). Tangent ordering: [omega(3),
nu(3), sigma(1)] — rotation first like geometry/se3.

The reference has no Sim(3) anywhere (its loop-closure state is
vestigial, include/Map.h:122-127)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vslam_tpu.geometry import se3

_EPS = 1e-6


def _hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], -1),
            jnp.stack([wz, z, -wx], -1),
            jnp.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def _calc_W(omega: jax.Array, sigma: jax.Array) -> jax.Array:
    """The Sim(3) 'left Jacobian' W with t = W @ nu (Strasdat's closed
    form; W = C I + A [w]x + B [w]x^2 where A,B,C are the moments
    int_0^1 u^n e^{sigma u} exp(u [w]x) du). Branchless Taylor switches
    at small theta/sigma keep it jacfwd-safe."""
    theta = jnp.linalg.norm(omega, axis=-1)
    s = jnp.exp(sigma)
    Om = _hat(omega)
    Om2 = Om @ Om

    small_sig = jnp.abs(sigma) < _EPS
    small_th = theta < _EPS
    # safe denominators (the selected branch never uses the unsafe one)
    sg = jnp.where(small_sig, 1.0, sigma)
    th = jnp.where(small_th, 1.0, theta)

    C = jnp.where(small_sig, 1.0 + 0.5 * sigma, (s - 1.0) / sg)

    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    a = s * sin_t
    b = s * cos_t
    c = theta * theta + sigma * sigma
    c_safe = jnp.where(small_sig & small_th, 1.0, c)

    A_ss = (1.0 - cos_t) / (th * th)  # sigma ~ 0
    A_ls_st = ((sigma - 1.0) * s + 1.0) / (sg * sg)  # theta ~ 0
    A_gen = (a * sigma + (1.0 - b) * theta) / (th * c_safe)
    A = jnp.where(
        small_th,
        jnp.where(small_sig, 0.5, A_ls_st),
        jnp.where(small_sig, A_ss, A_gen),
    )

    B_ss = (theta - sin_t) / (th * th * th)
    B_ls_st = ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0) / (sg**3)
    B_gen = (C - ((b - 1.0) * sigma + a * theta) / c_safe) / (th * th)
    B = jnp.where(
        small_th,
        jnp.where(small_sig, 1.0 / 6.0, B_ls_st),
        jnp.where(small_sig, B_ss, B_gen),
    )

    eye = jnp.eye(3, dtype=omega.dtype)
    return (
        C[..., None, None] * eye
        + A[..., None, None] * Om
        + B[..., None, None] * Om2
    )


def expmap(xi: jax.Array) -> jax.Array:
    """sim(3) exp: (..., 7) [omega, nu, sigma] -> (..., 4, 4) [[sR, t],[0,1]]."""
    omega, nu, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = se3.so3_expmap(omega)
    s = jnp.exp(sigma)
    W = _calc_W(omega, sigma)
    t = (W @ nu[..., None])[..., 0]
    top = jnp.concatenate([s[..., None, None] * R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], xi.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def scale_of(M: jax.Array) -> jax.Array:
    """(..., 4, 4) -> (...,) similarity scale s = det(sR)^(1/3)."""
    return jnp.cbrt(jnp.linalg.det(M[..., :3, :3]))


def logmap(M: jax.Array) -> jax.Array:
    """(..., 4, 4) -> (..., 7) [omega, nu, sigma]."""
    s = scale_of(M)
    R = M[..., :3, :3] / s[..., None, None]
    sigma = jnp.log(s)
    omega = se3.so3_logmap(R)
    W = _calc_W(omega, sigma)
    nu = jnp.linalg.solve(W, M[..., :3, 3:4])[..., 0]
    return jnp.concatenate([omega, nu, sigma[..., None]], axis=-1)


def inverse(M: jax.Array) -> jax.Array:
    """Closed-form Sim(3) inverse: (s,R,t) -> (1/s, R^T, -(1/s) R^T t)."""
    s = scale_of(M)
    R = M[..., :3, :3] / s[..., None, None]
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * (Rt @ M[..., :3, 3:4])[..., 0]
    top = jnp.concatenate(
        [s_inv[..., None, None] * Rt, t_inv[..., None]], axis=-1
    )
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], M.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def retract(M: jax.Array, xi: jax.Array) -> jax.Array:
    """Right retraction M * exp(xi) (the geometry/se3 convention)."""
    return M @ expmap(xi)


def from_se3(T: jax.Array, s=1.0) -> jax.Array:
    """SE(3) pose + scale -> Sim(3) matrix."""
    s = jnp.asarray(s, T.dtype)
    top = jnp.concatenate(
        [s[..., None, None] * T[..., :3, :3], T[..., :3, 3:4]], axis=-1
    )
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], T.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def to_se3(M: jax.Array) -> jax.Array:
    """Corrected camera pose from an optimized Sim(3) state: keep R and
    the (world) translation, drop the scale — the scale belongs to the
    MAP correction (apply the full Sim(3) delta to landmarks), exactly
    ORB-SLAM's CorrectedSim3 -> SE3 convention for cam-to-world poses."""
    s = scale_of(M)
    R = M[..., :3, :3] / s[..., None, None]
    return se3.rt_to_mat(R, M[..., :3, 3])
