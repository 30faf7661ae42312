"""Batched patch-window extraction at runtime keypoint corners.

The extractor needs (P x Pw) image windows at per-keypoint positions known
only at runtime (31x31 BRIEF patches for every pyramid level). This is a
plain advanced-index gather left to XLA: a copy bound by memory bandwidth
whose source (one level image, at most 752x480 f32 = 1.4 MB) stays cache
resident, so there is no reuse for a hand-written kernel to exploit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("P", "Pw"))
def extract_windows(img: jax.Array, x0: jax.Array, y0: jax.Array, P: int, Pw: int):
    """(B, q, P, Pw) windows img[b, y0[b,q]:y0+P, x0[b,q]:x0+Pw].

    img: (B, h, w) float32. x0/y0: (B, q) int32 TOP-LEFT corners, already
    clipped to [0, w-Pw] / [0, h-P]."""
    with jax.named_scope("patch_windows"):
        ys = y0[..., None] + jnp.arange(P)[None, None]  # (B, q, P)
        xs = x0[..., None] + jnp.arange(Pw)[None, None]  # (B, q, Pw)
        return jax.vmap(
            lambda im, ysb, xsb: im[ysb[:, :, None], xsb[:, None, :]]
        )(img, ys, xs)
