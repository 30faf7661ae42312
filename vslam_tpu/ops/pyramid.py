"""Image pyramid + separable Gaussian blur.

Replacement for reference FeatureExtractor::computePyramid
(reference src/FeatureExtractor.cpp:342-366: 8 levels, scale 1.2, bilinear
resize, reflect-101 border) and the 7x7 sigma=2 Gaussian blur applied
before BRIEF (reference src/FeatureExtractor.cpp:515-516).

Levels have static shapes derived from (H, W, n_levels, scale) at trace
time, so the whole pyramid is one fused XLA computation per image size.
All images are (H, W) float32.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static per-level (H_l, W_l), matching cvRound(dim / scale^l)."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale**lvl)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


def resize_bilinear(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """Bilinear resize with half-pixel centers (cv::resize INTER_LINEAR)."""
    return resize_bilinear_batch(img[None], out_h, out_w)[0]


def resize_bilinear_batch(imgs: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """(B, H, W) -> (B, out_h, out_w) bilinear with half-pixel centers."""
    _, H, W = imgs.shape
    sy = H / out_h
    sx = W / out_w
    ys = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) * sy - 0.5
    xs = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) * sx - 0.5
    y0 = jnp.clip(jnp.floor(ys), 0, H - 1)
    x0 = jnp.clip(jnp.floor(xs), 0, W - 1)
    wy = jnp.clip(ys - y0, 0.0, 1.0)
    wx = jnp.clip(xs - x0, 0.0, 1.0)
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)
    y1i = jnp.minimum(y0i + 1, H - 1)
    x1i = jnp.minimum(x0i + 1, W - 1)
    r0 = jnp.take(imgs, y0i, axis=1)
    r1 = jnp.take(imgs, y1i, axis=1)
    a = jnp.take(r0, x0i, axis=2)
    b = jnp.take(r0, x1i, axis=2)
    c = jnp.take(r1, x0i, axis=2)
    d = jnp.take(r1, x1i, axis=2)
    top = a * (1 - wx)[None, None, :] + b * wx[None, None, :]
    bot = c * (1 - wx)[None, None, :] + d * wx[None, None, :]
    return top * (1 - wy)[None, :, None] + bot * wy[None, :, None]


def build_pyramid(
    img: jax.Array, n_levels: int = 8, scale: float = 1.2
) -> list[jax.Array]:
    """List of n_levels images; level 0 is the input. Successive resampling
    from the previous level (as the reference does) to avoid aliasing."""
    H, W = img.shape
    shapes = level_shapes(H, W, n_levels, scale)
    levels = [img]
    for lvl in range(1, n_levels):
        h, w = shapes[lvl]
        levels.append(resize_bilinear(levels[-1], h, w))
    return levels


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> tuple:
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    k /= k.sum()
    return tuple(k.astype(np.float32))


def gaussian_blur(img: jax.Array, ksize: int = 7, sigma: float = 2.0) -> jax.Array:
    """Separable Gaussian with reflect-101 borders (cv::GaussianBlur
    BORDER_REFLECT_101 semantics, used before BRIEF sampling)."""
    return gaussian_blur_batch(img[None], ksize, sigma)[0]


def gaussian_blur_batch(imgs: jax.Array, ksize: int = 7, sigma: float = 2.0) -> jax.Array:
    """(B, H, W) separable Gaussian, reflect-101 borders."""
    k = jnp.asarray(_gaussian_kernel_1d(ksize, sigma))
    half = ksize // 2
    B, H, W = imgs.shape
    padded = jnp.pad(imgs, ((0, 0), (half, half), (half, half)), mode="reflect")
    rows = jnp.zeros((B, H + 2 * half, W), imgs.dtype)
    for i in range(ksize):
        rows = rows + k[i] * jax.lax.dynamic_slice(
            padded, (0, 0, i), (B, H + 2 * half, W)
        )
    out = jnp.zeros((B, H, W), imgs.dtype)
    for i in range(ksize):
        out = out + k[i] * jax.lax.dynamic_slice(rows, (0, i, 0), (B, H, W))
    return out
