"""FAST-16 corner detection + grid ANMS, fully vectorized.

Replacement for the reference's tiled OpenCV FAST + SSC pipeline
(reference src/FeatureExtractor.cpp:535-618: 35-px tiles, threshold 20 with
fallback 7; SSC ANMS at 368-468; per-level quota 648-659).

Design: the segment test is an elementwise program over the whole level
image (16 shifted views, arc tests as boolean reductions),
followed by 3x3 score NMS and a static per-cell top-k that replaces the
sequential SSC with an equivalent contract: spatially uniform coverage and
a per-level quota. Everything is static-shaped; keypoints are returned as
fixed-size arrays with validity masks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 (the 16 FAST offsets, clockwise from 12h).
_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)  # (dx, dy)

ARC_LEN = 9  # FAST 9-16 variant (OpenCV default used by the reference)


def _shifted_ring(img: jax.Array) -> jax.Array:
    """(16, H, W) ring neighbors via padded static slices (border=replicate;
    border pixels are excluded from detection anyway by the edge margin)."""
    H, W = img.shape
    p = 3
    padded = jnp.pad(img, p, mode="edge")
    views = [
        jax.lax.dynamic_slice(padded, (p + int(dy), p + int(dx)), (H, W))
        for dx, dy in _CIRCLE
    ]
    return jnp.stack(views, axis=0)


def fast_score(img: jax.Array, threshold: float) -> jax.Array:
    """Per-pixel FAST-9/16 corner score (0 where not a corner).

    Score semantics follow OpenCV: the largest margin m such that some
    contiguous arc of >= 9 ring pixels is all brighter than p+m (or all
    darker than p-m); pixels failing the test at `threshold` score 0.
    """
    ring = _shifted_ring(img)  # (16, H, W)
    d_bright = ring - img[None]  # >  t for bright arc
    d_dark = -d_bright  # >  t for dark arc

    def arc_margin(d: jax.Array) -> jax.Array:
        # max over 16 circular windows of (min over 9 consecutive ring diffs)
        dd = jnp.concatenate([d, d[: ARC_LEN - 1]], axis=0)  # (24, H, W)
        m = None
        for k in range(16):
            w = jnp.min(dd[k : k + ARC_LEN], axis=0)
            m = w if m is None else jnp.maximum(m, w)
        return m

    margin = jnp.maximum(arc_margin(d_bright), arc_margin(d_dark))
    score = jnp.where(margin > threshold, margin, 0.0)
    # exclude the 3-px ring border (undefined neighbors)
    H, W = img.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inside = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return jnp.where(inside, score, 0.0)


def nms3x3(score: jax.Array) -> jax.Array:
    """Keep only local maxima over a 3x3 neighborhood (ties keep the
    lexicographically first via strict comparison on shifted copies)."""
    H, W = score.shape
    p = jnp.pad(score, 1, mode="constant", constant_values=-1.0)
    best = score
    keep = jnp.ones_like(score, dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (H, W))
            if (dy, dx) < (0, 0):
                keep = keep & (best > n)  # strict vs earlier neighbors
            else:
                keep = keep & (best >= n)
    return jnp.where(keep, score, 0.0)


@functools.partial(
    jax.jit, static_argnames=("cell", "max_keypoints", "edge_margin", "per_cell")
)
def select_keypoints(
    score: jax.Array,
    cell: int = 36,
    max_keypoints: int = 512,
    edge_margin: int = 19,
    per_cell: int = 4,
):
    """Grid ANMS: per-cell top-`per_cell` candidates, then global top-k.

    Preserves the SSC contract (uniform spatial coverage, ~quota points,
    reference src/FeatureExtractor.cpp:368-468) with static shapes. The
    image is padded up to a multiple of `cell`; scores at the `edge_margin`
    border are zeroed first (reference edgeThreshold=19).

    Returns (xy (K,2) int32, response (K,) f32, valid (K,) bool), K =
    max_keypoints, sorted by descending response.
    """
    H, W = score.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inside = (
        (ys >= edge_margin)
        & (ys < H - edge_margin)
        & (xs >= edge_margin)
        & (xs < W - edge_margin)
    )
    score = jnp.where(inside, score, 0.0)

    gh = -(-H // cell)
    gw = -(-W // cell)
    padded = jnp.pad(score, ((0, gh * cell - H), (0, gw * cell - W)))
    cells = padded.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3).reshape(
        gh * gw, cell * cell
    )
    cs, ci = jax.lax.top_k(cells, per_cell)  # (ncell, per_cell)
    # decode flat in-cell index back to image coords
    cy = ci // cell
    cx = ci % cell
    gy = jax.lax.broadcasted_iota(jnp.int32, (gh * gw, per_cell), 0) // gw
    gx = jax.lax.broadcasted_iota(jnp.int32, (gh * gw, per_cell), 0) % gw
    py = gy * cell + cy
    px = gx * cell + cx

    # Global selection priority: STRONG corners (those carrying detect()'s
    # dual-threshold boost) before weak ones, coverage before depth within
    # each strength tier (every occupied cell's best outranks any cell's
    # 2nd-best), response within a (strength, rank) tier. This is the
    # reference's semantics exactly — tiles detect at the high threshold
    # first and fall back to the low one only to fill
    # (src/FeatureExtractor.cpp:557-608) — and SSC's coverage priority. A
    # plain response top-k kept the SSC contract only when corners were
    # sparse (grid coverage 0.64 vs the oracle's 0.91 on 1/f texture);
    # pure rank-first coverage overweighted low-threshold noise corners
    # (hard-scene ATE 0.2 -> 0.37). The two-level tier fixes both
    # (tests/test_anms_ssc.py, tests/test_tracking.py hard scene).
    rank = jax.lax.broadcasted_iota(jnp.int32, cs.shape, 1)
    RANK_BONUS = jnp.float32(1 << 14)  # > any boosted response (~1280)
    STRONG_BONUS = jnp.float32(1 << 20)  # > max rank bonus (3 << 14)
    strong = (cs > 1024.0).astype(cs.dtype)  # detect()'s boost marker
    sel = jnp.where(
        cs > 0.0,
        cs
        + (per_cell - 1 - rank).astype(cs.dtype) * RANK_BONUS
        + strong * STRONG_BONUS,
        0.0,
    )
    flat_sel = sel.reshape(-1)
    flat_s = cs.reshape(-1)
    flat_y = py.reshape(-1)
    flat_x = px.reshape(-1)
    k = min(max_keypoints, flat_s.shape[0])
    _, top_i = jax.lax.top_k(flat_sel, k)
    top_s = flat_s[top_i]  # raw (boosted) response, rank bonus stripped
    out_y = flat_y[top_i]
    out_x = flat_x[top_i]
    valid = top_s > 0.0
    if k < max_keypoints:
        pad = max_keypoints - k
        top_s = jnp.pad(top_s, (0, pad))
        out_y = jnp.pad(out_y, (0, pad))
        out_x = jnp.pad(out_x, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    xy = jnp.stack([out_x, out_y], axis=-1)
    return xy, top_s, valid


def detect(
    img: jax.Array,
    threshold_hi: float = 20.0,
    threshold_lo: float = 7.0,
    cell: int = 36,
    max_keypoints: int = 512,
    edge_margin: int = 19,
    per_cell: int = 4,
):
    """Full per-level detection: dual-threshold score + NMS + grid ANMS.

    Dual-threshold semantics (reference fallback behavior at
    src/FeatureExtractor.cpp:557-608): detect at the low threshold, but add
    a large bonus to pixels that pass the high threshold, so strong corners
    dominate cell/global selection and weak ones only fill empty cells —
    the same coverage contract as per-tile retry, with no data-dependent
    control flow.
    """
    s_lo = fast_score(img, threshold_lo)
    s = nms3x3(s_lo)
    boosted = jnp.where(s > threshold_hi, s + 1024.0, s)
    xy, resp, valid = select_keypoints(
        boosted,
        cell=cell,
        max_keypoints=max_keypoints,
        edge_margin=edge_margin,
        per_cell=per_cell,
    )
    resp = jnp.where(resp > 1024.0, resp - 1024.0, resp)
    return xy, resp, valid
