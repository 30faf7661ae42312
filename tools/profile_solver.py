"""Time motion-only LM and projection matching standalone on device."""

import time

import numpy as np


def timeit(fn, n=20, warmup=3):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1000.0


def main():
    import jax

    from vslam_tpu.utils import compile_cache

    compile_cache.setup()
    import jax.numpy as jnp

    from vslam_tpu.ops import lm, project_match

    A, N = 4096, 1024
    rng = np.random.default_rng(0)
    K = jnp.asarray([[460.0, 0, 376.0], [0, 460.0, 240.0], [0, 0, 1.0]], jnp.float32)
    pts = jnp.asarray(np.stack([rng.uniform(-5, 5, A), rng.uniform(-3, 3, A), rng.uniform(4, 40, A)], -1).astype(np.float32))
    obs = jnp.asarray(rng.uniform(0, 480, (A, 3)).astype(np.float32))
    w = jnp.ones((A,), jnp.float32)
    stereo = jnp.asarray(rng.integers(0, 2, A).astype(bool))
    valid = jnp.asarray(rng.integers(0, 2, A).astype(bool))
    T0 = jnp.eye(4, dtype=jnp.float32)

    for iters in (100, 30, 10):
        f = jax.jit(lambda T0=T0, it=iters: lm.motion_only_ba(
            T0, pts, obs, w, stereo, jnp.zeros_like(stereo), valid, K,
            jnp.float32(0.12), max_iters=it)[0])
        print(f"motion_ba it={iters:3d}: {timeit(f):7.2f} ms")

    mp_pred = jnp.asarray(rng.uniform(0, 700, (A, 2)).astype(np.float32))
    mp_oct = jnp.asarray(rng.integers(0, 8, A).astype(np.int32))
    mp_desc = jnp.asarray((rng.integers(0, 2, (A, 256)) * 2 - 1).astype(np.int8))
    k_xy = jnp.asarray(rng.uniform(0, 700, (N, 2)).astype(np.float32))
    k_oct = jnp.asarray(rng.integers(0, 8, N).astype(np.int32))
    k_desc = jnp.asarray((rng.integers(0, 2, (N, 256)) * 2 - 1).astype(np.int8))
    k_valid = jnp.ones((N,), bool)
    sf = jnp.asarray([1.2**l for l in range(8)], jnp.float32)

    g = jax.jit(lambda: project_match.match_by_projection(
        mp_pred, mp_oct, mp_desc, valid, k_xy, k_oct, k_desc, k_valid,
        jnp.float32(40.0), sf, jnp.float32(100.0), jnp.float32(0.8))[0])
    print(f"proj match 4096x1024: {timeit(g):7.2f} ms")

    pc = jax.jit(lambda: project_match.predict_and_cull(
        T0, pts, valid, K, jnp.float32(0.12), 752, 480,
        jnp.ones((A,), jnp.float32) * 30, jnp.ones((A,), jnp.float32), n_levels=8)["pred_l"])
    print(f"predict_cull        : {timeit(pc):7.2f} ms")


if __name__ == "__main__":
    main()
