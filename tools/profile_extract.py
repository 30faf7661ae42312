"""Micro-profile of extraction sub-ops on the live device."""

import time

import numpy as np


def timeit(fn, n=20, warmup=3):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1000.0


def main():
    import jax

    from vslam_tpu.utils import compile_cache

    compile_cache.setup()
    import jax.numpy as jnp

    from vslam_tpu.ops import extract, fast, orb, pyramid

    H, W = 480, 752
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    jax.block_until_ready(img)

    # transfer latency probe
    tiny = np.zeros(4, np.float32)
    big = rng.uniform(0, 255, (2, H, W)).astype(np.uint8)
    print(f"upload 16B  : {timeit(lambda: jnp.asarray(tiny)):8.2f} ms")
    print(f"upload 722KB: {timeit(lambda: jnp.asarray(big)):8.2f} ms")
    dev_scalar = jnp.float32(1.0)

    def fetch():
        return np.asarray(jnp.sin(dev_scalar))

    t0 = time.perf_counter()
    for _ in range(20):
        fetch()
    print(f"roundtrip   : {(time.perf_counter() - t0) / 20 * 1000:8.2f} ms  (dispatch+fetch scalar)")

    pyr = jax.jit(lambda im: pyramid.build_pyramid(im, 8, 1.2))
    print(f"pyramid x8  : {timeit(lambda: pyr(img)):8.2f} ms")

    levels = pyr(img)

    score = jax.jit(lambda im: fast.fast_score(im, 7.0))
    print(f"fast L0     : {timeit(lambda: score(img)):8.2f} ms")

    nms = jax.jit(lambda im: fast.nms3x3(fast.fast_score(im, 7.0)))
    print(f"fast+nms L0 : {timeit(lambda: nms(img)):8.2f} ms")

    det = jax.jit(
        lambda im: fast.detect(im, 20.0, 7.0, cell=35, max_keypoints=256, edge_margin=19)
    )
    print(f"detect L0   : {timeit(lambda: det(img)):8.2f} ms  (score+nms+topk)")

    blur = jax.jit(pyramid.gaussian_blur)
    print(f"blur L0     : {timeit(lambda: blur(img)):8.2f} ms")

    xy, resp, valid = det(img)
    blurred = blur(img)

    ori = jax.jit(orb.orientations)
    print(f"orient 256  : {timeit(lambda: ori(blurred, xy)):8.2f} ms  (31x31 patch gather)")

    ang = ori(blurred, xy)
    br = jax.jit(orb.brief_descriptors)
    print(f"brief 256   : {timeit(lambda: br(blurred, xy, ang)[1]):8.2f} ms")

    full = jax.jit(
        lambda im: extract.extract(im, n_levels=8, scale=1.2, total=1024,
                                   edge_margin=19, fast_hi=20.0, fast_lo=7.0)
    )
    print(f"extract full: {timeit(lambda: full(img).xy):8.2f} ms")

    # how much of full extract is detection vs description?
    def detect_only(im):
        levels = pyramid.build_pyramid(im, 8, 1.2)
        quotas = extract.level_quotas(1024, 8, 1.2)
        out = []
        for l, (im_l, q) in enumerate(zip(levels, quotas)):
            if q <= 0:
                continue
            h, w = im_l.shape
            out.append(fast.detect(im_l, 20.0, 7.0, cell=min(35, max(h, w)),
                                   max_keypoints=q, edge_margin=min(19, min(h, w) // 4)))
        return out

    d = jax.jit(detect_only)
    print(f"detect x8   : {timeit(lambda: d(img)[0][0]):8.2f} ms  (pyramid+fast+topk all levels)")


if __name__ == "__main__":
    main()
