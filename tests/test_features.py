import jax
import jax.numpy as jnp
import numpy as np

from vslam_tpu.ops import extract, fast, hamming, orb, pyramid
from vslam_tpu.utils import synthetic

CIRCLE = fast._CIRCLE


def numpy_fast_oracle(img: np.ndarray, t: float):
    """Independent scalar FAST-9/16 implementation (the spec)."""
    H, W = img.shape
    score = np.zeros((H, W), np.float32)
    for y in range(3, H - 3):
        for x in range(3, W - 3):
            ring = np.array([img[y + dy, x + dx] for dx, dy in CIRCLE], np.float32)
            db = ring - img[y, x]
            best = 0.0
            for d in (db, -db):
                dd = np.concatenate([d, d[:8]])
                for k in range(16):
                    m = dd[k : k + 9].min()
                    best = max(best, m)
            if best > t:
                score[y, x] = best
    return score


def _test_image(seed=3, h=64, w=80):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 40.0, np.float32)
    # a few bright/dark blobs to create corners
    for _ in range(12):
        y, x = rng.integers(8, h - 8), rng.integers(8, w - 8)
        s = rng.integers(2, 5)
        img[y : y + s, x : x + s] = rng.choice([220.0, 5.0])
    img += rng.normal(0, 1.0, img.shape).astype(np.float32)
    return img


def test_fast_score_matches_oracle():
    img = _test_image()
    t = 20.0
    oracle = numpy_fast_oracle(img, t)
    ours = np.asarray(jax.jit(fast.fast_score, static_argnums=())(jnp.asarray(img), t))
    np.testing.assert_allclose(ours, oracle, atol=1e-3)


def test_nms_keeps_single_max():
    img = _test_image(seed=5)
    s = fast.fast_score(jnp.asarray(img), 7.0)
    n = np.asarray(fast.nms3x3(s))
    # every surviving pixel is the max of its 3x3 neighborhood
    ys, xs = np.nonzero(n)
    sn = np.asarray(s)
    for y, x in zip(ys, xs):
        patch = sn[max(0, y - 1) : y + 2, max(0, x - 1) : x + 2]
        assert n[y, x] == patch.max()
    # no two adjacent survivors
    occ = n > 0
    assert not (occ[:, :-1] & occ[:, 1:]).any()
    assert not (occ[:-1] & occ[1:]).any()


def test_select_keypoints_quota_and_coverage():
    rng = np.random.default_rng(0)
    score = rng.uniform(0, 100, size=(144, 144)).astype(np.float32)
    xy, resp, valid = fast.select_keypoints(
        jnp.asarray(score), cell=36, max_keypoints=32, edge_margin=4, per_cell=4
    )
    xy, resp, valid = map(np.asarray, (xy, resp, valid))
    assert valid.sum() == 32
    # coverage-first order: every occupied cell's best corner precedes any
    # cell's 2nd-best (SSC priority, tests/test_anms_ssc.py); within a
    # rank tier responses are sorted descending. With a dense 4x4 grid
    # the first 16 slots are exactly the 16 per-cell maxima.
    cells = xy // 36
    cell_id = cells[:, 0] * 4 + cells[:, 1]
    first16 = cell_id[:16]
    assert len(set(first16.tolist())) == 16  # one per cell
    # descending within tier, up to the f32 resolution of the packed
    # (rank-bonus + response) sort key (~0.004 at |key| ~ 49k)
    assert (np.diff(resp[:16]) <= 0.05).all()
    assert (np.diff(resp[16:32]) <= 0.05).all()
    # responses match the score map at the reported coords
    for i in range(32):
        assert abs(score[xy[i, 1], xy[i, 0]] - resp[i]) < 1e-4
    # coverage: with per-cell cap 4 and a 4x4 grid, no cell dominates
    _, counts = np.unique(cell_id[valid], return_counts=True)
    assert counts.max() <= 4


def test_detect_on_synthetic_scene_finds_patch_corners():
    scene = synthetic.make_scene(n_frames=2, n_points=40, width=320, height=240, seed=2)
    img = scene.render(0)
    xy, resp, valid = jax.jit(
        lambda im: fast.detect(im, max_keypoints=128, edge_margin=10)
    )(jnp.asarray(img))
    xy, valid = np.asarray(xy), np.asarray(valid)
    assert valid.sum() > 20
    # most detections should be near a rendered patch center
    uv, vis, _ = scene.project_points(0)
    centers = uv[vis]
    d = np.linalg.norm(xy[valid][:, None, :] - centers[None], axis=-1).min(axis=1)
    # corners of the 13x13 patches sit up to ~9 px from their centers
    assert np.median(d) < 9.5


def test_orientation_rotates_with_image():
    # asymmetric blob: bright on one side
    img = np.full((64, 64), 20.0, np.float32)
    img[28:37, 32:44] = 200.0  # mass to the +x side of (32, 32)
    a0 = float(orb.orientations(jnp.asarray(img), jnp.asarray([[32, 32]]))[0])
    # rotate image 90 deg CW: mass moves to +y side
    img90 = np.rot90(img, k=-1).copy()
    a1 = float(orb.orientations(jnp.asarray(img90), jnp.asarray([[31, 32]]))[0])
    diff = (a1 - a0 + np.pi) % (2 * np.pi) - np.pi
    assert abs(diff - np.pi / 2) < 0.15


def test_brief_consistency_across_views():
    scene = synthetic.make_scene(n_frames=3, n_points=50, width=320, height=240, seed=4)
    img0 = scene.render(0)
    img1 = scene.render(1)
    uv0, vis0, z0 = scene.project_points(0)
    uv1, vis1, _ = scene.project_points(1)
    # restrict to points whose patch has real apparent texture detail
    # (projected side >= ~18 px): a 31-px BRIEF window around a far tiny
    # patch is mostly flat background + one bright blob — all such patches
    # legitimately look alike, so discriminativeness is only a meaningful
    # property where the texture resolves (the live matcher's octave +
    # scale-band gates impose the same restriction).
    big = z0 < scene.K[0, 0] * scene.patch_phys / 18.0
    both = vis0 & vis1 & big
    ids = np.nonzero(both)[0][:16]
    xy0 = jnp.asarray(np.round(uv0[ids]).astype(np.int32))
    xy1 = jnp.asarray(np.round(uv1[ids]).astype(np.int32))

    @jax.jit
    def describe(img, xy):
        blurred = pyramid.gaussian_blur(jnp.asarray(img))
        ang = orb.orientations(blurred, xy)
        return orb.brief_descriptors(blurred, xy, ang)

    p0, s0 = describe(jnp.asarray(img0), xy0)
    p1, s1 = describe(jnp.asarray(img1), xy1)
    d = np.asarray(hamming.hamming_matrix(s0, s1))
    dp = np.asarray(hamming.packed_hamming(p0, p1))
    # matmul form and packed popcount form agree exactly
    np.testing.assert_array_equal(d.astype(np.int32), dp)
    # same landmark across views: distance far below the 75 stereo threshold
    diag = np.diag(d)
    off = d + np.eye(len(ids)) * 1e9
    assert np.median(diag) < 60.0
    # descriptors are discriminative: true match beats the best impostor
    assert (diag < off.min(axis=1)).mean() > 0.8


def test_pyramid_shapes_and_content():
    img = jnp.asarray(_test_image(h=96, w=128))
    levels = pyramid.build_pyramid(img, n_levels=4, scale=1.2)
    shapes = pyramid.level_shapes(96, 128, 4, 1.2)
    assert [l.shape for l in levels] == shapes
    # downsampled mean stays close to original mean
    for l in levels:
        assert abs(float(jnp.mean(l)) - float(jnp.mean(img))) < 4.0


def test_gaussian_blur_preserves_mean_and_smooths():
    img = jnp.asarray(_test_image(seed=9))
    out = pyramid.gaussian_blur(img)
    assert abs(float(jnp.mean(out)) - float(jnp.mean(img))) < 0.5
    assert float(jnp.var(out)) < float(jnp.var(img))


def test_brief_matmul_matches_gather_oracle():
    """The one-hot matmul BRIEF (brief_from_patches) must be bit-exact vs the
    gather oracle (brief_from_patches_gather)."""
    rng = np.random.default_rng(7)
    patches = jnp.asarray(rng.uniform(0, 255, size=(2, 64, 31, 31)).astype(np.float32))
    angle = jnp.asarray(rng.uniform(-np.pi, np.pi, size=(2, 64)).astype(np.float32))
    pk_mm, sg_mm = orb.brief_from_patches(patches, angle)
    pk_g, sg_g = orb.brief_from_patches_gather(patches, angle)
    assert np.array_equal(np.asarray(pk_mm), np.asarray(pk_g))
    assert np.array_equal(np.asarray(sg_mm), np.asarray(sg_g))


def test_onehot_patch_extraction_matches_direct_indexing():
    """extract_batch's one-hot-matmul patch path must be exact: descriptors
    at interior keypoints equal brief_descriptors on the blurred level."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, size=(96, 128)).astype(np.float32)
    keys = extract.extract(jnp.asarray(img), n_levels=2, scale=1.2, total=64)
    blurred = pyramid.gaussian_blur(jnp.asarray(img))
    l0 = np.asarray(keys.octave) == 0
    interior = (
        l0
        & np.asarray(keys.valid)
        & (np.asarray(keys.xy)[:, 0] >= 15) & (np.asarray(keys.xy)[:, 0] < 128 - 15)
        & (np.asarray(keys.xy)[:, 1] >= 15) & (np.asarray(keys.xy)[:, 1] < 96 - 15)
    )
    if not interior.any():
        return
    xy = jnp.asarray(np.asarray(keys.xy)[interior].astype(np.int32))
    ang = jnp.asarray(np.asarray(keys.angle)[interior])
    pk_ref, _ = orb.brief_descriptors(blurred, xy, ang)
    pk_new = np.asarray(keys.packed)[interior]
    assert np.array_equal(np.asarray(pk_ref), pk_new)


def test_extract_windows_matches_direct_indexing():
    """ops/patches.extract_windows (the XLA gather) must equal direct
    advanced indexing for in-range top-left corners, for both the BRIEF
    (31x31) and SAD (11x21) window shapes."""
    from vslam_tpu.ops import patches as patches_mod

    rng = np.random.default_rng(5)
    B, H, W, Q = 2, 96, 160, 37
    img = jnp.asarray(rng.uniform(0, 255, (B, H, W)).astype(np.float32))
    for P, Pw in ((31, 31), (11, 21)):
        x0 = jnp.asarray(rng.integers(0, W - Pw, (B, Q)).astype(np.int32))
        y0 = jnp.asarray(rng.integers(0, H - P, (B, Q)).astype(np.int32))
        out = np.asarray(patches_mod.extract_windows(img, x0, y0, P, Pw))
        imn = np.asarray(img)
        for b in range(B):
            for i in range(Q):
                xx, yy = int(x0[b, i]), int(y0[b, i])
                np.testing.assert_array_equal(
                    out[b, i], imn[b, yy : yy + P, xx : xx + Pw]
                )


def test_packed_descriptor_roundtrip_and_matmul_parity():
    """The map stores descriptors bit-packed (W, K, 8) uint32 (32x less
    HBM than the +-1 int8 form); matchers unpack per block. pack/unpack
    must be exact inverses in both orders, match ops/orb's packing
    convention, and the unpacked matmul Hamming must equal the SWAR
    popcount oracle on the packed form."""
    rng = np.random.default_rng(11)
    signed = (rng.integers(0, 2, (64, 256)) * 2 - 1).astype(np.int8)
    packed = hamming.pack_signed(jnp.asarray(signed))
    assert packed.shape == (64, 8) and packed.dtype == jnp.uint32
    back = np.asarray(hamming.unpack_signed(packed))
    np.testing.assert_array_equal(back, signed)
    np.testing.assert_array_equal(hamming.unpack_signed_np(packed), signed)

    other = (rng.integers(0, 2, (48, 256)) * 2 - 1).astype(np.int8)
    d_matmul = np.asarray(
        hamming.hamming_matrix(jnp.asarray(signed), jnp.asarray(other))
    )
    d_pop = np.asarray(
        hamming.packed_hamming(packed, hamming.pack_signed(jnp.asarray(other)))
    )
    np.testing.assert_array_equal(d_matmul.astype(np.int32), d_pop)
