"""CLI driver + native-IO integration: a synthetic PNG sequence in KITTI
layout driven through examples/run_dataset.py (the reference VIOSlam
driver's role, src/VIOSlam.cpp:141-329) — native prefetcher default path,
checkpoint/resume continuation, and viz/PLY outputs."""

import os
import subprocess
import sys

import numpy as np
import pytest

from vslam_tpu.utils import datasets, synthetic, trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(REPO, "examples", "run_dataset.py")

W, H, FX, BL = 320, 240, 460.0, 0.12
N_FRAMES = 10


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """Synthetic stereo sequence rendered to PNGs in KITTI odometry layout
    (image_0/, image_1/, times.txt) + a matching config."""
    from PIL import Image

    root = tmp_path_factory.mktemp("kitti_seq")
    scene = synthetic.make_scene(
        n_frames=N_FRAMES, n_points=400, width=W, height=H, fps=10.0, seed=7
    )
    for sub in ("image_0", "image_1"):
        os.makedirs(root / sub)
    for f in range(N_FRAMES):
        for right, sub in ((False, "image_0"), (True, "image_1")):
            img = np.clip(scene.render(f, right=right), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / sub / f"{f:06d}.png")
    np.savetxt(root / "times.txt", scene.times)
    cfg = root / "config.yaml"
    cfg.write_text(f"""rectified: true
slamMode: 1
dataset: "KITTI"
imagesPath: "{root}"
fileExtension: ".png"
Camera: {{width: {W}, height: {H}, fps: 10.0, bl: {BL}}}
Camera_l: {{fx: {FX}, fy: {FX}, cx: {W/2.0}, cy: {H/2.0}}}
Camera_r: {{fx: {FX}, fy: {FX}, cx: {W/2.0}, cy: {H/2.0}}}
FE: {{nFeatures: 512, nLevels: 4, imScale: 1.2, edgeThreshold: 19, maxFastThreshold: 20, minFastThreshold: 7}}
""")
    return root, scene


def _run_driver(args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, DRIVER, *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=1800,
    )
    assert r.returncode == 0, f"driver failed:\n{r.stdout}\n{r.stderr}"
    return r


def test_prefetched_frames_match_pil_path(kitti_dir):
    """The native prefetcher must deliver the same pixels, in order, as the
    PIL fallback."""
    root, _ = kitti_dir
    from vslam_tpu import native

    if not native.available():
        pytest.skip(f"native IO unavailable: {native.build_error()}")
    ds = datasets.KittiDataset(str(root))
    nat = list(ds.frames(prefetch=True))
    pil = list(ds.frames(prefetch=False))
    assert len(nat) == len(pil) == N_FRAMES
    for a, b in zip(nat, pil):
        assert a.index == b.index and a.t == b.t
        np.testing.assert_array_equal(
            np.asarray(a.left, np.uint8), np.asarray(b.left, np.uint8)
        )
        np.testing.assert_array_equal(
            np.asarray(a.right, np.uint8), np.asarray(b.right, np.uint8)
        )


@pytest.mark.slow
def test_driver_end_to_end_with_viz(kitti_dir, tmp_path):
    root, scene = kitti_dir
    out = tmp_path / "traj.txt"
    html = tmp_path / "map.html"
    ply = tmp_path / "map.ply"
    dbg = tmp_path / "dbg"
    r = _run_driver(
        [str(root / "config.yaml"), "--out", str(out),
         "--viz", str(html), "--ply", str(ply),
         "--debug-dir", str(dbg), "--debug-every", "4"],
        cwd=str(tmp_path),
    )
    # per-frame keypoint overlays were written (reference drawKeys analog)
    overlays = sorted(dbg.glob("frame_*.png"))
    assert len(overlays) >= 2, list(dbg.iterdir()) if dbg.exists() else "no dir"
    from PIL import Image

    im = np.asarray(Image.open(overlays[0]))
    assert im.ndim == 3 and im.shape[2] == 3  # RGB overlay, not raw gray
    assert (im.max(axis=-1) != im.min(axis=-1)).any()  # colored marks exist
    assert "io=native" in r.stdout or "io=pil" in r.stdout
    poses34 = np.loadtxt(out).reshape(-1, 3, 4)
    assert len(poses34) == N_FRAMES
    poses = np.tile(np.eye(4), (len(poses34), 1, 1))
    poses[:, :3, :] = poses34
    # uint8 PNG quantization adds photometric noise on top of the exact
    # renderer; still must track at cm scale
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:N_FRAMES], align=False)
    assert ate < 0.08, ate
    assert html.stat().st_size > 1000
    assert ply.stat().st_size > 100


@pytest.mark.slow
def test_driver_checkpoint_resume_continues(kitti_dir, tmp_path):
    """Interrupt at frame 6, checkpoint, resume to the end: the resumed
    trajectory must track the uninterrupted run closely (driver-level
    checkpoint/resume, SURVEY.md §5; extends tests/test_persistence.py
    through the CLI). Exact bitwise equality is NOT the contract: the
    interrupted run drains its depth-2 dispatch pipeline at exit, so a KF
    that materializes during the flush gets no BA pass before the
    snapshot — a cm-scale, not structural, difference."""
    root, scene = kitti_dir
    cfg = str(root / "config.yaml")
    full = tmp_path / "full.txt"
    _run_driver([cfg, "--out", str(full)], cwd=str(tmp_path))

    ck = tmp_path / "ck.npz"
    part = tmp_path / "part.txt"
    _run_driver(
        [cfg, "--limit", "6", "--out", str(part), "--checkpoint", str(ck)],
        cwd=str(tmp_path),
    )
    assert ck.exists()
    resumed = tmp_path / "resumed.txt"
    _run_driver(
        [cfg, "--resume", str(ck), "--out", str(resumed)], cwd=str(tmp_path)
    )
    a = np.loadtxt(full)
    b = np.loadtxt(resumed)
    assert a.shape == b.shape == (N_FRAMES, 12)
    np.testing.assert_allclose(b, a, atol=0.05)
    poses = np.tile(np.eye(4), (N_FRAMES, 1, 1))
    poses[:, :3, :] = b.reshape(N_FRAMES, 3, 4)
    ate = trajectory.ate_rmse(poses, scene.poses_c2w[:N_FRAMES], align=False)
    assert ate < 0.08, ate
