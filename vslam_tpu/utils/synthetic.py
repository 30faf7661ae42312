"""Synthetic stereo(-inertial) scenes with exact ground truth.

The machine has no KITTI/EuRoC data, and the reference ships no tests
(SURVEY.md §4), so correctness is established on rendered scenes: a cloud
of textured 3D landmarks is splatted into a moving stereo rig; a smooth
analytic trajectory provides exact poses and exact IMU samples. Integration
tests assert ATE ~ 0 against these.
"""

from __future__ import annotations

import dataclasses

import numpy as np


GRAVITY_W = np.array([0.0, 0.0, -9.81])


def _np_expmap(w: np.ndarray) -> np.ndarray:
    """Host-side Rodrigues (N, 3) -> (N, 3, 3). Scene construction calls
    this thousands of times for tiny arrays; routing them through the
    jax se3 ops would cost a device dispatch each."""
    w = np.atleast_2d(np.asarray(w, np.float64))
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    theta = np.maximum(theta, 1e-12)
    k = w / theta
    K = np.zeros((len(w), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    st = np.sin(theta)[..., None]
    ct = np.cos(theta)[..., None]
    return np.eye(3) + st * K + (1.0 - ct) * (K @ K)


def _np_logmap(R: np.ndarray) -> np.ndarray:
    """Host-side SO(3) log (N, 3, 3) -> (N, 3) for small-to-moderate
    angles (the finite-difference gyro extraction uses eps-scale steps)."""
    R = np.asarray(R, np.float64)
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(tr)
    v = np.stack(
        [R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]],
        axis=-1,
    )
    s = np.where(theta > 1e-9, theta / np.maximum(2.0 * np.sin(theta), 1e-12), 0.5)
    return v * s[:, None]



def _smooth_trajectory(n_frames: int, dt: float, speed: float = 1.2, yaw_rate: float = 0.05):
    """Analytic c2w poses: forward motion along +z with gentle lateral sine
    and slow yaw. Returns (N,4,4) poses, plus callables p(t), R(t)."""

    def pos(t):
        return np.stack(
            [0.35 * np.sin(0.5 * t), 0.2 * np.sin(0.33 * t), speed * t], axis=-1
        )

    def rotvec(t):
        return np.stack(
            [0.03 * np.sin(0.4 * t), yaw_rate * t, 0.02 * np.sin(0.6 * t)], axis=-1
        )

    ts = np.arange(n_frames) * dt
    R = _np_expmap(rotvec(ts).reshape(-1, 3))
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = pos(ts)
    return ts, poses, pos, rotvec


def _make_patch(rng: np.random.Generator, size: int = 21) -> np.ndarray:
    """A high-contrast blob that triggers FAST and has a distinctive BRIEF
    signature: SMOOTH random texture (binary noise box-blurred once) with a
    bright core placed OFF-CENTER, so the intensity-centroid orientation is
    well-defined and stable across views. Smooth texture resamples stably
    under the perspective depth scaling in render()."""
    p = (rng.uniform(0.0, 1.0, size=(size + 2, size + 2)) > 0.5).astype(np.float32)
    # 3x3 box blur (keeps strong gradients but kills single-pixel aliasing)
    p = sum(
        p[dy : dy + size, dx : dx + size] for dy in range(3) for dx in range(3)
    ) / 9.0
    p = p * 190.0 + 30.0
    c = size // 2
    # off-center bright core: deterministic direction per patch
    oy, ox = rng.integers(-2, 3, size=2)
    p[c - 1 + oy : c + 2 + oy, c - 1 + ox : c + 2 + ox] = 250.0
    p[c, c] = 240.0
    return p.astype(np.float32)


@dataclasses.dataclass
class SyntheticScene:
    width: int
    height: int
    K: np.ndarray  # (3,3)
    baseline: float
    points_w: np.ndarray  # (P, 3)
    patches: np.ndarray  # (P, S, S)
    times: np.ndarray  # (N,)
    poses_c2w: np.ndarray  # (N, 4, 4) left-camera-to-world
    velocities: np.ndarray  # (N, 3) exact world-frame velocity at frame times
    imu: np.ndarray  # (M, 7) [t, gyro, accel] exact body-frame samples
    imu_hz: float

    # physical FULL width of a patch in meters. Each patch is a textured 3D
    # plane with FIXED world orientation (facing -z, the camera's initial
    # viewing direction, unless patch_R gives a per-patch frame), rendered
    # by exact per-pixel ray-plane intersection (a homography). Every
    # texture element — hence every FAST corner the extractor finds on it —
    # is a static 3D point observed consistently (subpixel) across all
    # views, like a real rigid scene. (Earlier image-space splatting
    # re-aligned the texture to each view's pixel grid, which made
    # off-center corners MOVE in 3D as the camera yawed, and
    # integer-rounded centers injected +-0.5 px per-frame jitter
    # = 0.2-1.8 m of stereo depth noise at z=5-10 m.)
    patch_phys: float = 0.35

    # background gray level. The straight-line scenes keep the legacy
    # dark background (the strong patch-vs-background edges give the
    # dense generic corners their tracking tests were gated on); circuit
    # scenes use a mid-gray background matched to the texture mean —
    # otherwise every patch boundary/coarse-octave keypoint is the same
    # "bright square on dark" signature and global descriptor retrieval
    # aliases catastrophically (measured: 90% of keys match below the
    # retrieval threshold in a view with ZERO overlap; mid-gray drops
    # that to ~5%).
    background: float = 15.0

    # optional per-patch orientation: (P, 3, 3) world frames whose columns
    # are (e_x, e_y, normal). None = every patch faces -z (the straight-
    # line scenes). Circuit scenes (make_loop_scene) use this to build a
    # cylindrical wall of inward-facing patches, so a camera driving a
    # full loop always has well-conditioned texture in view.
    patch_R: np.ndarray | None = None

    # --- hard mode (the plain bench scene is easier than real data): photometric sensor noise, exposure drift, and STATIC
    # world-anchored foreground occluders that hide landmarks as the
    # camera moves past them (the camera's own motion sweeps them across
    # the image; they are real static geometry, so occlusion robustness is
    # tested without violating the static-scene assumption the reference
    # also makes — it has no dynamic-object handling either). All
    # deterministic per (frame, eye) so runs are repeatable. ---
    noise_std: float = 0.0  # additive Gaussian pixel noise sigma
    gain_drift: float = 0.0  # multiplicative exposure oscillation amplitude
    occluders_w: np.ndarray | None = None  # (O, 3) world centers of static
    #   textureless planes (normal -z), set by make_scene(n_occluders=...)
    occluder_half: float = 0.25  # half-extent (m) of each occluder plane

    def _apply_hard_mode(self, img: np.ndarray, frame: int, right: bool) -> np.ndarray:
        W, H = self.width, self.height
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx0, cy0 = self.K[0, 2], self.K[1, 2]
        if self.occluders_w is not None and len(self.occluders_w):
            T_wc = self.poses_c2w[frame].copy()
            if right:
                T_wc[:3, 3] += T_wc[:3, :3] @ np.array([self.baseline, 0, 0])
            T_cw = np.linalg.inv(T_wc)
            pc = (T_cw[:3, :3] @ self.occluders_w.T).T + T_cw[:3, 3]
            for k in range(len(pc)):
                z = pc[k, 2]
                if z < 0.4:
                    continue  # camera has passed this occluder
                u = fx * pc[k, 0] / z + cx0
                v = fy * pc[k, 1] / z + cy0
                hw = fx * self.occluder_half / z
                hh = fy * self.occluder_half / z
                x0c, x1c = max(int(u - hw), 0), min(int(u + hw), W)
                y0c, y1c = max(int(v - hh), 0), min(int(v + hh), H)
                if x0c < x1c and y0c < y1c:
                    # smooth gradient fill: edges but no corner texture
                    gx = np.linspace(60.0, 110.0 + 15.0 * k, x1c - x0c)[None, :]
                    img[y0c:y1c, x0c:x1c] = gx
        if self.gain_drift:
            gain = 1.0 + self.gain_drift * np.sin(0.7 * frame + (0.5 if right else 0.0))
            img = img * gain + 6.0 * np.sin(1.3 * frame)
        if self.noise_std:
            rng = np.random.default_rng(7919 * frame + (997 if right else 0))
            img = img + rng.normal(0.0, self.noise_std, img.shape)
        return np.clip(img, 0.0, 255.0).astype(np.float32)

    def render(self, frame: int, right: bool = False) -> np.ndarray:
        """Render one grayscale view: per-pixel ray / patch-plane
        intersection with bilinear texture sampling. Painter order (far
        first) resolves occlusion."""
        T_wc = self.poses_c2w[frame].copy()
        if right:
            T_wc[:3, 3] += T_wc[:3, :3] @ np.array([self.baseline, 0, 0])
        R_wc = T_wc[:3, :3]
        o_w = T_wc[:3, 3]
        T_cw = np.linalg.inv(T_wc)
        pc = (T_cw[:3, :3] @ self.points_w.T).T + T_cw[:3, 3]
        z = pc[:, 2]
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        u = fx * pc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * pc[:, 1] / np.maximum(z, 1e-6) + cy
        img = np.full((self.height, self.width), self.background, dtype=np.float32)
        S = self.patches.shape[1]
        W, H = self.width, self.height
        half = 0.5 * self.patch_phys
        # patch plane basis, fixed in world: per-patch (e_x, e_y, n) from
        # patch_R, defaulting to e_x = +x, e_y = +y, normal -z
        order = np.argsort(-z)  # far first
        for i in order:
            if z[i] < 0.3:
                continue
            c_w = self.points_w[i]
            if self.patch_R is not None:
                e_x, e_y, nrm = self.patch_R[i].T
            else:
                e_x = np.array([1.0, 0.0, 0.0])
                e_y = np.array([0.0, 1.0, 0.0])
                nrm = np.array([0.0, 0.0, -1.0])
            # backface / grazing cull: camera must be on the normal side
            view = c_w - o_w
            if np.dot(view, nrm) > -0.15 * np.linalg.norm(view):
                continue
            # exact bounding box: project the 4 physical corners
            corners = c_w + half * (
                np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], np.float32)
                @ np.stack([e_x, e_y])
            )
            cc = (T_cw[:3, :3] @ corners.T).T + T_cw[:3, 3]
            if (cc[:, 2] < 0.25).any():
                continue
            uc = fx * cc[:, 0] / cc[:, 2] + cx
            vc = fy * cc[:, 1] / cc[:, 2] + cy
            if uc.max() - uc.min() < 5 and vc.max() - vc.min() < 5:
                continue  # too small to carry texture
            x0 = max(int(np.floor(uc.min())) - 1, 0)
            x1 = min(int(np.ceil(uc.max())) + 2, W)
            y0 = max(int(np.floor(vc.min())) - 1, 0)
            y1 = min(int(np.ceil(vc.max())) + 2, H)
            if x0 >= x1 or y0 >= y1:
                continue
            xs = np.arange(x0, x1, dtype=np.float32)
            ys = np.arange(y0, y1, dtype=np.float32)
            gx, gy = np.meshgrid(xs, ys)
            # world ray through each pixel center
            d_c = np.stack(
                [(gx - cx) / fx, (gy - cy) / fy, np.ones_like(gx)], axis=-1
            )
            d_w = d_c @ R_wc.T  # (h, w, 3)
            # plane: n . (o + t d - c) = 0 -> t = n.(c - o) / n.d
            dn = d_w @ nrm
            t = np.dot(nrm, c_w - o_w) / np.where(np.abs(dn) < 1e-9, 1e-9, dn)
            p_w = o_w[None, None, :] + t[..., None] * d_w
            rel = p_w - c_w
            lx = (rel @ e_x) / half  # in-plane coords in [-1, 1]
            ly = (rel @ e_y) / half
            hit = (t > 0.3) & (np.abs(lx) <= 1.0) & (np.abs(ly) <= 1.0)
            if not hit.any():
                continue
            tx = np.clip((lx + 1.0) * 0.5 * (S - 1), 0, S - 1)
            ty = np.clip((ly + 1.0) * 0.5 * (S - 1), 0, S - 1)
            xi0 = np.floor(tx).astype(int)
            yi0 = np.floor(ty).astype(int)
            xi1 = np.minimum(xi0 + 1, S - 1)
            yi1 = np.minimum(yi0 + 1, S - 1)
            ax = (tx - xi0).astype(np.float32)
            ay = (ty - yi0).astype(np.float32)
            P = self.patches[i]
            val = (
                P[yi0, xi0] * (1 - ax) * (1 - ay)
                + P[yi0, xi1] * ax * (1 - ay)
                + P[yi1, xi0] * (1 - ax) * ay
                + P[yi1, xi1] * ax * ay
            )
            sub = img[y0:y1, x0:x1]
            img[y0:y1, x0:x1] = np.where(hit, val, sub)
        if self.noise_std or self.gain_drift or self.occluders_w is not None:
            img = self._apply_hard_mode(img, frame, right)
        return img

    def project_points(self, frame: int, right: bool = False):
        """Exact (P,2) pixel locations + (P,) validity + depth for oracle checks."""
        T_wc = self.poses_c2w[frame].copy()
        if right:
            T_wc[:3, 3] += T_wc[:3, :3] @ np.array([self.baseline, 0, 0])
        T_cw = np.linalg.inv(T_wc)
        pc = (T_cw[:3, :3] @ self.points_w.T).T + T_cw[:3, 3]
        z = pc[:, 2]
        u = self.K[0, 0] * pc[:, 0] / np.maximum(z, 1e-6) + self.K[0, 2]
        v = self.K[1, 1] * pc[:, 1] / np.maximum(z, 1e-6) + self.K[1, 2]
        S = self.patches.shape[1]
        h = S // 2 + 1
        valid = (z > 0.3) & (u >= h) & (u < self.width - h) & (v >= h) & (v < self.height - h)
        return np.stack([u, v], axis=-1), valid, z


def _make_patch_coarse(rng: np.random.Generator, size: int = 21) -> np.ndarray:
    """High-contrast COARSE blob texture (half-resolution noise,
    upsampled, thresholded at the median, then one box blur): every
    corner's BRIEF signature is determined by an independent random blob
    layout, so descriptors are near-iid ACROSS patches — the property
    global retrieval (reloc / loop closure) needs from a synthetic world.
    (_make_patch's smooth fine noise + off-center core reads as one
    shared "texture family" after orientation normalization: inter-patch
    Hamming clusters far below the matching threshold.) The final blur
    makes the hard blob edges resample smoothly under the renderer's
    bilinear warp — measured temporal match stability 0.43 -> 0.54 at
    the retrieval threshold with no change in the inter-patch alias rate
    (0.056)."""
    h = (size + 2) // 2 + 1
    n = rng.uniform(0.0, 1.0, size=(h, h))
    big = np.kron(n, np.ones((2, 2)))[: size + 2, : size + 2]
    pad = size + 2 - big.shape[0]
    if pad > 0:
        big = np.pad(big, ((0, pad), (0, pad)), mode="edge")
    p = (big > np.median(big)).astype(np.float32)
    q = sum(
        p[dy : dy + size, dx : dx + size] for dy in range(3) for dx in range(3)
    ) / 9.0
    return (q * 215.0 + 25.0).astype(np.float32)


def _make_patch_natural(rng: np.random.Generator, size: int = 21) -> np.ndarray:
    """1/f-amplitude (pink) spectral noise patch — NATURAL-image
    second-order statistics (power spectrum ~ 1/f^2): the blob textures'
    descriptor statistics are hand-made and unrepresentative; natural texture has long-range correlation,
    weaker local contrast, and corner responses that ride on smooth
    gradients — the regime real FAST/BRIEF operate in."""
    n = size + 2
    f = np.fft.fftfreq(n)
    fx, fy = np.meshgrid(f, f)
    rad = np.sqrt(fx * fx + fy * fy)
    rad[0, 0] = np.abs(f[1])
    amp = 1.0 / rad
    amp[0, 0] = 0.0  # zero mean; DC restored by the gray offset below
    phase = rng.uniform(0.0, 2.0 * np.pi, (n, n))
    img = np.real(np.fft.ifft2(amp * np.exp(1j * phase)))
    img = img[1 : size + 1, 1 : size + 1]
    lo, hi = img.min(), img.max()
    img = (img - lo) / max(hi - lo, 1e-9)
    return (img * 205.0 + 25.0).astype(np.float32)


def _repeated_patch_bank(
    rng: np.random.Generator, n_points: int, n_distinct: int = 8
) -> np.ndarray:
    """REPEATED-STRUCTURE texture: only `n_distinct` base patches tiled
    across all landmarks (a building facade's identical windows). Every
    descriptor has dozens of near-exact aliases in the map — the
    worst case for wide-radius matching, retrieval and loop-closure
    verification; the ratio tests and contiguity gates must carry it."""
    bank = np.stack([_make_patch_coarse(rng) for _ in range(n_distinct)])
    return bank[np.arange(n_points) % n_distinct]


def _imu_from_analytic(n_frames, dt, imu_hz, pos_fn, rotvec_fn):
    """Exact IMU samples: finite-difference the analytic trajectory at
    high rate. Returns (M, 7) [t, gyro_xyz, accel_xyz] body-frame rows."""
    m = int(n_frames * dt * imu_hz)
    t_imu = (np.arange(m) + 1) * (1.0 / imu_hz)
    eps = 1e-4

    def R_of(t):
        return _np_expmap(rotvec_fn(np.atleast_1d(t)).reshape(-1, 3))

    R_t = R_of(t_imu)
    R_tp = R_of(t_imu + eps)
    dR = np.einsum("nij,nik->njk", R_t, R_tp)  # R^T R+
    gyro = _np_logmap(dR) / eps
    acc_w = (
        pos_fn(t_imu + eps) - 2.0 * pos_fn(t_imu) + pos_fn(t_imu - eps)
    ) / eps**2
    spec_force_w = acc_w - GRAVITY_W
    accel = np.einsum("nji,nj->ni", R_t, spec_force_w)  # body frame: R^T f_w
    return np.concatenate([t_imu[:, None], gyro, accel], axis=1)


def make_scene(
    n_frames: int = 30,
    n_points: int = 400,
    width: int = 640,
    height: int = 480,
    fps: float = 10.0,
    imu_hz: float = 200.0,
    seed: int = 0,
    depth_range: tuple | None = None,
    noise_std: float = 0.0,
    gain_drift: float = 0.0,
    n_occluders: int = 0,
    lowtex_span: tuple | None = None,
    texture: str = "classic",
    motion: str = "forward",
    ramp_tau: float | None = None,
    speed: float = 1.2,
    yaw_rate: float = 0.05,
) -> SyntheticScene:
    """`lowtex_span=(z0, z1, keep)`: a LOW-TEXTURE stretch — inside the
    world-z band [z0, z1] only a `keep` fraction of landmarks survive, so
    the camera drives through a feature desert (blank corridor wall) for
    (z1-z0)/speed seconds. Exercises the failure gate, outlier aging and
    re-acquisition on the far side — robustness the reference lacks
    entirely (SURVEY.md §5 failure-detection row).

    `ramp_tau` (seconds): start from REST with an analytic velocity
    ramp — the trajectory is time-warped by s(t) = t - tau + tau e^{-t/tau}
    (s'(0)=0, s'(inf)=1), so every velocity component including angular
    rate begins at zero, exactly like a real capture (the EuRoC MAV sits
    on the ground before takeoff). Without it a tracker initialized at
    v=0 fights an instant full-speed IMU mismatch it can never have on
    real data.

    `motion="forward"` is the original driving trajectory (+z dominant).
    `motion="lateral"` strafes sideways with slow forward drift and a
    small yaw oscillation — the EuRoC-drone-like regime MONOCULAR
    initialization needs: lateral baseline gives every landmark real
    parallax, and the wall of points stays in view instead of being
    outrun (forward motion gives near-zero parallax at the image center
    and flies past every close landmark within a few frames).

    `texture="classic"` keeps the original smooth-noise patches on a dark
    background (most tracking-test gates were tuned on it).
    `texture="distinct"` uses the coarse iid-blob patches on a mid-gray
    background (_make_patch_coarse): inter-patch BRIEF descriptors are
    near-iid, which global retrieval AND wide-search matching need —
    measured on "classic", 90% of keys Hamming-match below the retrieval
    threshold in a view with ZERO overlap, which floods ratio tests and
    wide-radius mono matching with aliases."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / fps
    if motion in ("lateral", "excited"):
        speed_x, speed_z = 0.6, 0.12
        # "excited": lateral sweep with STRONG velocity oscillation.
        # Monocular-inertial SCALE is observable only under acceleration
        # (a constant velocity error is invisible to the accelerometer,
        # so under near-constant motion mono scale + velocity drift
        # together — measured: the plain lateral sweep diverges ~1 cm/
        # frame after ~100 frames with healthy inlier counts). Real MAV
        # sequences are acceleration-rich; this variant matches that
        # regime: +-0.45 m/s velocity swing at ~0.4 m/s^2 peak.
        amp = 0.5 if motion == "excited" else 0.0

        def pos_fn(t):
            t = np.asarray(t, np.float64)
            return np.stack(
                [
                    speed_x * t + amp * np.sin(0.9 * t),
                    0.12 * np.sin(0.4 * t) + 0.3 * amp * np.sin(1.3 * t),
                    speed_z * t,
                ],
                axis=-1,
            )

        def rotvec_fn(t):
            t = np.asarray(t, np.float64)
            return np.stack(
                [0.02 * np.sin(0.35 * t), 0.06 * np.sin(0.25 * t),
                 0.015 * np.sin(0.5 * t)], axis=-1,
            )

        ts = np.arange(n_frames) * dt
        R = _np_expmap(rotvec_fn(ts).reshape(-1, 3))
        poses = np.tile(np.eye(4), (n_frames, 1, 1))
        poses[:, :3, :3] = R
        poses[:, :3, 3] = pos_fn(ts)
    else:
        # yaw_rate matters on LONG sequences: the forward scene's patches
        # face -z, so total yaw must stay well under ~45 deg or the wall
        # turns edge-on and texture degenerates (a 1000-frame run at the
        # old fixed 0.05 rad/s accumulated 143 deg and drift x20'd)
        ts, poses, pos_fn, rotvec_fn = _smooth_trajectory(
            n_frames, dt, speed=speed, yaw_rate=yaw_rate
        )

    if ramp_tau is not None:
        tau = float(ramp_tau)
        base_pos, base_rot = pos_fn, rotvec_fn

        def _warp(t):
            t = np.asarray(t, np.float64)
            return t - tau + tau * np.exp(-np.maximum(t, 0.0) / tau)

        def pos_fn(t):
            return base_pos(_warp(t))

        def rotvec_fn(t):
            return base_rot(_warp(t))

        R = _np_expmap(rotvec_fn(ts).reshape(-1, 3))
        poses = np.tile(np.eye(4), (n_frames, 1, 1))
        poses[:, :3, :3] = R
        poses[:, :3, 3] = pos_fn(ts)

    K = np.array([[460.0, 0, width / 2.0], [0, 460.0, height / 2.0], [0, 0, 1.0]])
    baseline = 0.12

    if motion in ("lateral", "excited"):
        # a wall of landmarks spanning the lateral sweep
        span = 0.6 * n_frames * dt
        zmin, zmax = depth_range if depth_range else (3.0, 9.0)
        pts = np.stack(
            [
                rng.uniform(-3.0, span + 3.0, n_points),
                rng.uniform(-2.5, 2.5, n_points),
                rng.uniform(zmin, zmax, n_points),
            ],
            axis=-1,
        )
    else:
        # landmarks in a slab in front of the whole trajectory
        total_len = 1.2 * n_frames * dt
        zmin, zmax = depth_range if depth_range else (1.5, total_len + 14.0)
        pts = np.stack(
            [
                rng.uniform(-6.0, 6.0, n_points),
                rng.uniform(-4.0, 4.0, n_points),
                rng.uniform(zmin, zmax, n_points),
            ],
            axis=-1,
        )
    if lowtex_span is not None:
        z0, z1, keep = lowtex_span
        inside = (pts[:, 2] >= z0) & (pts[:, 2] <= z1)
        drop = inside & (rng.uniform(0.0, 1.0, n_points) > keep)
        pts = pts[~drop]
        n_points = len(pts)
    if texture == "repeated":
        patches = _repeated_patch_bank(rng, n_points)
    else:
        patch_fn = {
            "distinct": _make_patch_coarse,
            "natural": _make_patch_natural,
        }.get(texture, _make_patch)
        patches = np.stack([patch_fn(rng) for _ in range(n_points)])

    # static world-anchored occluder planes, staggered along (and slightly
    # off) the camera path so forward motion sweeps them across the view
    occluders_w = None
    if n_occluders:
        occluders_w = np.stack(
            [
                np.array([
                    (-1.0) ** k * (0.55 + 0.2 * k),
                    0.25 * np.sin(1.7 * k),
                    2.5 + (total_len + 4.0) * k / n_occluders,
                ])
                for k in range(n_occluders)
            ]
        )

    imu = _imu_from_analytic(n_frames, dt, imu_hz, pos_fn, rotvec_fn)
    eps = 1e-4
    vel = (pos_fn(ts + eps) - pos_fn(ts - eps)) / (2 * eps)

    return SyntheticScene(
        width=width,
        height=height,
        K=K,
        baseline=baseline,
        points_w=pts,
        patches=patches,
        times=ts,
        poses_c2w=poses,
        velocities=vel,
        imu=imu,
        imu_hz=imu_hz,
        background=15.0 if texture == "classic" else 120.0,
        noise_std=noise_std,
        gain_drift=gain_drift,
        occluders_w=occluders_w,
    )


def make_loop_scene(
    n_frames: int = 325,
    n_points: int = 700,
    width: int = 512,
    height: int = 384,
    fps: float = 10.0,
    imu_hz: float = 200.0,
    seed: int = 0,
    radius: float = 6.0,
    wall_radius: float = 10.0,
    loops: float = 1.1,
    noise_std: float = 0.0,
    gain_drift: float = 0.0,
) -> SyntheticScene:
    """A CLOSED-CIRCUIT scene for end-to-end loop-closure validation: the
    camera drives `loops` revolutions of a circle (radius m) inside a
    cylindrical wall of inward-facing textured patches, returning to its
    start pose with the same heading — the canonical revisit geometry.
    Pure yaw accumulates heading drift that compounds into position error
    over the lap, which a verified loop edge + pose graph must remove
    (the reference's loop-closure state is vestigial, Map.h:122-127 —
    this scene validates the real detector against live tracker output).

    Geometry: camera at C + radius*(-cos wt, y_wobble, sin wt) heading
    tangentially (yaw = wt); wall patches at angle phi on radii around
    `wall_radius` with normals pointing at C, so the visible arc
    (phi - yaw in ~[30, 90] deg) is always seen at benign (<40 deg)
    incidence and 5-11 m depth, uniformly over the whole lap."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / fps
    omega = 2.0 * np.pi * loops / (n_frames * dt)
    C = np.array([radius, 0.0, 0.0])

    def pos(t):
        t = np.asarray(t, np.float64)
        th = omega * t
        return np.stack(
            [
                C[0] - radius * np.cos(th),
                0.15 * np.sin(0.4 * t),
                radius * np.sin(th),
            ],
            axis=-1,
        )

    def rotvec(t):
        t = np.asarray(t, np.float64)
        return np.stack(
            [np.zeros_like(t), omega * t, np.zeros_like(t)], axis=-1
        )

    ts = np.arange(n_frames) * dt
    R = _np_expmap(rotvec(ts).reshape(-1, 3))
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = pos(ts)

    K = np.array(
        [[460.0, 0, width / 2.0], [0, 460.0, height / 2.0], [0, 0, 1.0]]
    )
    baseline = 0.12

    # cylindrical wall: angles uniform over the lap, jittered radius/height
    phi = rng.uniform(0.0, 2.0 * np.pi, n_points)
    r_k = rng.uniform(0.85 * wall_radius, 1.15 * wall_radius, n_points)
    h_k = rng.uniform(-2.4, 2.4, n_points)
    pts = np.stack(
        [C[0] - r_k * np.cos(phi), h_k, r_k * np.sin(phi)], axis=-1
    )
    # inward patch frames: normal points at the circuit axis
    nrm = np.stack([np.cos(phi), np.zeros_like(phi), -np.sin(phi)], axis=-1)
    e_y = np.tile(np.array([0.0, 1.0, 0.0]), (n_points, 1))
    e_x = np.stack([-np.sin(phi), np.zeros_like(phi), -np.cos(phi)], axis=-1)
    patch_R = np.stack([e_x, e_y, nrm], axis=-1).astype(np.float64)
    patches = np.stack([_make_patch_coarse(rng) for _ in range(n_points)])

    imu = _imu_from_analytic(n_frames, dt, imu_hz, pos, rotvec)
    eps = 1e-4
    vel = (pos(ts + eps) - pos(ts - eps)) / (2 * eps)

    return SyntheticScene(
        width=width,
        height=height,
        K=K,
        baseline=baseline,
        points_w=pts,
        patches=patches,
        times=ts,
        poses_c2w=poses,
        velocities=vel,
        imu=imu,
        imu_hz=imu_hz,
        patch_R=patch_R,
        patch_phys=0.5,
        background=120.0,
        noise_std=noise_std,
        gain_drift=gain_drift,
    )
