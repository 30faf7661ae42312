"""Smoke check: the SLAM main path on one NVIDIA GPU.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpus  # four GPUs: the multi-device path only

Everything runs in this one process. Phases, in order; a failed phase
exits non-zero, none is caught and skipped:

device    JAX's backend must be "gpu". Prints the card's name and power
          limit as nvidia-smi reports them; every number printed after it
          is for that card.
kernels   the frame program's kernels at bench widths against plain
          references: ops/patches.extract_windows against NumPy indexing
          (bit for bit: it is a copy), ops/hamming.hamming_matrix against
          the SWAR popcount oracle on the CPU (exact: integers),
          ops/orb.brief_from_patches against its gather oracle (identical
          bits).
frame     one tracker._track_step at EuRoC shapes (__graft_entry__.entry)
          on the GPU and on the CPU, from the same state.
local_ba  the fused 2-round Schur local BA at the live window shape
          (__graft_entry__.ba_problem) on the GPU and on the CPU.
system    VSlamSystem through examples/run_synthetic.run: the 80-frame
          EuRoC-geometry stereo scene with async local BA, and the 60-frame
          lateral mono-IMU scene, against their ATE gates.

--four-gpus runs only the multi-device path and what it is compared with:
the sharded local BA over a 4-GPU mesh (also slab-chunked) against the
one-GPU solve, VSlamSystem(shards=4) against shards=1, and the
multi-sequence frontend with its sequence axis sharded over 4 GPUs against
each sequence's one-GPU frame step.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import vslam_tpu  # noqa: E402,F401  (process-wide "highest" matmul precision)
from vslam_tpu.utils import compile_cache  # noqa: E402

# --- tolerances, each with its reason -------------------------------------
# frame program, GPU vs CPU: Gaussian blur and pyramid-resize sums are
# reduced in another order, so FAST scores that tie at the threshold or at
# a cell's top-k cut may flip and a few keypoints change
FRAME_KEYS_REL = 0.01
# ... the motion-only LM then solves over those slightly different match
# sets; the optimum moves by far less than a millimetre / a few millidegrees
FRAME_POSE_M = 1e-3
FRAME_POSE_DEG = 0.05
# local BA, GPU vs CPU (and sharded vs one device): the same problem and
# iteration count, but the normal-equation assembly, the Schur reduction
# and the Cholesky sum in another order, and on the GPU not even in the
# same order from one run to the next. On the H100 two runs of this phase
# gave chi2 10524.2480 and 10528.9688 against the CPU's 10524.2471 (rel
# 9.3e-8 and 4.5e-4) and poses 4.7e-7 m and 4.4e-5 m apart; the phase
# prints the spread of its own repeated GPU solves beside them
BA_POSE_M = 1e-4
BA_CHI2_REL = 1e-3
# end to end through VSlamSystem: the gates of tests/test_system.py
STEREO_ATE_M = 0.03
MONO_ATE_M = 0.05
MIN_LOCAL_BAS = 2
# sharded vs unsharded facade: a sanity bound only (tests/test_parallel.py's
# trajectory bound). Two runs of the same facade on the GPU already differ
# (their local BAs do), so a keyframe decision can flip; at least this
# share of the keyframes must be common to both runs. The tight check of
# the sharded BA is phase_sharded_ba's, on one problem
SHARD_KF_POSE_M = 0.01
SHARD_KF_COMMON = 0.8
# frames of the two system scenes (examples/run_synthetic.SCENES)
STEREO_FRAMES = 80
MONO_FRAMES = 60

CARD = ""  # "name, power limit" from nvidia-smi, set by check_device
T_START = time.perf_counter()


def log(phase: str, msg: str) -> None:
    print(f"[{phase} +{time.perf_counter() - T_START:.0f}s] {msg} | {CARD}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle between two rotations; ||Ra - Rb||_F = 2 sqrt(2) sin(angle/2)
    stays accurate near zero, where arccos of the trace does not."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0))))


def _median_ms(fn, n: int = 10) -> float:
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


# --- device ---------------------------------------------------------------
def check_device(n_gpus: int) -> list:
    """The GPUs JAX sees (at least `n_gpus`), after printing the cards'
    name and power limit. Exits non-zero without a GPU backend."""
    global CARD
    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (backend {backend!r})")
    gpus = jax.devices("gpu")
    if len(gpus) < n_gpus:
        sys.exit(f"chip_smoke: needs {n_gpus} GPUs, JAX sees {len(gpus)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    CARD = smi.splitlines()[0].strip()
    return gpus


# --- kernels --------------------------------------------------------------
def check_extract_windows(dev, height=480, width=752, n_features=1024, seed=0):
    from vslam_tpu.ops import extract, orb, patches

    P = orb.PATCH
    q = extract.level_quotas(n_features, 8, 1.2)[0]
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 255.0, (2, height, width)).astype(np.float32)
    x0 = rng.integers(0, width - P + 1, (2, q)).astype(np.int32)
    y0 = rng.integers(0, height - P + 1, (2, q)).astype(np.int32)
    out = np.asarray(
        patches.extract_windows(
            jax.device_put(img, dev), jax.device_put(x0, dev),
            jax.device_put(y0, dev), P, P,
        )
    )
    win = np.lib.stride_tricks.sliding_window_view(img, (P, P), axis=(1, 2))
    ref = win[np.arange(2)[:, None], y0, x0]
    check(out.shape == ref.shape, f"extract_windows shape {out.shape} != {ref.shape}")
    check(np.array_equal(out, ref), "extract_windows differs from NumPy indexing")
    return f"extract_windows (2,{height},{width}) q={q} P={P}: bit-exact"


def check_hamming(dev, n=1024, m=4096, seed=1):
    from vslam_tpu.ops import hamming

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, 2, (n, 256)) * 2 - 1).astype(np.int8)
    b = (rng.integers(0, 2, (m, 256)) * 2 - 1).astype(np.int8)
    d = np.asarray(
        jax.jit(hamming.hamming_matrix)(jax.device_put(a, dev), jax.device_put(b, dev))
    )
    a_p = hamming.pack_signed(jax.device_put(a, cpu))
    b_p = hamming.pack_signed(jax.device_put(b, cpu))
    ref = np.asarray(hamming.packed_hamming(a_p, b_p))
    check(d.shape == (n, m), f"hamming_matrix shape {d.shape}")
    check(np.array_equal(d.astype(np.int32), ref), "hamming_matrix != SWAR popcount")
    return f"hamming_matrix {n}x{m}: exact vs packed popcount (CPU)"


def check_brief(dev, n=1024, seed=2):
    from vslam_tpu.ops import orb

    rng = np.random.default_rng(seed)
    pt = jax.device_put(
        rng.uniform(0.0, 255.0, (2, n, orb.PATCH, orb.PATCH)).astype(np.float32), dev
    )
    ang = jax.device_put(rng.uniform(-np.pi, np.pi, (2, n)).astype(np.float32), dev)
    pk, sg = jax.jit(orb.brief_from_patches)(pt, ang)
    pk_ref, sg_ref = jax.jit(orb.brief_from_patches_gather)(pt, ang)
    check(np.array_equal(np.asarray(pk), np.asarray(pk_ref)), "BRIEF bits differ")
    check(np.array_equal(np.asarray(sg), np.asarray(sg_ref)), "BRIEF signs differ")
    return f"brief_from_patches (2,{n}) keys: bits identical to the gather oracle"


def phase_kernels(dev, height=480, width=752, n_features=1024, n_active=4096) -> None:
    log("kernels", check_extract_windows(dev, height, width, n_features))
    log("kernels", check_hamming(dev, n_features, n_active))
    log("kernels", check_brief(dev, n_features))


# --- frame program --------------------------------------------------------
def _frame_summary(outputs) -> tuple[np.ndarray, float]:
    """(solved pose (4,4), valid keypoints of the pair) from a step's blob
    ([pose 16 | vel 3 | bias 6 | n_m, n_i, n_st, n_valid, ...])."""
    blob = np.asarray(outputs["blob"])
    return blob[:16].reshape(4, 4), float(blob[28])


def phase_frame(dev, **entry_sizes) -> None:
    import __graft_entry__ as ge

    cpu = jax.devices("cpu")[0]
    fn, args = ge.entry(**entry_sizes)
    step = jax.jit(fn)
    args_dev = jax.device_put(args, dev)
    t0 = time.perf_counter()
    T_d, n_d = _frame_summary(step(*args_dev)[1])
    t_compile = time.perf_counter() - t0
    ms = _median_ms(lambda: step(*args_dev)[1]["blob"])
    T_c, n_c = _frame_summary(step(*jax.device_put(args, cpu))[1])
    check(np.isfinite(T_d).all(), "frame program: non-finite pose on the GPU")
    dk = abs(n_d - n_c) / max(n_c, 1.0)
    dt = float(np.linalg.norm(T_d[:3, 3] - T_c[:3, 3]))
    dr = _rot_deg(T_d[:3, :3], T_c[:3, :3])
    log(
        "frame",
        f"_track_step: valid keys GPU {n_d:.0f} CPU {n_c:.0f} (rel {dk:.4f}); "
        f"pose diff {dt * 1e3:.4f} mm {dr:.5f} deg; GPU blocked "
        f"{ms:.3f} ms/frame (median of 10), first call {t_compile:.1f} s",
    )
    check(n_c > 0 and dk <= FRAME_KEYS_REL, f"valid keypoints differ by {dk:.4f}")
    check(dt <= FRAME_POSE_M, f"frame pose differs by {dt} m")
    check(dr <= FRAME_POSE_DEG, f"frame pose differs by {dr} deg")


# --- local BA -------------------------------------------------------------
def _ba_diff(pa, ea, pb, eb) -> tuple[float, float, float]:
    Ta, Tb = np.asarray(pa.poses), np.asarray(pb.poses)
    dt = float(np.abs(Ta[:, :3, 3] - Tb[:, :3, 3]).max())
    dr = max(_rot_deg(Ta[i, :3, :3], Tb[i, :3, :3]) for i in range(len(Ta)))
    de = abs(float(ea) - float(eb)) / max(abs(float(eb)), 1e-12)
    return dt, dr, de


def phase_local_ba(dev) -> None:
    import __graft_entry__ as ge
    from vslam_tpu.ops import schur

    cpu = jax.devices("cpu")[0]
    p = ge.ba_problem(perturb=True)
    p_dev = jax.device_put(p, dev)
    pg, eg, _ = schur.local_ba_two_rounds(p_dev, iters1=5, iters2=10)
    ts, spread_m, spread_rel = [], 0.0, 0.0
    for _ in range(10):
        t0 = time.perf_counter()
        pr, er, _ = jax.block_until_ready(
            schur.local_ba_two_rounds(p_dev, iters1=5, iters2=10)
        )
        ts.append(time.perf_counter() - t0)
        rt, _, re_ = _ba_diff(pr, er, pg, eg)
        spread_m, spread_rel = max(spread_m, rt), max(spread_rel, re_)
    pc, ec, _ = schur.local_ba_two_rounds(jax.device_put(p, cpu), iters1=5, iters2=10)
    e0 = float(schur.ba_error(p))
    dt, dr, de = _ba_diff(pg, eg, pc, ec)
    log(
        "local_ba",
        f"W=20 L=4096 O={p.obs_kf.shape[0]}: chi2 {e0:.1f} -> GPU {float(eg):.4f} "
        f"CPU {float(ec):.4f} (rel {de:.2e}); pose diff {dt:.2e} m {dr:.2e} deg; "
        f"10 more GPU solves differ from the first by up to {spread_m:.2e} m, "
        f"chi2 rel {spread_rel:.2e}; GPU blocked "
        f"{1e3 * float(np.median(ts)):.3f} ms/solve (median of 10)",
    )
    check(np.isfinite(np.asarray(pg.poses)).all(), "local BA: non-finite poses")
    check(float(eg) < e0, "local BA did not reduce chi2")
    check(dt <= BA_POSE_M, f"local BA poses differ by {dt} m")
    check(de <= BA_CHI2_REL, f"local BA chi2 differs by {de}")


# --- system ---------------------------------------------------------------
def _run_synthetic():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import run_synthetic

    return run_synthetic


def _log_run(phase: str, name: str, r: dict) -> None:
    log(
        phase,
        f"{name} {r['size']}: {r['frames']} frames at {r['fps']:.2f} fps, per-frame p50 "
        f"{r['frame_ms_p50']:.2f} ms p90 {r['frame_ms_p90']:.2f} ms, "
        f"ATE {r['ate_m']:.4f} m, {r['keyframes']} keyframes, "
        f"{r['local_bas']} local BAs",
    )


def phase_system() -> None:
    """Each scene runs twice: the first run compiles every program (its
    frame times include compilation), the second is the one reported."""
    rs = _run_synthetic()
    for scene, frames, name, gate in (
        ("euroc", STEREO_FRAMES, "stereo", STEREO_ATE_M),
        ("mono", MONO_FRAMES, "mono-IMU", MONO_ATE_M),
    ):
        rendered = rs.render(scene, frames)
        cold = rs.run(scene, deterministic=True, rendered=rendered)
        _log_run("system", f"{name} (cold, compiling)", cold)
        r = rs.run(scene, deterministic=True, rendered=rendered)
        _log_run("system", f"{name} (warm)", r)
        check(max(cold["ate_m"], r["ate_m"]) < gate, f"{name} ATE over {gate} m")
        if scene == "euroc":
            check(r["local_bas"] >= MIN_LOCAL_BAS, f"only {r['local_bas']} local BAs")


# --- four GPUs ------------------------------------------------------------
def phase_sharded_ba(devs) -> None:
    import __graft_entry__ as ge
    from vslam_tpu.ops import schur
    from vslam_tpu.parallel import mesh as mesh_mod
    from vslam_tpu.parallel import sharded_ba

    n = len(devs)
    mesh = mesh_mod.make_mesh(n, axis=sharded_ba.AXIS)
    p = ge.ba_problem(n, perturb=True)
    p1, e1, _ = schur.local_ba_two_rounds(
        jax.device_put(p, devs[0]), iters1=5, iters2=10
    )
    for n_slabs in (1, 4):
        step = sharded_ba.sharded_two_rounds(mesh, iters1=5, iters2=10, n_slabs=n_slabs)
        pn, en, _ = sharded_ba.run_problem(step, p)
        spread = len(pn.poses.sharding.device_set)
        dt, dr, de = _ba_diff(pn, en, p1, e1)
        log(
            "four_gpus",
            f"sharded local BA n_slabs={n_slabs} over {spread} GPUs vs one: "
            f"chi2 {float(en):.4f} vs {float(e1):.4f} (rel {de:.2e}); pose diff "
            f"{dt:.2e} m {dr:.2e} deg",
        )
        check(spread == n, f"sharded BA result lives on {spread} devices")
        check(dt <= BA_POSE_M, f"sharded BA poses differ by {dt} m")
        check(de <= BA_CHI2_REL, f"sharded BA chi2 differs by {de}")


def phase_sharded_system(n: int) -> None:
    """VSlamSystem(shards=n) against shards=1 on the stereo scene: every
    local BA of the sharded run must have gone through the n-device
    program, both runs must pass the ATE gate, and their keyframes must
    agree within the sanity bound above."""
    rs = _run_synthetic()
    rendered = rs.render("euroc", STEREO_FRAMES)
    r1 = rs.run("euroc", deterministic=True, rendered=rendered)
    _log_run("four_gpus", "VSlamSystem shards=1", r1)
    rn = rs.run("euroc", deterministic=True, shards=n, rendered=rendered)
    _log_run("four_gpus", f"VSlamSystem shards={n}", rn)
    log("four_gpus", f"sharded local BAs {rn['sharded_bas']} of {rn['local_bas']}")
    check(
        rn["sharded_bas"] == rn["local_bas"] >= MIN_LOCAL_BAS,
        f"{rn['sharded_bas']} of {rn['local_bas']} local BAs ran sharded",
    )
    check(r1["sharded_bas"] == 0, "the shards=1 run used the sharded BA")
    kf1 = dict(zip(r1["kf_frames"].tolist(), r1["kf_poses"]))
    kfn = dict(zip(rn["kf_frames"].tolist(), rn["kf_poses"]))
    common = sorted(set(kf1) & set(kfn))
    d = max(np.linalg.norm(kf1[f][:3, 3] - kfn[f][:3, 3]) for f in common)
    log(
        "four_gpus",
        f"final keyframe poses: {len(common)} keyframes common to both runs "
        f"({len(kfn)} sharded, {len(kf1)} one GPU), max diff {d:.2e} m; ATE "
        f"{rn['ate_m']:.4f} vs {r1['ate_m']:.4f} m",
    )
    check(
        len(common) >= SHARD_KF_COMMON * max(len(kf1), len(kfn)),
        f"only {len(common)} keyframes common to both runs",
    )
    check(d <= SHARD_KF_POSE_M, f"sharded facade KF poses differ by {d} m")
    check(rn["ate_m"] < STEREO_ATE_M, f"sharded facade ATE {rn['ate_m']}")
    check(r1["ate_m"] < STEREO_ATE_M, f"one-GPU facade ATE {r1['ate_m']}")


def phase_sharded_frontend(devs, width=752, height=480, n_features=1024, n_levels=8,
                           active_size=4096) -> None:
    from jax.sharding import NamedSharding, PartitionSpec

    from vslam_tpu.models import map_state, tracker as tracker_mod
    from vslam_tpu.parallel import mesh as mesh_mod
    from vslam_tpu.parallel import multi_seq
    from vslam_tpu.utils import synthetic

    S = len(devs)
    mesh = mesh_mod.make_mesh(S, axis="seq")
    params = tracker_mod.TrackerParams(
        n_features=n_features, n_levels=n_levels, active_size=active_size
    )
    trackers, scenes = [], []
    for s in range(S):
        scene = synthetic.make_scene(
            n_frames=2, n_points=600, width=width, height=height, fps=20.0, seed=3 + s
        )
        # the facade's map sizes (examples/run_synthetic.run), so the
        # one-GPU frame program is the one the facade compiled
        world = map_state.WorldMap(
            lm_capacity=1 << 15, kf_capacity=128, keys_per_kf=n_features
        )
        t = tracker_mod.StereoTracker(
            scene.K.astype(np.float32), scene.baseline, width, height, world, params
        )
        t.track(
            scene.render(0).astype(np.uint8),
            scene.render(0, right=True).astype(np.uint8),
        )
        trackers.append(t)
        scenes.append(scene)
    front = multi_seq.BatchedStereoFrontend(trackers)
    LR = np.stack(
        [np.stack([sc.render(1), sc.render(1, right=True)]) for sc in scenes]
    ).astype(np.uint8)

    def seq_sharded(a):
        if getattr(a, "ndim", 0) == 0:
            return a
        spec = PartitionSpec("seq", *([None] * (a.ndim - 1)))
        return jax.device_put(a, NamedSharding(mesh, spec))

    state_b = jax.tree.map(seq_sharded, front._stack(*[t._state for t in trackers]))
    _, outputs = front._vstep(
        seq_sharded(jnp.asarray(LR)), state_b, seq_sharded(front._imu_b),
        jax.tree.map(seq_sharded, front._imu_const_b()), trackers[0]._radii,
        seq_sharded(front._K_b), seq_sharded(front._bl_b),
    )
    blob = outputs["blob"]
    spread = {sh.device for sh in blob.addressable_shards}
    check(len(spread) == S and all(sh.data.shape[0] == 1 for sh in blob.addressable_shards),
          f"sequence-sharded blob spans {len(spread)} devices")
    blob = np.asarray(blob)
    p = params
    for s, t in enumerate(trackers):
        _, out = tracker_mod._track_step(
            jax.device_put(LR[s], devs[0]), jax.device_put(t._state, devs[0]),
            t._imu_dummy, t._imu_const, t._radii, jnp.float32(p.refine_radius),
            jnp.float32(t._desc_thr), jnp.float32(t._ratio), t.K, t.baseline,
            t.scale_factors, t._static, width, height, p.n_levels, p.min_inliers,
            mono=False, has_imu=False,
        )
        T1, k1 = _frame_summary(out)
        Tn, kn = blob[s, :16].reshape(4, 4), float(blob[s, 28])
        dt = float(np.linalg.norm(Tn[:3, 3] - T1[:3, 3]))
        dr = _rot_deg(Tn[:3, :3], T1[:3, :3])
        dk = abs(kn - k1) / max(k1, 1.0)
        log(
            "four_gpus",
            f"sequence {s} on {blob.shape[0]}-way sharded frontend vs one GPU: "
            f"valid keys {kn:.0f} vs {k1:.0f}; pose diff {dt * 1e3:.4f} mm {dr:.5f} deg",
        )
        check(k1 > 0 and dk <= FRAME_KEYS_REL, f"sequence {s}: keypoints differ by {dk}")
        check(dt <= FRAME_POSE_M and dr <= FRAME_POSE_DEG, f"sequence {s}: pose differs")


def phase_device_memory(devs) -> None:
    peaks = [d.memory_stats().get("peak_bytes_in_use", 0) for d in devs]
    log("four_gpus", "peak bytes in use per GPU: " + ", ".join(f"{b:,}" for b in peaks))
    check(all(b > 0 for b in peaks), "a GPU of the mesh was never used")


# --- main -----------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four-gpus", action="store_true",
        help="run only the multi-device path over four GPUs",
    )
    args = ap.parse_args(argv)
    gpus = check_device(4 if args.four_gpus else 1)
    compile_cache.setup()
    t_start = time.perf_counter()
    if args.four_gpus:
        devs = gpus[:4]
        phase_sharded_ba(devs)
        phase_sharded_system(len(devs))
        phase_sharded_frontend(devs)
        phase_device_memory(devs)
    else:
        dev = gpus[0]
        phase_kernels(dev)
        phase_frame(dev)
        phase_local_ba(dev)
        phase_system()
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s | {CARD}")
    d = jax.devices()
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": d[0].platform,
                    "kind": d[0].device_kind,
                    "count": len(d),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
