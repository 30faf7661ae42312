"""Device trace of the per-frame program at the bench's EuRoC shapes.

    python tools/trace_frame.py [--frames 20] [--out traces/trace_frame]

Compiles __graft_entry__.entry()'s `_track_step` (752x480 stereo, 1024
features, 8 levels, 4096 active slots) on the default device, then:

- traces `--frames` back-to-back steps with jax.profiler and reduces the
  device planes to the per-frame device busy time (union of the kernel
  intervals), the per-frame kernel count, and the device time of the
  kernels that belong to ops/patches.extract_windows (the `patch_windows`
  name scope) with their share of the frame;
- times the step's dispatch call against its blocked time, and checks
  whether is_ready() turns true without a blocking call and whether
  copy_to_host_async() lands a result before it is fetched; the same
  for a matmul chain written straight-line and as a lax.while_loop, to
  show which kind of program returns from dispatch before the device is
  done;
- times the frame program's one-hot-matmul formulations (BRIEF sampling,
  Hamming distances, stereo SAD windows) beside their plain forms.

Prints one summary line per result and writes summary.json, the top
kernels and the trace under --out.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
from vslam_tpu.utils import compile_cache  # noqa: E402

SCOPE = "patch_windows"


def _card() -> str:
    if jax.default_backend() != "gpu":
        return f"{jax.devices()[0].device_kind} (not a GPU)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def scoped_fusions(hlo_text: str, scope: str) -> set[str]:
    """Names of the top-level instructions of an optimized HLO module whose
    own metadata, or whose fused computation's instructions, carry `scope`
    in their op_name."""
    comps: dict[str, str] = {}
    cur = None
    for line in hlo_text.splitlines():
        m = re.match(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if m and "=" not in line.split("{")[0]:
            cur = m.group(1)
            comps[cur] = ""
        elif cur is not None:
            comps[cur] += line + "\n"
    names = set()
    for body in comps.values():
        for line in body.splitlines():
            m = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
            if not m:
                continue
            called = re.findall(r"calls=%?([\w.\-]+)", line)
            if scope in line or any(scope in comps.get(c, "") for c in called):
                names.add(m.group(1))
    return names


def _norm(name: str) -> str:
    return re.sub(r"[^a-z0-9]", "", name.lower())


def reduce_trace(path: str, n_frames: int, scoped: set[str]) -> dict:
    """Per-frame device time, kernel count and scoped-kernel time from an
    .xplane.pb written by jax.profiler."""
    prof = jax.profiler.ProfileData.from_file(path)
    scoped_norm = {_norm(s) for s in scoped}
    intervals, per_kernel = [], collections.Counter()
    scoped_ns, n_events = 0, 0
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # XLA's own summary lines repeat the kernels; keep the streams
            if "Stream" not in line.name and "stream" not in line.name:
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                hlo = str(stats.get("hlo_op", ""))
                intervals.append((ev.start_ns, ev.end_ns))
                per_kernel[ev.name] += ev.duration_ns
                n_events += 1
                if hlo in scoped or _norm(hlo) in scoped_norm or _norm(ev.name) in scoped_norm:
                    scoped_ns += ev.duration_ns
    busy, end = 0, -1
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return {
        "device_busy_ms_per_frame": busy / 1e6 / n_frames,
        "kernels_per_frame": n_events / n_frames,
        "patch_windows_ms_per_frame": scoped_ns / 1e6 / n_frames,
        "patch_windows_share": scoped_ns / busy if busy else None,
        "top_kernels_ms_per_frame": [
            (k, v / 1e6 / n_frames) for k, v in per_kernel.most_common(25)
        ],
    }


def _median_ms(fn, *args, n: int = 20) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return 1e3 * float(np.median(ts))


def shaped_ops(n_keys: int = 1024, n_active: int = 4096, height: int = 480,
               width: int = 752, seed: int = 0) -> dict:
    """Blocked times (median of 20) of the frame program's one-hot-matmul
    formulations beside the plain form of the same result, at the frame's
    shapes: BRIEF sampling (one-hot matmul vs gather), Hamming distances
    (bf16 +-1 matmul vs packed XOR+popcount) and the stereo SAD windows
    (row strips + one-hot columns vs gather)."""
    from vslam_tpu.ops import hamming, orb, patches, stereo_match

    rng = np.random.default_rng(seed)
    pt = jax.numpy.asarray(
        rng.uniform(0, 255, (2, n_keys, orb.PATCH, orb.PATCH)).astype(np.float32)
    )
    ang = jax.numpy.asarray(rng.uniform(-np.pi, np.pi, (2, n_keys)).astype(np.float32))
    a = jax.numpy.asarray((rng.integers(0, 2, (n_active, 256)) * 2 - 1).astype(np.int8))
    b = jax.numpy.asarray((rng.integers(0, 2, (n_keys, 256)) * 2 - 1).astype(np.int8))
    a_p, b_p = hamming.pack_signed(a), hamming.pack_signed(b)
    img = jax.numpy.asarray(rng.uniform(0, 255, (height, width)).astype(np.float32))
    r = stereo_match.SAD_RADIUS
    rs = r + stereo_match.SAD_SLIDE
    xc = jax.numpy.asarray(rng.integers(rs, width - rs, n_keys).astype(np.int32))
    yc = jax.numpy.asarray(rng.integers(r, height - r, n_keys).astype(np.int32))
    strips = jax.jit(lambda im, x, y: stereo_match._gather_patch_rows(im, x, y, r, rs))
    gather = jax.jit(
        lambda im, x, y: patches.extract_windows(
            im[None], (x - rs)[None], (y - r)[None], 2 * r + 1, 2 * rs + 1
        )[0]
    )
    return {
        "brief_onehot_matmul_ms": _median_ms(jax.jit(orb.brief_from_patches), pt, ang),
        "brief_gather_ms": _median_ms(jax.jit(orb.brief_from_patches_gather), pt, ang),
        "hamming_bf16_matmul_ms": _median_ms(jax.jit(hamming.hamming_matrix), a, b),
        "hamming_packed_popcount_ms": _median_ms(jax.jit(hamming.packed_hamming), a_p, b_p),
        "sad_windows_strips_onehot_ms": _median_ms(strips, img, xc, yc),
        "sad_windows_gather_ms": _median_ms(gather, img, xc, yc),
        "sad_windows_equal": bool(
            np.array_equal(np.asarray(strips(img, xc, yc)), np.asarray(gather(img, xc, yc)))
        ),
    }


def _dispatch(run) -> tuple[float, bool, float]:
    """Call `run` once without blocking: (ms the call itself took, whether
    its result was already ready when the call returned, ms from then on
    until is_ready() turned true, polled without any blocking call)."""
    t0 = time.perf_counter()
    out = run()
    t1 = time.perf_counter()
    at_return = bool(out.is_ready())
    while not out.is_ready() and time.perf_counter() - t1 < 10.0:
        time.sleep(1e-5)
    t2 = time.perf_counter()
    jax.block_until_ready(out)
    return 1e3 * (t1 - t0), at_return, 1e3 * (t2 - t1)


def readiness(run, n: int = 10, size: int = 4096) -> dict:
    """Whether a dispatch call returns before the device has finished, and
    whether is_ready() and copy_to_host_async() then behave: for the frame
    step, and for two programs of the same device work (a chain of large
    f32 matmuls) written once as straight-line code and once as a
    lax.while_loop whose trip count is data, the loop form of _track_step's
    retry and LM loops."""
    x = jax.numpy.ones((size, size), jax.numpy.float32) / size
    reps = jax.numpy.int32(16)

    @jax.jit
    def chain(a):
        for _ in range(16):
            a = a @ a
        return a[0, :8]

    @jax.jit
    def loop(a, k):
        return jax.lax.while_loop(
            lambda c: c[1] < k, lambda c: (c[0] @ c[0], c[1] + 1), (a, 0)
        )[0][0, :8]

    progs = {
        "track_step": run,
        "matmul_chain": lambda: chain(x),
        "matmul_while_loop": lambda: loop(x, reps),
    }
    res = {}
    for name, fn in progs.items():
        jax.block_until_ready(fn())
        jax.block_until_ready(fn())
        d = [_dispatch(fn) for _ in range(n)]
        res[f"{name}_dispatch_call_ms_median"] = float(np.median([a for a, _, _ in d]))
        res[f"{name}_ready_when_call_returned"] = f"{sum(r for _, r, _ in d)}/{n}"
        res[f"{name}_ms_until_is_ready_median"] = float(np.median([c for _, _, c in d]))
        res[f"{name}_blocked_ms_median"] = _median_ms(fn, n=n)
    fetch = {}
    for mode in ("copy_to_host_async", "plain"):
        out = run()
        if mode == "copy_to_host_async":
            out.copy_to_host_async()
        time.sleep(0.1)  # far longer than one step
        t0 = time.perf_counter()
        np.asarray(out)
        fetch[mode] = 1e3 * (time.perf_counter() - t0)
    res["track_step_fetch_ms_after_100ms_with_copy_to_host_async"] = fetch[
        "copy_to_host_async"
    ]
    res["track_step_fetch_ms_after_100ms_plain"] = fetch["plain"]
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default="traces/trace_frame")
    args = ap.parse_args()
    compile_cache.setup()
    os.makedirs(args.out, exist_ok=True)
    card = _card()

    fn, ex = ge.entry()
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*ex).compile()
    t_compile = time.perf_counter() - t0
    scoped = scoped_fusions(compiled.as_text(), SCOPE)

    def run():
        return compiled(*ex)[1]["blob"]

    for _ in range(3):
        jax.block_until_ready(run())
    ts = []
    for _ in range(args.frames):
        t = time.perf_counter()
        jax.block_until_ready(run())
        ts.append(time.perf_counter() - t)
    wall_ms = 1e3 * float(np.median(ts))

    tdir = os.path.join(args.out, "trace")
    with jax.profiler.trace(tdir):
        outs = [run() for _ in range(args.frames)]
        jax.block_until_ready(outs)
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"), recursive=True))[-1]
    summary = {
        "card": card,
        "device_kind": jax.devices()[0].device_kind,
        "compile_s": t_compile,
        "blocked_wall_ms_per_frame_median": wall_ms,
        "scoped_hlo": sorted(scoped),
        **reduce_trace(path, args.frames, scoped),
        **readiness(run),
        **shaped_ops(),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for k, v in summary.items():
        if k not in ("top_kernels_ms_per_frame", "scoped_hlo"):
            print(f"[trace_frame] {k}: {v} | {card}")
    for k, v in summary["top_kernels_ms_per_frame"][:12]:
        print(f"[trace_frame] kernel {k}: {v:.4f} ms/frame | {card}")


if __name__ == "__main__":
    main()
