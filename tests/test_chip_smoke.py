"""chip_smoke.py: refuses to run without a GPU, and its bench-width kernel
comparison holds on the CPU too."""

import json
import os
import subprocess
import sys

import jax

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    for line in r.stdout.splitlines():
        try:
            assert "ok" not in json.loads(line)
        except ValueError:
            pass


def test_extract_windows_bench_width_on_cpu():
    """The smoke's kernels-phase case at bench width: a (2, 480, 752)
    level-0 pair, level_quotas(1024, 8, 1.2)[0] corners, P=31, bit for bit
    against NumPy indexing."""
    sys.path.insert(0, REPO)
    import chip_smoke

    msg = chip_smoke.check_extract_windows(jax.devices("cpu")[0])
    assert "bit-exact" in msg and "(2,480,752)" in msg


def _smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.CARD = "CPU"
    return chip_smoke


def test_kernel_and_frame_phases_on_cpu():
    """The smoke's kernel comparisons and its GPU-vs-CPU frame-program
    check, run CPU-vs-CPU at a small size (the chip runs them at bench
    width)."""
    cs = _smoke()
    cpu = jax.devices("cpu")
    cs.phase_kernels(cpu[1], height=96, width=160, n_features=256, n_active=512)
    cs.phase_frame(
        cpu[1], width=160, height=120, n_features=128, n_levels=3, active_size=256
    )


def test_four_gpu_phases_on_virtual_cpu_mesh():
    """--four-gpus' sharded BA (plain and slab-chunked) and the
    sequence-sharded frontend, on four virtual CPU devices at a small
    frame size."""
    cs = _smoke()
    devs = jax.devices("cpu")[:4]
    cs.phase_sharded_ba(devs)
    cs.phase_sharded_frontend(
        devs, width=160, height=120, n_features=128, n_levels=3, active_size=256
    )
