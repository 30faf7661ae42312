"""Multi-process distributed runtime: jax.distributed across 2 OS
processes (the multi-HOST story, SURVEY.md §5 distributed-comm row).

The virtual 8-device mesh used everywhere else is single-process; this
test actually exercises `parallel.mesh.initialize_distributed` — two
separate processes, a Gloo-backed CPU collective backend, a 2-device
global mesh with one local device per process — and runs the SAME
sharded 2-round BA kernel the single-host mesh runs. Each process builds
the identical (replicated) problem, the psum rides the inter-process
backend, and the result must match the single-device solve. This is the
exact code path a 2-host deployment uses (with the accelerators'
collective backend instead of Gloo).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, os.path.join({repo!r}, "tests"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1])
    out_path = sys.argv[2]

    from vslam_tpu.parallel import mesh as mesh_mod, sharded_ba
    mesh_mod.initialize_distributed(
        coordinator="127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert jax.device_count() == 2 and jax.local_device_count() == 1

    import numpy as np
    from test_ba import _build_problem
    p, poses_gt, pts_gt = _build_problem(W=6, L=96, seed=2)
    mesh = mesh_mod.make_mesh(axis=sharded_ba.AXIS)
    step = sharded_ba.sharded_two_rounds(mesh, iters1=3, iters2=3)
    p2, err, kill = sharded_ba.run_problem(step, p)
    np.save(out_path, np.asarray(p2.poses))
    print("worker", pid, "err", float(err), flush=True)
    """
)


@pytest.mark.slow
def test_two_process_distributed_ba_matches_single_device(tmp_path):
    port = 19741
    code = _WORKER.format(repo=REPO, port=port)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    outs = [str(tmp_path / f"poses_{i}.npy") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(i), outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=str(tmp_path),
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        logs.append(out)
        assert p.returncode == 0, out[-4000:]

    # reference: the same problem solved single-device in this process
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_ba import _build_problem

    from vslam_tpu.ops import schur

    p, poses_gt, _ = _build_problem(W=6, L=96, seed=2)
    p_ref, err_ref, kill_ref = schur.local_ba_two_rounds(p, iters1=3, iters2=3)
    ref = np.asarray(p_ref.poses)

    a = np.load(outs[0])
    b = np.load(outs[1])
    # both processes hold the full replicated result
    np.testing.assert_allclose(a, b, atol=1e-6)
    # and it matches the single-device solve up to float reduction order
    np.testing.assert_allclose(a, ref, atol=5e-4)
    # the solve actually converged toward ground truth
    err_t = np.linalg.norm(a[:, :3, 3] - poses_gt[:, :3, 3], axis=1)
    assert err_t.max() < 5e-3, err_t
