"""utils/compile_cache: an outside JAX_COMPILATION_CACHE_DIR wins; without
it the cache lives at <checkout>/.jax_cache."""

import os
import subprocess
import sys

import pytest

from vslam_tpu.utils import compile_cache

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CODE = (
    "import jax\n"
    "from vslam_tpu.utils import compile_cache\n"
    "d = compile_cache.setup()\n"
    "assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0\n"
    "assert jax.config.jax_persistent_cache_min_entry_size_bytes == 0\n"
    "print(d)\n"
)


@pytest.mark.parametrize("outside", [True, False], ids=["env_set", "env_unset"])
def test_cache_dir(tmp_path, outside):
    env = {k: v for k, v in os.environ.items() if k != compile_cache.ENV_VAR}
    env["JAX_PLATFORMS"] = "cpu"
    if outside:
        env[compile_cache.ENV_VAR] = str(tmp_path)
    r = subprocess.run(
        [sys.executable, "-c", CODE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    want = str(tmp_path) if outside else os.path.join(REPO, ".jax_cache")
    assert r.stdout.strip() == want
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
