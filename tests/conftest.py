"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding paths (vslam_tpu.parallel) are validated here without
several accelerators, per SURVEY.md §4's distributed-test strategy.
Settings go through jax.config.update, which works even when jax was
imported before this file.
"""

import jax

from vslam_tpu.utils import compile_cache

jax.config.update("jax_platforms", "cpu")  # the tests run on the CPU
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compilation cache: keeps repeated test runs fast.
compile_cache.setup()
