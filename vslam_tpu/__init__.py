"""vslam_tpu — a visual(-inertial) SLAM framework in JAX.

A from-scratch re-design (NOT a port) of the capabilities of the reference
C++ system christoskokas/gtsam-vSLAM (see /root/reference and SURVEY.md):

- stereo / stereo-inertial / monocular-inertial SLAM on KITTI + EuRoC,
- ORB-style pyramid feature extraction (FAST + ANMS + oriented BRIEF),
- grid-constrained stereo + temporal projection matching,
- IMU preintegration (CombinedImuFactor semantics),
- motion-only pose optimization (batched Levenberg-Marquardt),
- keyframe-based multi-view triangulation,
- sliding-window local bundle adjustment with an explicit Schur complement,
- distributed BA over a jax.sharding Mesh (psum/reduce_scatter across
  devices).

Design principles:
- fixed-shape structure-of-arrays + validity masks everywhere (no
  recompilation per frame),
- batched dense linear algebra (Hamming matching as matmuls,
  Schur reduced-camera solves as blocked Cholesky),
- functional state: the world map is a pytree of preallocated device
  arrays, updated with pure functions; the tracker<->mapper handoff is a
  versioned snapshot rather than mutex+flag races,
- host control flow only at frame boundaries (KF policy, retry radius).
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry/solver code does many tiny (3x3..15x15) matrix products whose
# accuracy matters for LM convergence; force full-f32 matmuls globally. The
# big descriptor/Hamming matmuls explicitly opt back into fast low precision
# (see vslam_tpu/ops/hamming.py) where it is safe.
_jax.config.update("jax_default_matmul_precision", "highest")

from vslam_tpu.utils.config import ConfigFile, SlamMode  # noqa: F401
