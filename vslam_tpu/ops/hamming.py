"""Hamming distance matrices as matmuls.

The reference compares 256-bit BRIEF descriptors with a scalar popcount
loop (reference FeatureMatcher::DescriptorDistance,
src/FeatureMatcher.cpp:710-726, thresholded at 75/100/50 in
include/FeatureMatcher.h:25-30). Here every matching stage is batched into
one distance matrix: with descriptors expanded to +-1 vectors,

    dot(a, b) = 256 - 2 * hamming(a, b)   =>   hamming = (256 - dot) / 2

so an (N, 256) x (256, M) matmul computes all N*M distances at once. The
+-1 expansion is exact in bfloat16 and the sums (integers up to 256) are
exact in the f32 accumulator, so the bf16 product loses no precision.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

N_BITS = 256
INVALID = 1e9  # distance assigned to masked-out pairs


def hamming_matrix(
    a_signed: jax.Array,
    b_signed: jax.Array,
    a_valid: jax.Array | None = None,
    b_valid: jax.Array | None = None,
) -> jax.Array:
    """(N, 256) x (M, 256) +-1 descriptors -> (N, M) float32 Hamming
    distances; invalid rows/cols get INVALID."""
    dot = jax.lax.dot_general(
        a_signed.astype(jnp.bfloat16),
        b_signed.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,  # bf16 inputs are exact here
    )
    d = (N_BITS - dot) * 0.5
    if a_valid is not None:
        d = jnp.where(a_valid[:, None], d, INVALID)
    if b_valid is not None:
        d = jnp.where(b_valid[None, :], d, INVALID)
    return d


def unpack_signed(packed: jax.Array) -> jax.Array:
    """(…, 8) uint32 bit-packed descriptors -> (…, 256) int8 +-1 matmul form.
    Bit order matches ops/orb._pack_bits: bit b of word w is descriptor
    bit w*32+b. The map stores descriptors packed (32x smaller HBM:
    obs_desc at driver defaults 512 MiB -> 64 MiB);
    matchers unpack per block right before the Hamming matmul — a cheap
    vectorized shift/mask that XLA fuses into the operand load."""
    bits = (packed[..., :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
    bits = bits.reshape(*packed.shape[:-1], N_BITS)
    return (bits.astype(jnp.int8) * 2 - 1).astype(jnp.int8)


def pack_signed(signed: jax.Array) -> jax.Array:
    """(…, 256) +-1 (or 0/1) descriptors -> (…, 8) uint32 bit-packed form
    (inverse of :func:`unpack_signed`; same convention as ops/orb)."""
    bits = (signed > 0).astype(jnp.uint32)
    words = bits.reshape(*bits.shape[:-1], 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts, axis=-1, dtype=jnp.uint32)


def unpack_signed_np(packed: "object") -> "object":
    """Host-side numpy twin of :func:`unpack_signed`."""
    import numpy as np

    p = np.asarray(packed, np.uint32)
    bits = (p[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(*p.shape[:-1], N_BITS)
    return (bits.astype(np.int8) * 2 - 1).astype(np.int8)


def packed_hamming(a_packed: jax.Array, b_packed: jax.Array) -> jax.Array:
    """Reference-semantics popcount distance for (N, 8) x (M, 8) uint32
    packed descriptors -> (N, M) int32. Used as the oracle/cross-check for
    :func:`hamming_matrix` and for host-side debugging."""
    x = a_packed[:, None, :] ^ b_packed[None, :, :]
    # SWAR popcount per uint32 word
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    x = (x * jnp.uint32(0x01010101)) >> 24
    return jnp.sum(x.astype(jnp.int32), axis=-1)
