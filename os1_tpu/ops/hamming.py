"""Hamming distance between 256-bit binary descriptors — the matching
primitive behind every matcher variant (reference ORBmatcher::DescriptorDistance,
ORBmatcher.cc:1605-1621, a scalar XOR+popcount loop).

Two formulations, both plain XLA:

* ``hamming_matrix``: XOR + ``lax.population_count`` on the packed uint32x8
  form, fused into one elementwise-and-reduce loop.
* ``hamming_matrix_mxu``: unpack to ±1 int8 and take a 256-deep integer dot:
  ``dist = (256 - <a, b>) / 2``. The "popcount loop" becomes a matrix
  product with int32 accumulation. This is the form the matchers use
  (matching/core.distance_matrix).

Descriptors are stored packed: uint32 [N, 8] (256 bits), bit i of word w =
pattern test index w*32+i.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

WORDS = 8
BITS = WORDS * 32


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """[..., 256] bool -> [..., 8] uint32 (little-endian bit order per word)."""
    b = bits.reshape(bits.shape[:-1] + (WORDS, 32)).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def unpack_bits(words: jnp.ndarray) -> jnp.ndarray:
    """[..., 8] uint32 -> [..., 256] bool."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[..., None] >> shifts) & jnp.uint32(1)
    return bits.reshape(words.shape[:-1] + (BITS,)).astype(bool)


def hamming_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Packed [N, 8] x [M, 8] -> int32 [N, M] Hamming distance (XOR+popcount)."""
    x = jnp.bitwise_xor(a[:, None, :], b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def hamming_matrix_mxu(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Packed [N, 8] x [M, 8] -> int32 [N, M] via a ±1 int8 matmul."""
    sa = jnp.where(unpack_bits(a), 1, -1).astype(jnp.int8)
    sb = jnp.where(unpack_bits(b), 1, -1).astype(jnp.int8)
    dot = jax.lax.dot_general(
        sa, sb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (BITS - dot) >> 1


def hamming_pairwise(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise distance of aligned descriptor arrays [..., 8] -> [...]."""
    x = jnp.bitwise_xor(a, b)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
