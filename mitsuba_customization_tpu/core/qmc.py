"""Low-discrepancy sequences: Owen-scrambled Sobol (0,2)-sequence, in pure jnp.

Replacement for mitsuba3 src/samplers/ldsampler.cpp and the
radical-inverse machinery in include/mitsuba/core/qmc.h (SURVEY.md §2.4
"Samplers"; BASELINE.json north_star: "Mitsuba warp -> JAX-native
low-discrepancy"). Uses hash-based Owen scrambling (Laine-Karras style
permutation on reversed bits), which decorrelates pixels without any
per-pixel tables — everything is uint32 bit arithmetic on the VPU.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def reverse_bits32(x):
    """Bit-reverse a uint32 (vectorized)."""
    x = x.astype(_U32)
    x = ((x >> 16) | (x << 16)).astype(_U32)
    x = (((x & _U32(0x00FF00FF)) << 8) | ((x & _U32(0xFF00FF00)) >> 8)).astype(_U32)
    x = (((x & _U32(0x0F0F0F0F)) << 4) | ((x & _U32(0xF0F0F0F0)) >> 4)).astype(_U32)
    x = (((x & _U32(0x33333333)) << 2) | ((x & _U32(0xCCCCCCCC)) >> 2)).astype(_U32)
    x = (((x & _U32(0x55555555)) << 1) | ((x & _U32(0xAAAAAAAA)) >> 1)).astype(_U32)
    return x


def hash_u32(x):
    """lowbias32 integer hash (Wang-style avalanche), uint32 -> uint32."""
    x = x.astype(_U32)
    x = (x ^ (x >> 16)).astype(_U32)
    x = (x * _U32(0x7FEB352D)).astype(_U32)
    x = (x ^ (x >> 15)).astype(_U32)
    x = (x * _U32(0x846CA68B)).astype(_U32)
    x = (x ^ (x >> 16)).astype(_U32)
    return x


def hash_combine(a, b):
    """Mix two uint32 streams into one (order-sensitive)."""
    a = a.astype(_U32)
    b = b.astype(_U32)
    return hash_u32((a ^ (b + _U32(0x9E3779B9) + ((a << 6).astype(_U32)) + (a >> 2))).astype(_U32))

def _laine_karras_permutation(x, seed):
    """Owen-scramble the (reversed-bit) value x with the given seed.

    Burley, "Practical Hash-based Owen Scrambling" (JCGT 2020) nested
    uniform permutation acting on the binary tree of intervals.
    """
    x = x.astype(_U32)
    x = (x + seed.astype(_U32)).astype(_U32)
    x = (x ^ (x * _U32(0x6C50B47C))).astype(_U32)
    x = (x ^ (x * _U32(0xB82F1E52))).astype(_U32)
    x = (x ^ (x * _U32(0xC7AFE638))).astype(_U32)
    x = (x ^ (x * _U32(0x8D22F6E6))).astype(_U32)
    return x


def owen_scramble(x, seed):
    """Owen-scramble x (a radical-inverse-style uint32) with seed."""
    return reverse_bits32(_laine_karras_permutation(reverse_bits32(x), seed))


def sobol_u32(index, dim):
    """Unscrambled Sobol' sample `index` of dimension 0 or 1 as uint32.

    dim 0 = van der Corput (bit reversal); dim 1 = second Sobol dimension
    via the standard v_{k+1} = v_k ^ (v_k >> 1) direction-number recurrence.
    Together they form a (0,2)-sequence.
    """
    index = index.astype(_U32)
    if dim == 0:
        return reverse_bits32(index)
    out = jnp.zeros_like(index)
    v = _U32(1 << 31)
    for _ in range(32):
        out = jnp.where((index & _U32(1)) != 0, out ^ v, out).astype(_U32)
        index = index >> 1
        v = (v ^ (v >> 1)).astype(_U32)
    return out


def _u32_to_unit_float(x):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (x >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def sobol_owen_2d(index, seed):
    """Owen-scrambled (0,2)-sequence point `index` -> (..., 2) in [0,1)^2.

    `seed` decorrelates independent pixels/lanes; sample indices within one
    lane must share the seed for stratification to hold.
    """
    seed = seed.astype(_U32)
    s0 = hash_u32(seed)
    s1 = hash_u32(seed ^ _U32(0xDEADBEEF))
    # Owen-scramble the *index* as well (shuffles sample order per lane,
    # decorrelating lanes while preserving the net point set).
    idx = owen_scramble(index.astype(_U32), hash_u32(seed ^ _U32(0x55AA55AA)))
    x = owen_scramble(sobol_u32(idx, 0), s0)
    y = owen_scramble(sobol_u32(idx, 1), s1)
    return jnp.stack([_u32_to_unit_float(x), _u32_to_unit_float(y)], axis=-1)
