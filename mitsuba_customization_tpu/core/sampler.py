"""Per-lane stateless samplers (counter-based RNG + low-discrepancy).

Counterpart of mitsuba3 src/render/sampler.cpp +
src/samplers/{independent,stratified,multijitter,ldsampler}.cpp
(SURVEY.md §2.3 "Sampler framework", §2.4 "Samplers").

Design (replay-exact): the reference seeds one PCG32 per lane and
draws a *sequence*; here every random number is a pure hash of
(seed, lane_id, dimension_index) — no mutable RNG state crosses the bounce
loop, so path-replay backprop (SURVEY.md §3.2) reproduces the primal
sampling decisions bit-exactly by construction (SURVEY.md §7.3 item 3).

The dimension index splits into a *traced* base (set per bounce inside
lax.scan via `with_dim(base)` — e.g. base = CAMERA_DIMS + bounce * STRIDE)
plus a *static* Python offset advanced by next_1d/next_2d call sites. The
static part keeps call-site structure identical between primal and replay
traces; the traced part lets one scan body serve every bounce. Bases must
be even so the Sobol pair-parity stays static.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mitsuba_customization_tpu.core.qmc import (
    hash_combine,
    hash_u32,
    sobol_owen_2d,
)

_U32 = jnp.uint32


def _uniform_from_bits(bits):
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


class Sampler:
    """Base: deterministic per-(lane, dim) sample streams.

    lane: uint32 array of lane ids (pixel*spp flattened); seed: uint32
    scalar (render seed); base_dim: traced uint32 dimension base (even);
    dim: static Python offset within the base.
    """

    def __init__(self, seed, lane, dim=0, base_dim=0):
        self.seed = jnp.asarray(seed, dtype=_U32)
        self.lane = jnp.asarray(lane, dtype=_U32)
        self.base_dim = jnp.asarray(base_dim, dtype=_U32)
        self.dim = dim

    def clone(self):
        return type(self)(self.seed, self.lane, self.dim, self.base_dim)

    def with_dim(self, base_dim):
        """Sampler repositioned at a (possibly traced) dimension base."""
        return type(self)(self.seed, self.lane, 0, base_dim)

    def _dim_value(self, offset):
        return self.base_dim + _U32(offset)

    def next_1d(self):
        u = self._draw(self.dim)
        self.dim += 1
        return u

    def next_2d(self):
        u = jnp.stack([self._draw(self.dim), self._draw(self.dim + 1)], axis=-1)
        self.dim += 2
        return u

    def _draw(self, dim):  # pragma: no cover - abstract
        raise NotImplementedError


class IndependentSampler(Sampler):
    """Counter-based uniform sampler — the reference's `independent` plugin.

    PCG32-per-lane in the reference becomes a stateless avalanche hash of
    (seed, lane, dim): identical statistical contract (independent uniforms),
    zero carried state.
    """

    def _draw(self, dim):
        bits = hash_combine(
            hash_combine(self.seed, self.lane), self._dim_value(dim)
        )
        return _uniform_from_bits(bits)


class SobolSampler(Sampler):
    """Owen-scrambled Sobol (0,2)-sequence sampler — replaces `ldsampler`.

    The lane id is split as lane = pixel * spp + sample_index by
    `from_pixel`; consecutive 2-D dimension pairs use independently
    scrambled copies of the (0,2)-sequence (the standard "padded Sobol"
    construction). Requires even dimension bases (see module docstring).
    """

    def __init__(self, seed, lane, dim=0, base_dim=0, pixel=None,
                 sample_index=None):
        super().__init__(seed, lane, dim, base_dim)
        self.pixel = lane if pixel is None else jnp.asarray(pixel, dtype=_U32)
        self.sample_index = (
            jnp.zeros_like(self.lane)
            if sample_index is None
            else jnp.asarray(sample_index, dtype=_U32)
        )

    @staticmethod
    def from_pixel(seed, pixel, sample_index, spp):
        lane = pixel.astype(_U32) * _U32(spp) + sample_index.astype(_U32)
        return SobolSampler(seed, lane, 0, 0, pixel=pixel,
                            sample_index=sample_index)

    def clone(self):
        return SobolSampler(
            self.seed, self.lane, self.dim, self.base_dim, self.pixel,
            self.sample_index,
        )

    def with_dim(self, base_dim):
        return SobolSampler(
            self.seed, self.lane, 0, base_dim, self.pixel, self.sample_index
        )

    def _pair(self, pair_offset):
        pair_dim = (self.base_dim >> 1) + _U32(pair_offset)
        scramble = hash_combine(
            hash_combine(self.seed, self.pixel), pair_dim
        )
        return sobol_owen_2d(self.sample_index, scramble)

    def _draw(self, dim):
        pair = self._pair(dim // 2)
        return pair[..., dim % 2]

    def next_2d(self):
        if self.dim % 2 == 0:
            pair = self._pair(self.dim // 2)
            self.dim += 2
            return pair
        return super().next_2d()


class StratifiedSampler(Sampler):
    """Jittered-stratified sampler — the reference's `stratified` plugin.

    Stratifies each dimension over the spp index with a per-(pixel, dim)
    cyclic permutation (a true bijection: every stratum hit exactly once),
    jittered by the hash stream.
    """

    def __init__(self, seed, lane, dim=0, base_dim=0, sample_index=None,
                 spp=1):
        super().__init__(seed, lane, dim, base_dim)
        self.spp = int(spp)
        self.sample_index = (
            jnp.zeros_like(self.lane)
            if sample_index is None
            else jnp.asarray(sample_index, dtype=_U32)
        )

    @classmethod
    def from_pixel(cls, seed, pixel, sample_index, spp):
        lane = pixel.astype(_U32) * _U32(spp) + sample_index.astype(_U32)
        return cls(seed, lane, 0, 0, sample_index=sample_index, spp=spp)

    def clone(self):
        return type(self)(
            self.seed, self.lane, self.dim, self.base_dim,
            self.sample_index, self.spp,
        )

    def with_dim(self, base_dim):
        return type(self)(
            self.seed, self.lane, 0, base_dim, self.sample_index, self.spp
        )

    def _draw(self, dim):
        d = self._dim_value(dim)
        jitter_bits = hash_combine(hash_combine(self.seed, self.lane), d)
        jitter = _uniform_from_bits(jitter_bits)
        pixel = self.lane // _U32(self.spp)
        offset = hash_combine(
            hash_combine(self.seed ^ _U32(0xA511E9B3), pixel), d
        )
        stratum = ((self.sample_index + offset) % _U32(self.spp)).astype(
            jnp.float32
        )
        return (stratum + jitter) / jnp.float32(self.spp)


def _kensler_permute(i, l, p, rounds=24):
    """Cycle-walking hash permutation of [0, l) — the randomized
    bijection both CMJ and OA samplers build on (the pattern of Kensler
    2013). Every round is bijective on the 2^k masked field BY
    CONSTRUCTION: odd-constant multiplications (invertible mod 2^k),
    downward masked-xor mixing (triangular), and the trailing pow2 mask;
    out-of-range values walk the cycle until they land in [0, l). 24
    lock-step rounds leave < 1e-10 unwalked lanes (deterministic
    fallback keeps those in range).
    """
    l = _U32(l)
    w = jnp.maximum(l - _U32(1), _U32(1))
    w = w | (w >> 1)
    w = w | (w >> 2)
    w = w | (w >> 4)
    w = w | (w >> 8)
    w = w | (w >> 16)
    p = jnp.asarray(p, _U32)
    i = jnp.asarray(i, _U32)

    def one_round(i):
        i = i ^ p
        i = i * _U32(0xE170893D)
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = i * _U32(0x0929EB3F)
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = i * (_U32(1) | (p >> 27))
        i = i * _U32(0x6935FA69)
        # every multiplier is ODD (invertible mod 2^32), every mix is a
        # downward masked xor (triangular): each step is bijective on
        # the low-bit field, so the round is a true permutation of
        # [0, w+1) and cycle walking terminates in [0, l)
        i = i ^ ((i & w) >> 3)
        i = i ^ ((i & w) >> 2)
        i = i * _U32(0x9E501CC3)
        i = i ^ ((i & w) >> 2)
        i = i * _U32(0xC860A3DF)
        i = i & w
        i = i ^ (i >> 5)
        return i

    out = one_round(i)
    for _ in range(rounds - 1):
        out = jnp.where(out >= l, one_round(out), out)
    # Fixed-round cycle walk: after `rounds` rounds a lane still >= l falls
    # back to i % l, which is NOT injective — the bijection is probabilistic
    # (miss probability < (1 - l/(w+1))^rounds ~ 2^-24 per lane vs the
    # reference's unbounded do-while). A duplicated/missed stratum at that
    # rate is far below MC noise; accepted for static-shape jit control flow.
    out = jnp.where(out >= l, i % l, out)
    return (out + p) % l


class MultijitterSampler(StratifiedSampler):
    """Correlated multi-jittered sampler (Kensler 2013) — the reference's
    `multijitter` plugin. 2-D pairs get the CMJ pattern over an m x n
    grid (m*n = spp, m the largest divisor <= sqrt(spp)): stratified in
    the full m x n grid AND in both 1-D projections, with the correlated
    shuffle that kills the diagonal artifacts of plain multi-jitter.
    Odd single draws fall back to the stratified stream.
    """

    def _grid(self):
        m = max(1, int(np.sqrt(self.spp)))
        while self.spp % m:
            m -= 1
        return m, self.spp // m

    def _pair_key(self, pair_offset):
        pixel = self.lane // _U32(self.spp)
        pair_dim = (self.base_dim >> 1) + _U32(pair_offset)
        return hash_combine(
            hash_combine(self.seed ^ _U32(0xC3A5C85C), pixel), pair_dim
        )

    def _cmj(self, pair_offset):
        m, n = self._grid()
        s_all = self.sample_index
        key = self._pair_key(pair_offset)
        # shuffle the sample order per (pixel, pair) so pairs decorrelate
        s = _kensler_permute(s_all, self.spp, key ^ _U32(0x51633E2D))
        sx = _kensler_permute(s % _U32(m), m, key ^ _U32(0x68BC21EB))
        sy = _kensler_permute(s // _U32(m), n, key ^ _U32(0x02E5BE93))
        jx = _uniform_from_bits(hash_combine(key ^ _U32(0x967A889B), s))
        jy = _uniform_from_bits(hash_combine(key ^ _U32(0x368CC8B7), s))
        x = (
            (s % _U32(m)).astype(jnp.float32)
            + (sy.astype(jnp.float32) + jx) / n
        ) / m
        y = (
            (s // _U32(m)).astype(jnp.float32)
            + (sx.astype(jnp.float32) + jy) / m
        ) / n
        return jnp.stack([x, y], axis=-1)

    def next_2d(self):
        if self.dim % 2 == 0 and self.spp > 1:
            pair = self._cmj(self.dim // 2)
            self.dim += 2
            return pair
        return Sampler.next_2d(self)


class OrthogonalSampler(StratifiedSampler):
    """Orthogonal-array sampler (Bose OA of strength 2, Jarosz et al.
    2019) — the reference's `orthogonal` plugin. Requires spp = p^2 with
    p prime: sample s = (a, b) lands in stratum (a + j*b mod p) of
    dimension j, so every pair of dimensions with distinct indices mod p
    is stratified on the p x p grid (the Bose OA strength-2 guarantee;
    dimensions congruent mod p share a column — the per-dimension stratum
    permutation relabels but cannot separate them, exactly as in the
    reference construction). Non-square spp falls back to the stratified
    stream.
    """

    def _p(self):
        p = int(round(np.sqrt(self.spp)))
        if p * p != self.spp:
            return 0
        for q in range(2, p):
            if p % q == 0:
                return 0
        return p

    def _draw(self, dim):
        p = self._p()
        if p == 0:
            return StratifiedSampler._draw(self, dim)
        d = self._dim_value(dim)
        pixel = self.lane // _U32(self.spp)
        key = hash_combine(
            hash_combine(self.seed ^ _U32(0x8C98C8EF), pixel), d
        )
        # the sample-order shuffle must be per-PIXEL (shared by every
        # dimension): all dims must read the same (a, b) pair or the
        # strength-2 pairwise stratification collapses
        pix_key = hash_combine(self.seed ^ _U32(0x19AD25CB), pixel)
        s = _kensler_permute(self.sample_index, self.spp, pix_key)
        a = s // _U32(p)
        b = s % _U32(p)
        stratum = (a + d.astype(_U32) * b) % _U32(p)
        stratum = _kensler_permute(stratum, p, key ^ _U32(0x66D13D09))
        sub = _kensler_permute(b, p, key ^ hash_combine(key, stratum))
        jitter = _uniform_from_bits(hash_combine(key ^ _U32(0x4E7A4A33), s))
        return (
            stratum.astype(jnp.float32)
            + (sub.astype(jnp.float32) + jitter) / p
        ) / p


SAMPLERS = {
    "independent": IndependentSampler,
    "stratified": StratifiedSampler,
    "sobol": SobolSampler,
    "ldsampler": SobolSampler,  # reference name for its low-discrepancy sampler
    "multijitter": MultijitterSampler,
    "orthogonal": OrthogonalSampler,
}


def make_sampler(name, seed, pixel, sample_index, spp):
    """Instantiate a sampler by reference plugin name (SURVEY.md §2.4)."""
    cls = SAMPLERS[name]
    if cls is IndependentSampler:
        lane = pixel.astype(_U32) * _U32(spp) + sample_index.astype(_U32)
        return IndependentSampler(seed, lane)
    return cls.from_pixel(seed, pixel, sample_index, spp)
