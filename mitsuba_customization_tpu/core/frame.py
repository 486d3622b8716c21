"""Shading frames: world <-> local transforms around a normal.

Counterpart of mitsuba3 include/mitsuba/core/frame.h (Frame3f).
A frame is stored as a (s, t, n) triple of (..., 3) arrays; batched.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mitsuba_customization_tpu.core.math import coordinate_system, dot


class Frame(NamedTuple):
    """Orthonormal shading frame (s, t, n), all (..., 3)."""

    s: jnp.ndarray
    t: jnp.ndarray
    n: jnp.ndarray

    @staticmethod
    def from_normal(n):
        s, t = coordinate_system(n)
        return Frame(s=s, t=t, n=n)

    def to_local(self, v):
        """World direction -> frame-local coordinates."""
        return jnp.stack([dot(v, self.s), dot(v, self.t), dot(v, self.n)], axis=-1)

    def to_world(self, v):
        """Frame-local direction -> world coordinates."""
        return (
            v[..., 0:1] * self.s + v[..., 1:2] * self.t + v[..., 2:3] * self.n
        )
