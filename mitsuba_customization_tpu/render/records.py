"""Interaction and sampling records.

Counterpart of mitsuba3 include/mitsuba/render/interaction.h and
records.h (SURVEY.md §2.3): SurfaceInteraction3f, DirectionSample3f. SoA
NamedTuples over lane batches — the wavefront ray state of SURVEY.md §2.7 P5.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mitsuba_customization_tpu.core.frame import Frame


class Ray(NamedTuple):
    """Ray bundle: origin (..., 3), unit direction (..., 3), maxt (...)."""

    o: jnp.ndarray
    d: jnp.ndarray
    maxt: jnp.ndarray

    @staticmethod
    def make(o, d, maxt=None):
        if maxt is None:
            maxt = jnp.full(o.shape[:-1], jnp.inf, dtype=o.dtype)
        return Ray(o=o, d=d, maxt=maxt)


class SurfaceInteraction(NamedTuple):
    """Per-lane hit record (SurfaceInteraction3f analogue).

    valid:    (...) bool — hit anything
    t:        (...) ray parameter
    p:        (..., 3) world position
    n:        (..., 3) geometric normal
    frame:    shading Frame (s, t, n), world-space
    uv:       (..., 2) surface parameterization
    wi:       (..., 3) incident direction in the *local* shading frame
              (points away from the surface, Mitsuba convention)
    prim:     (...) int32 primitive index
    mat_id:   (...) int32 material index (into BSDFTable)
    emitter:  (...) int32 emitter index (-1 if not emissive)
    """

    valid: jnp.ndarray
    t: jnp.ndarray
    p: jnp.ndarray
    n: jnp.ndarray
    frame: Frame
    uv: jnp.ndarray
    wi: jnp.ndarray
    prim: jnp.ndarray
    mat_id: jnp.ndarray
    emitter: jnp.ndarray
    # raw triangle barycentrics (u, v) of the hit (zeros for analytic
    # prims) — mesh_attribute textures interpolate per-corner attributes
    # with them (models/texture.py TC_FULL)
    bary: jnp.ndarray = None

    def to_world(self, v_local):
        return self.frame.to_world(v_local)

    def to_local(self, v_world):
        return self.frame.to_local(v_world)


class DirectionSample(NamedTuple):
    """Emitter direction sample (DirectionSample3f analogue).

    d:        (..., 3) world direction from the reference point
    dist:     (...) distance to the sampled point (inf for env emitters)
    pdf:      (...) solid-angle density (0 = invalid)
    radiance: (..., 3) emitted radiance toward the reference point
    delta:    (...) bool — delta emitter (point/directional): no MIS
    """

    d: jnp.ndarray
    dist: jnp.ndarray
    pdf: jnp.ndarray
    radiance: jnp.ndarray
    delta: jnp.ndarray
    # area-measure density of the sampled point for surface (area) emitters
    # (sel_pmf * prim_pmf / prim_area); 0 for directional/env/delta
    # emitters. Used by the BDPT MIS ratios (render/bdpt.py).
    p_area: jnp.ndarray = None
