"""Sampling warps: [0,1)^2 -> hemisphere/sphere/disk/triangle, with pdfs.

Counterpart of mitsuba3 src/core/warp.cpp + include/mitsuba/core/
warp.h (SURVEY.md §2.3). Same warp set used by the BSDF/emitter samplers.
Each `square_to_*` has a matching `square_to_*_pdf` evaluated at the warped
point, as in the reference, so chi^2 tests can gate them (SURVEY.md §4.1).
"""

from __future__ import annotations

import jax.numpy as jnp

from mitsuba_customization_tpu.core.math import (
    safe_sqrt,
)

INV_PI = 1.0 / jnp.pi
INV_TWO_PI = 1.0 / (2.0 * jnp.pi)
INV_FOUR_PI = 1.0 / (4.0 * jnp.pi)


def square_to_uniform_disk_concentric(sample):
    """Shirley-Chiu concentric disk mapping (low distortion).

    Same mapping as mitsuba3 warp::square_to_uniform_disk_concentric.
    sample: (..., 2) in [0,1)^2 -> (..., 2) on unit disk.
    """
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = jnp.logical_and(x == 0.0, y == 0.0)
    quadrant_x = jnp.abs(x) > jnp.abs(y)
    r = jnp.where(quadrant_x, x, y)
    ratio = jnp.where(
        quadrant_x,
        jnp.where(x != 0.0, y / jnp.where(x == 0.0, 1.0, x), 0.0),
        jnp.where(y != 0.0, x / jnp.where(y == 0.0, 1.0, y), 0.0),
    )
    phi = jnp.where(
        quadrant_x,
        (jnp.pi / 4.0) * ratio,
        (jnp.pi / 2.0) - (jnp.pi / 4.0) * ratio,
    )
    r = jnp.where(is_zero, 0.0, r)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def square_to_uniform_disk_concentric_pdf(p):
    return jnp.full(p.shape[:-1], INV_PI)


def square_to_cosine_hemisphere(sample):
    """Cosine-weighted hemisphere via concentric disk + projection.

    mitsuba3 warp::square_to_cosine_hemisphere (Malley's method).
    """
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return jnp.stack([p[..., 0], p[..., 1], z], axis=-1)


def square_to_cosine_hemisphere_pdf(d):
    return jnp.maximum(d[..., 2], 0.0) * INV_PI


def square_to_uniform_hemisphere(sample):
    """Uniform hemisphere (z >= 0) — warp::square_to_uniform_hemisphere."""
    z = sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * sample[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_hemisphere_pdf(d):
    return jnp.where(d[..., 2] >= 0.0, INV_TWO_PI, 0.0)


def square_to_uniform_sphere(sample):
    """Uniform sphere — warp::square_to_uniform_sphere."""
    z = 1.0 - 2.0 * sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * sample[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_sphere_pdf(d):
    return jnp.full(d.shape[:-1], INV_FOUR_PI)


def square_to_uniform_cone(sample, cos_cutoff):
    """Uniform direction in a cone around +z — warp::square_to_uniform_cone."""
    z = 1.0 - sample[..., 0] * (1.0 - cos_cutoff)
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * sample[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_cone_pdf(d, cos_cutoff):
    inside = d[..., 2] >= cos_cutoff
    return jnp.where(inside, INV_TWO_PI / (1.0 - cos_cutoff), 0.0)


def square_to_uniform_triangle(sample):
    """Uniform barycentrics on the unit triangle — square_to_uniform_triangle.

    Uses the sqrt-based mapping (same as mitsuba3). Returns (..., 2)
    barycentric (b1, b2); b0 = 1 - b1 - b2.
    """
    t = safe_sqrt(1.0 - sample[..., 0])
    return jnp.stack([1.0 - t, t * sample[..., 1]], axis=-1)


def square_to_std_normal(sample):
    """Box-Muller 2D standard normal — warp::square_to_std_normal."""
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(1.0 - sample[..., 0], 1e-38)))
    phi = 2.0 * jnp.pi * sample[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def interval_to_tent(sample):
    """[0,1) -> tent distribution on (-1, 1) — used by the tent rfilter."""
    return jnp.where(
        sample >= 0.5,
        1.0 - safe_sqrt(jnp.maximum(0.0, 2.0 - 2.0 * sample)),
        safe_sqrt(jnp.maximum(0.0, 2.0 * sample)) - 1.0,
    )
