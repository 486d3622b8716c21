"""Rusinkiewicz half/difference-angle parameterization for measured BRDFs.

The coordinate transform at the heart of the reference customization's MERL
plugin (SURVEY.md §3.3; mitsuba3/src/bsdfs merl plugin, BASELINE.json
north_star: "Rusinkiewicz half/diff parameterization"):

    h = normalize(wi + wo)                      (half vector)
    (theta_h, phi_h) = spherical(h)
    d = Ry(-theta_h) @ Rz(-phi_h) @ wi          (difference vector)
    (theta_d, phi_d) = spherical(d)

plus the exact inverse used for importance sampling: given sampled
(theta_h, phi_h, theta_d, phi_d), reconstruct wi (and wo by reflecting wi
about h). All functions batched over leading axes; directions are (..., 3)
unit vectors in the local shading frame (+z = normal).
"""

from __future__ import annotations

import jax.numpy as jnp

from mitsuba_customization_tpu.core.math import (
    dir_to_sph,
    dot_keep,
    normalize,
    sph_to_dir,
)


def _rotate_z(v, angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.stack(
        [
            c * v[..., 0] - s * v[..., 1],
            s * v[..., 0] + c * v[..., 1],
            v[..., 2],
        ],
        axis=-1,
    )


def _rotate_y(v, angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.stack(
        [
            c * v[..., 0] + s * v[..., 2],
            v[..., 1],
            -s * v[..., 0] + c * v[..., 2],
        ],
        axis=-1,
    )


def dirs_to_half_diff(wi, wo):
    """(wi, wo) -> (theta_h, phi_h, theta_d, phi_d).

    Standard MERL reader semantics (SURVEY.md §2.1 "Half/diff transform").
    """
    h = normalize(wi + wo)
    theta_h, phi_h = dir_to_sph(h)
    d = _rotate_y(_rotate_z(wi, -phi_h), -theta_h)
    theta_d, phi_d = dir_to_sph(d)
    return theta_h, phi_h, theta_d, phi_d


def half_diff_to_dirs(theta_h, phi_h, theta_d, phi_d):
    """(theta_h, phi_h, theta_d, phi_d) -> (wi, wo). Exact inverse.

    wi = Rz(phi_h) @ Ry(theta_h) @ sph(theta_d, phi_d);
    wo = reflect(wi about h). Needed by the luminance-weighted tabulated
    sampler (sample a half-vector cell, then recover wo).
    """
    d = sph_to_dir(theta_d, phi_d)
    wi = _rotate_z(_rotate_y(d, theta_h), phi_h)
    h = sph_to_dir(theta_h, phi_h)
    wo = 2.0 * dot_keep(wi, h) * h - wi
    return wi, wo


def half_dir_to_diff(h, wi):
    """Given half-vector h and wi, compute (theta_d, phi_d) directly."""
    theta_h, phi_h = dir_to_sph(h)
    d = _rotate_y(_rotate_z(wi, -phi_h), -theta_h)
    return dir_to_sph(d)


def dirs_to_half_diff_fast(wi, wo):
    """(wi, wo) -> (theta_h, theta_d, phi_d) with 3 transcendentals.

    Algebraically identical to dirs_to_half_diff (same rotations), but the
    rotation matrices use cos/sin taken directly from the half vector's
    components instead of recomputing them from angles:
        cos_th = h.z, sin_th = sqrt(1-h.z^2),
        cos_ph = h.x/sin_th, sin_ph = h.y/sin_th.
    Eight transcendental evaluations (2x dir_to_sph, 4x rot trig) collapse
    to two arccos + one arctan2.
    phi_h is not returned (the MERL table is isotropic and never needs it).
    """
    h = normalize(wi + wo)
    hz = jnp.clip(h[..., 2], -1.0, 1.0)
    st2 = jnp.maximum(1.0 - hz * hz, 0.0)
    st = jnp.sqrt(st2)
    safe = st > 1e-12
    inv_st = jnp.where(safe, 1.0 / jnp.maximum(st, 1e-12), 0.0)
    cphi = jnp.where(safe, h[..., 0] * inv_st, 1.0)
    sphi = jnp.where(safe, h[..., 1] * inv_st, 0.0)

    # v = Rz(-phi_h) wi ; d = Ry(-theta_h) v   (cos=hz, sin=st)
    vx = cphi * wi[..., 0] + sphi * wi[..., 1]
    vy = -sphi * wi[..., 0] + cphi * wi[..., 1]
    vz = wi[..., 2]
    dx = hz * vx - st * vz
    dy = vy
    dz = st * vx + hz * vz

    theta_h = jnp.arccos(hz)
    theta_d = jnp.arccos(jnp.clip(dz, -1.0, 1.0))
    phi_d = jnp.arctan2(dy, dx)
    return theta_h, theta_d, phi_d
