"""Fresnel reflectance: dielectric (with Snell refraction data) and conductor.

Counterpart of mitsuba3 include/mitsuba/render/fresnel.h
(SURVEY.md §2.3 "Fresnel module"). Batched jnp; conductors take per-channel
complex IOR (eta - i*k), matching the reference's conductor/roughconductor.
"""

from __future__ import annotations

import jax.numpy as jnp

from mitsuba_customization_tpu.core.math import safe_sqrt


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel for a dielectric boundary.

    eta = n_transmitted / n_incident (relative IOR, > 0). cos_theta_i may be
    negative (ray arriving from inside). Returns (F, cos_theta_t, eta_it,
    eta_ti) as in mitsuba3 fresnel(): the data needed by refraction.
    """
    outside = cos_theta_i >= 0.0
    eta_it = jnp.where(outside, eta, 1.0 / eta)
    eta_ti = jnp.where(outside, 1.0 / eta, eta)

    cti = jnp.abs(cos_theta_i)
    sin2_t = eta_ti * eta_ti * jnp.maximum(0.0, 1.0 - cti * cti)
    tir = sin2_t >= 1.0
    ctt = safe_sqrt(1.0 - sin2_t)

    a_s = (cti - eta_it * ctt) / jnp.maximum(cti + eta_it * ctt, 1e-12)
    a_p = (eta_it * cti - ctt) / jnp.maximum(eta_it * cti + ctt, 1e-12)
    f = 0.5 * (a_s * a_s + a_p * a_p)
    f = jnp.where(tir, 1.0, f)
    # Transmitted cosine carries the opposite sign of the incident cosine.
    cos_theta_t = jnp.where(tir, 0.0, -jnp.sign(cos_theta_i) * ctt)
    return f, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized Fresnel for a conductor with complex IOR eta - i*k.

    eta, k broadcast against cos_theta_i[..., None] for RGB channels.
    Exact formula (same as mitsuba3 fresnel_conductor).
    """
    c = jnp.maximum(jnp.abs(cos_theta_i), 1e-6)[..., None]
    c2 = c * c
    s2 = 1.0 - c2

    e2 = eta * eta
    k2 = k * k

    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-12)

    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_theta_i, f0):
    """Schlick approximation (used by `principled`-style models)."""
    m = jnp.clip(1.0 - jnp.abs(cos_theta_i), 0.0, 1.0)[..., None]
    return f0 + (1.0 - f0) * (m**5)
