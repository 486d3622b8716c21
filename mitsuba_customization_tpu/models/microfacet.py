"""Microfacet distributions: GGX and Beckmann — NDF, Smith shadowing,
visible-normal sampling.

Counterpart of mitsuba3 include/mitsuba/render/microfacet.h
(MicrofacetDistribution — SURVEY.md §2.3): `eval` (NDF D), `smith_g1`,
visible-normal sampling per Heitz 2018 for GGX, and the matching `pdf`.
Anisotropic (alpha_u, alpha_v) supported throughout. This is the analytic
half of the reference customization's capability (BASELINE.json configs[1]:
"analytic GGX roughconductor").
"""

from __future__ import annotations

import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m

GGX = 0
BECKMANN = 1


def eval_ndf(dist_type, alpha_u, alpha_v, h):
    """Microfacet NDF D(h); h in the shading frame, upper hemisphere."""
    cz = m.cos_theta(h)
    if dist_type == GGX:
        # D = 1 / (pi * au * av * ((hx/au)^2 + (hy/av)^2 + hz^2)^2)
        t = (
            (h[..., 0] / alpha_u) ** 2
            + (h[..., 1] / alpha_v) ** 2
            + h[..., 2] ** 2
        )
        d = m.safe_div(1.0, jnp.pi * alpha_u * alpha_v * t * t)
    else:
        c2 = cz * cz
        t2 = m.safe_div(m.sin_theta2(h), c2)
        cphi2 = jnp.where(
            m.sin_theta2(h) > 0, (h[..., 0] ** 2) / jnp.maximum(m.sin_theta2(h), 1e-12), 1.0
        )
        sphi2 = 1.0 - cphi2
        d = m.safe_div(
            jnp.exp(-t2 * (cphi2 / alpha_u**2 + sphi2 / alpha_v**2)),
            jnp.pi * alpha_u * alpha_v * c2 * c2,
        )
    return jnp.where(cz > 0.0, d, 0.0)


def _lambda_smith(dist_type, alpha_u, alpha_v, v):
    """Smith masking auxiliary Lambda(v) (Heitz 2014)."""
    vz = m.cos_theta(v)
    if dist_type == GGX:
        a2 = (alpha_u * v[..., 0]) ** 2 + (alpha_v * v[..., 1]) ** 2
        t = m.safe_div(a2, vz * vz)
        return 0.5 * (-1.0 + jnp.sqrt(1.0 + t))
    # Beckmann: rational approximation of the error-function form.
    xy2 = v[..., 0] ** 2 + v[..., 1] ** 2
    alpha2 = jnp.where(
        xy2 > 0,
        ((alpha_u * v[..., 0]) ** 2 + (alpha_v * v[..., 1]) ** 2)
        / jnp.maximum(xy2, 1e-12),
        alpha_u * alpha_u,
    )
    tan_theta = m.safe_div(jnp.sqrt(xy2), jnp.abs(vz))
    a = m.safe_div(1.0, jnp.sqrt(alpha2) * tan_theta, default=1e8)
    lam = jnp.where(
        a < 1.6,
        m.safe_div(
            1.0 - 1.259 * a + 0.396 * a * a,
            3.535 * a + 2.181 * a * a,
        ),
        0.0,
    )
    return lam


def smith_g1(dist_type, alpha_u, alpha_v, v, h):
    """Monodirectional Smith shadowing G1(v, h)."""
    g = 1.0 / (1.0 + _lambda_smith(dist_type, alpha_u, alpha_v, v))
    # Sidedness: v must lie on the same side as the micronormal.
    back = m.dot(v, h) * m.cos_theta(v) <= 0.0
    return jnp.where(back, 0.0, g)


def g2_separable(dist_type, alpha_u, alpha_v, wi, wo, h):
    """Separable Smith G2 = G1(wi) * G1(wo) — matches mitsuba3's
    roughconductor (MicrofacetDistribution::G)."""
    return smith_g1(dist_type, alpha_u, alpha_v, wi, h) * smith_g1(
        dist_type, alpha_u, alpha_v, wo, h
    )


def sample_micronormal(dist_type, alpha_u, alpha_v, wi, sample2):
    """Sample a micronormal h and matchingly defined density.

    GGX: Heitz 2018 visible-normal (VNDF) sampling. Beckmann: classical
    full-NDF sampling (theta_h = atan sqrt(-a^2 ln(1-u))) — the 0.6-era
    strategy; its density is D(h) cos(theta_h), not the VNDF. pdf_micro
    below matches each case. Beckmann sampling is isotropic (alpha_u).
    """
    if dist_type == BECKMANN:
        a2 = alpha_u * alpha_u
        t2 = -a2 * jnp.log(jnp.maximum(1.0 - sample2[..., 0], 1e-12))
        cos_t = 1.0 / jnp.sqrt(1.0 + t2)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        phi = 2.0 * jnp.pi * sample2[..., 1]
        return jnp.stack(
            [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1
        )
    return _sample_vndf_ggx(alpha_u, alpha_v, wi, sample2)


def pdf_micronormal(dist_type, alpha_u, alpha_v, wi, h):
    """Density of sample_micronormal in d(omega_h)."""
    if dist_type == BECKMANN:
        return eval_ndf(dist_type, alpha_u, alpha_v, h) * jnp.maximum(
            m.cos_theta(h), 0.0
        )
    return pdf_visible(dist_type, alpha_u, alpha_v, wi, h)


def _sample_vndf_ggx(alpha_u, alpha_v, wi, sample2):
    """Heitz 2018 GGX visible-normal sampling."""
    # Stretch view vector by the roughness.
    vh = m.normalize(
        jnp.stack(
            [alpha_u * wi[..., 0], alpha_v * wi[..., 1], wi[..., 2]], axis=-1
        )
    )
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = m.safe_rsqrt(lensq)
    t1 = jnp.where(
        (lensq > 1e-12)[..., None],
        jnp.stack(
            [-vh[..., 1] * inv_len, vh[..., 0] * inv_len, jnp.zeros_like(inv_len)],
            axis=-1,
        ),
        jnp.broadcast_to(
            jnp.array([1.0, 0.0, 0.0], dtype=vh.dtype), vh.shape
        ),
    )
    t2 = jnp.cross(vh, t1)
    r = jnp.sqrt(sample2[..., 0])
    phi = 2.0 * jnp.pi * sample2[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * m.safe_sqrt(1.0 - p1 * p1) + s * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + m.safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh
    )
    h = m.normalize(
        jnp.stack(
            [
                alpha_u * nh[..., 0],
                alpha_v * nh[..., 1],
                jnp.maximum(nh[..., 2], 1e-6),
            ],
            axis=-1,
        )
    )
    return h


def pdf_visible(dist_type, alpha_u, alpha_v, wi, h):
    """VNDF density in d(omega_h):
    Dv(h) = G1(wi) * max(0, wi.h) * D(h) / cos(theta_i)."""
    d = eval_ndf(dist_type, alpha_u, alpha_v, h)
    g1 = smith_g1(dist_type, alpha_u, alpha_v, wi, h)
    return m.safe_div(
        g1 * jnp.maximum(m.dot(wi, h), 0.0) * d, jnp.abs(m.cos_theta(wi))
    )
