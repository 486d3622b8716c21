"""Rough plastic: GGX-coated diffuse base (all-smooth lobes).

Counterpart of mitsuba3 src/bsdfs/roughplastic.cpp
(SURVEY.md §2.4): a microfacet dielectric coat over a diffuse substrate
with the same internal-scattering compensation as plastic.cpp. Sampling
mixes visible-normal coat sampling with cosine diffuse sampling; the pdf
is the exact mixture, so chi2 gates apply unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from mitsuba_customization_tpu.models import microfacet as mf
from mitsuba_customization_tpu.models.fresnel import fresnel_dielectric
from mitsuba_customization_tpu.models.plastic import (
    fresnel_diffuse_reflectance,
)

INV_PI = 1.0 / jnp.pi


class RoughPlasticParams(NamedTuple):
    diffuse_reflectance: jnp.ndarray  # (..., 3)
    specular_reflectance: jnp.ndarray  # (..., 3)
    eta: jnp.ndarray  # (...)
    alpha: jnp.ndarray  # (...)


def _alpha(params):
    return jnp.maximum(params.alpha, 1e-4)


def _spec_prob(params, wi):
    f_i, _, _, _ = fresnel_dielectric(m.cos_theta(wi), params.eta)
    return jnp.clip(f_i, 0.15, 0.9)


def eval(params: RoughPlasticParams, wi, wo, dist_type=mf.GGX):
    a = _alpha(params)
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    active = jnp.logical_and(ci > 0.0, co > 0.0)
    h = m.normalize(wi + wo)
    d = mf.eval_ndf(dist_type, a, a, h)
    g = mf.g2_separable(dist_type, a, a, wi, wo, h)
    f_h, _, _, _ = fresnel_dielectric(m.dot(wi, h), params.eta)
    spec = (
        params.specular_reflectance
        * (f_h * m.safe_div(d * g, 4.0 * ci))[..., None]
    )

    f_i, _, _, _ = fresnel_dielectric(ci, params.eta)
    f_o, _, _, _ = fresnel_dielectric(co, params.eta)
    fdr = fresnel_diffuse_reflectance(1.0 / params.eta)
    rho = params.diffuse_reflectance
    inv_eta2 = 1.0 / (params.eta * params.eta)
    diff = (
        rho
        * (INV_PI * inv_eta2 * (1.0 - f_i) * (1.0 - f_o))[..., None]
        / (1.0 - rho * fdr[..., None])
        * jnp.maximum(co, 0.0)[..., None]
    )
    return jnp.where(active[..., None], spec + diff, 0.0)


def pdf(params: RoughPlasticParams, wi, wo, dist_type=mf.GGX):
    a = _alpha(params)
    active = jnp.logical_and(m.cos_theta(wi) > 0.0, m.cos_theta(wo) > 0.0)
    ps = _spec_prob(params, wi)
    h = m.normalize(wi + wo)
    dv = mf.pdf_micronormal(dist_type, a, a, wi, h)
    p_spec = m.safe_div(dv, 4.0 * jnp.abs(m.dot(wo, h)))
    p = ps * p_spec + (1.0 - ps) * square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(active, p, 0.0)


def sample(params: RoughPlasticParams, wi, sample2, sample1=None,
           dist_type=mf.GGX):
    """Returns (wo, pdf, weight, sampled_delta=False)."""
    a = _alpha(params)
    ps = _spec_prob(params, wi)
    if sample1 is None:
        # Lobe select reuses sample2.x; rescale the survivor to U[0,1) so
        # both warps stay unbiased (mitsuba3 roughplastic.cpp sample reuse).
        sample1 = sample2[..., 0]
        pick_spec = sample1 < ps
        u0 = jnp.where(
            pick_spec,
            m.safe_div(sample1, ps),
            m.safe_div(sample1 - ps, 1.0 - ps),
        )
        sample2 = jnp.stack(
            [jnp.clip(u0, 0.0, 1.0 - 1e-7), sample2[..., 1]], axis=-1
        )
    else:
        pick_spec = sample1 < ps

    h = mf.sample_micronormal(dist_type, a, a, wi, sample2)
    wo_spec = 2.0 * m.dot_keep(wi, h) * h - wi
    wo_diff = square_to_cosine_hemisphere(sample2)
    wo = jnp.where(pick_spec[..., None], wo_spec, wo_diff)

    p = pdf(params, wi, wo, dist_type)
    f_cos = eval(params, wi, wo, dist_type)
    weight = m.safe_div(f_cos, p[..., None])
    ok = (
        (m.cos_theta(wi) > 0.0)
        & (m.cos_theta(wo) > 0.0)
        & (p > 1e-12)
    )
    return (
        wo,
        jnp.where(ok, p, 0.0),
        jnp.where(ok[..., None], weight, 0.0),
        jnp.zeros_like(ok),
    )
