"""Rough dielectric (ground glass): GGX/Beckmann microfacet transmission.

Counterpart of mitsuba3 src/bsdfs/roughdielectric.cpp
(SURVEY.md §2.4), implementing Walter et al. 2007 with visible-normal
sampling. Two-sided: lanes may arrive from either side (eta flips).
Radiance-transport convention: transmitted throughput carries the 1/eta^2
scale folded against the eta^2 of the half-vector Jacobian (they cancel,
as in the reference's TransportMode::Radiance path).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.models import microfacet as mf
from mitsuba_customization_tpu.models.fresnel import fresnel_dielectric


class RoughDielectricParams(NamedTuple):
    eta: jnp.ndarray  # (...) relative IOR int/ext
    alpha: jnp.ndarray  # (...)
    specular_reflectance: jnp.ndarray  # (..., 3)
    specular_transmittance: jnp.ndarray  # (..., 3)


def _alpha(params):
    return jnp.maximum(params.alpha, 1e-4)


def _halfvec(params, wi, wo):
    """Micronormal for the (wi, wo) pair: reflection or refraction type.

    Walter 2007 eq. 16: m = -(eta_i wi + eta_o wo) up to sign; in relative
    terms m ∝ wi + wo * eta_it for transmission, wi + wo for reflection.
    Always flipped to the upper hemisphere.
    """
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    is_reflect = ci * co > 0.0
    _, _, eta_it, _ = fresnel_dielectric(ci, params.eta)
    scale = jnp.where(is_reflect, 1.0, eta_it)
    h = m.normalize(wi + wo * scale[..., None])
    h = m.mulsign(h, m.cos_theta(h)[..., None])
    return h, is_reflect, eta_it


def eval(params: RoughDielectricParams, wi, wo, dist_type=mf.GGX):
    """f(wi, wo) * |cos_theta_o| (reflection + transmission lobes)."""
    a = _alpha(params)
    ci = m.cos_theta(wi)
    h, is_reflect, eta_it = _halfvec(params, wi, wo)

    d = mf.eval_ndf(dist_type, a, a, h)
    g = mf.g2_separable(
        dist_type, a, a,
        m.mulsign(wi, ci[..., None]), m.mulsign(wo, ci[..., None]), h,
    )
    f, _, _, _ = fresnel_dielectric(m.dot(wi, h), params.eta)

    # reflection: F D G / (4 |ci|)  (the |co| of f*cos is folded in)
    val_r = params.specular_reflectance * m.safe_div(
        f * d * g, 4.0 * jnp.abs(ci)
    )[..., None]

    # transmission (Walter eq. 21, radiance scale folded): see module doc
    wih = m.dot(wi, h)
    woh = m.dot(wo, h)
    denom = wih + eta_it * woh
    val_t = params.specular_transmittance * jnp.abs(
        m.safe_div(wih * woh, ci * denom * denom)
    )[..., None] * ((1.0 - f) * d * g)[..., None]

    # Walter sidedness: wi on the incident side of the microfacet and wo
    # on its own side (mitsuba3 roughdielectric.cpp eval 'active &=')
    co = m.cos_theta(wo)
    sided = (wih * ci > 0.0) & (woh * co > 0.0)
    active_r = is_reflect & (d > 0.0) & sided
    active_t = jnp.logical_not(is_reflect) & (d > 0.0) & sided
    out = jnp.where(active_r[..., None], val_r, 0.0)
    return out + jnp.where(active_t[..., None], val_t, 0.0)


def pdf(params: RoughDielectricParams, wi, wo, dist_type=mf.GGX):
    a = _alpha(params)
    ci = m.cos_theta(wi)
    h, is_reflect, eta_it = _halfvec(params, wi, wo)
    wi_up = m.mulsign(wi, ci[..., None])
    h_pdf = mf.pdf_micronormal(dist_type, a, a, wi_up, h)
    f, _, _, _ = fresnel_dielectric(m.dot(wi, h), params.eta)

    wih = m.dot(wi, h)
    woh = m.dot(wo, h)
    jac_r = m.safe_div(1.0, 4.0 * jnp.abs(woh))
    denom = wih + eta_it * woh
    jac_t = m.safe_div(
        eta_it * eta_it * jnp.abs(woh), denom * denom
    )
    p = jnp.where(is_reflect, f * jac_r, (1.0 - f) * jac_t) * h_pdf
    co = m.cos_theta(wo)
    # Walter sidedness (matches eval's active mask)
    sided = (wih * ci > 0.0) & (woh * co > 0.0)
    ok = (jnp.abs(ci) > 0.0) & (jnp.abs(co) > 0.0) & sided
    return jnp.where(ok, p, 0.0)


def sample(params: RoughDielectricParams, wi, sample2, sample1=None,
           dist_type=mf.GGX):
    """Returns (wo, pdf, weight, sampled_delta=False)."""
    a = _alpha(params)
    ci = m.cos_theta(wi)
    wi_up = m.mulsign(wi, ci[..., None])
    h_up = mf.sample_micronormal(dist_type, a, a, wi_up, sample2)
    # keep h in the upper hemisphere (_halfvec convention): the sign of
    # dot(wi, h) carries sidedness through fresnel/refract
    h = h_up

    f, cos_theta_t, _, eta_ti = fresnel_dielectric(m.dot(wi, h), params.eta)
    if sample1 is None:
        sample1 = sample2[..., 0]
        # sample reuse would bias the VNDF warp; draw the lobe from a
        # decorrelated hash of the 2-D sample instead (still deterministic)
        sample1 = jnp.abs(jnp.sin(sample2[..., 0] * 1e4 + sample2[..., 1]))
    pick_reflect = sample1 < f

    wo_r = 2.0 * m.dot_keep(wi, h) * h - wi
    # refraction about h (mitsuba3 refract(wi, m, cos_theta_t, eta_ti))
    wo_t = h * (m.dot(wi, h) * eta_ti + cos_theta_t)[..., None] - wi * eta_ti[..., None]
    wo = jnp.where(pick_reflect[..., None], wo_r, m.normalize(wo_t))

    p = pdf(params, wi, wo, dist_type)
    f_cos = eval(params, wi, wo, dist_type)
    weight = m.safe_div(f_cos, p[..., None])
    # eval/pdf classify lobes by hemisphere (reference convention); kill
    # samples whose refracted/reflected direction lands on the wrong side
    # (grazing/TIR-boundary f32 noise) — their classified density is not
    # the density they were drawn from.
    consistent = pick_reflect == (m.cos_theta(wo) * ci > 0.0)
    ok = (p > 1e-12) & consistent
    return (
        wo,
        jnp.where(ok, p, 0.0),
        jnp.where(ok[..., None], weight, 0.0),
        jnp.zeros_like(ok),
    )
