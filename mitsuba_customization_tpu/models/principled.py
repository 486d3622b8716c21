"""Principled BSDF (Disney 2012/2015) — opaque configuration.

Counterpart of mitsuba3 src/bsdfs/principled.cpp (SURVEY.md
§2.4, round-2 verdict item 8). Implements the reflective lobe set:

  * Disney base diffuse with the retro-reflection Fd90 term and the
    flatness (fake-subsurface) mix,
  * sheen with sheen_tint,
  * the main anisotropic GGX specular lobe with the principled Fresnel
    (dielectric Schlick lerped to metallic base-color Schlick, spec_tint),
  * the GTR1 clearcoat lobe (fixed 0.25 Smith alpha, 0.04 Schlick F0).

Out of the opaque contract (documented; as in the reference these route
through other plugins here): spec_trans > 0 transmission — use
dielectric/roughdielectric for transmissive materials.

Sampling is a 3-way mixture (cosine diffuse / GGX VNDF / GTR1 clearcoat)
with luminance-derived lobe probabilities; pdf is the exact mixture
density, so the chi2 harness gates it unchanged (tests/test_principled.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.spectrum import luminance
from mitsuba_customization_tpu.core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from mitsuba_customization_tpu.models import microfacet as mf

INV_PI = 1.0 / jnp.pi


class PrincipledParams(NamedTuple):
    base_color: jnp.ndarray  # (..., 3)
    roughness: jnp.ndarray  # (...)
    anisotropic: jnp.ndarray  # (...)
    metallic: jnp.ndarray  # (...)
    spec_tint: jnp.ndarray  # (...)
    specular: jnp.ndarray  # (...) dielectric F0 scale (0.5 -> F0=0.04)
    sheen: jnp.ndarray  # (...)
    sheen_tint: jnp.ndarray  # (...)
    clearcoat: jnp.ndarray  # (...)
    clearcoat_gloss: jnp.ndarray  # (...)
    flatness: jnp.ndarray  # (...)


def _schlick_weight(cos):
    x = jnp.clip(1.0 - cos, 0.0, 1.0)
    x2 = x * x
    return x2 * x2 * x


def _alphas(params):
    aspect = jnp.sqrt(1.0 - 0.9 * jnp.clip(params.anisotropic, 0.0, 1.0))
    r2 = params.roughness * params.roughness
    ax = jnp.maximum(r2 / aspect, 1e-4)
    ay = jnp.maximum(r2 * aspect, 1e-4)
    return ax, ay


def _tint(base_color):
    lum = luminance(base_color)
    return jnp.where(
        lum[..., None] > 0.0,
        base_color / jnp.maximum(lum, 1e-7)[..., None],
        jnp.ones_like(base_color),
    )


def _cspec0(params):
    """Specular F0 color: lerp(0.08*specular*tint_mix, base_color, metallic)."""
    c_tint = _tint(params.base_color)
    tint_mix = (
        (1.0 - params.spec_tint)[..., None]
        + params.spec_tint[..., None] * c_tint
    )
    f0_diel = (0.08 * params.specular)[..., None] * tint_mix
    return (
        (1.0 - params.metallic)[..., None] * f0_diel
        + params.metallic[..., None] * params.base_color
    )


def _gtr1_ndf(alpha, h):
    a2 = alpha * alpha
    c2 = m.cos_theta(h) ** 2
    denom = jnp.pi * jnp.log(jnp.maximum(a2, 1e-7)) * (1.0 + (a2 - 1.0) * c2)
    return m.safe_div(a2 - 1.0, denom)


def _cc_alpha(params):
    return (
        (1.0 - params.clearcoat_gloss) * 0.1
        + params.clearcoat_gloss * 0.001
    )


def _lobe_probs(params, wi):
    """(p_diff, p_spec, p_cc) sampling mixture from lobe luminances."""
    f_approx = luminance(_cspec0(params)) + 0.1
    w_spec = f_approx
    w_diff = (1.0 - params.metallic) * jnp.maximum(
        luminance(params.base_color), 1e-3
    )
    w_cc = 0.25 * params.clearcoat
    total = w_spec + w_diff + w_cc
    return w_diff / total, w_spec / total, w_cc / total


def eval(params: PrincipledParams, wi, wo):
    """f(wi, wo) * cos(theta_o) — reflective principled lobes."""
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    active = jnp.logical_and(ci > 0.0, co > 0.0)
    h = m.normalize(wi + wo)
    cos_d = jnp.abs(m.dot(wo, h))  # half-difference angle

    # ---- base diffuse + flatness (fake subsurface) ----
    fw_i, fw_o = _schlick_weight(ci), _schlick_weight(co)
    fd90 = 0.5 + 2.0 * params.roughness * cos_d * cos_d
    fd = (1.0 + (fd90 - 1.0) * fw_i) * (1.0 + (fd90 - 1.0) * fw_o)
    fss90 = params.roughness * cos_d * cos_d
    fss = (1.0 + (fss90 - 1.0) * fw_i) * (1.0 + (fss90 - 1.0) * fw_o)
    ss = 1.25 * (fss * (m.safe_div(1.0, ci + co) - 0.5) + 0.5)
    base_diff = (1.0 - params.flatness) * fd + params.flatness * ss
    diffuse = (
        params.base_color
        * (INV_PI * base_diff * (1.0 - params.metallic))[..., None]
    )

    # ---- sheen ----
    c_sheen = (
        (1.0 - params.sheen_tint)[..., None]
        + params.sheen_tint[..., None] * _tint(params.base_color)
    )
    sheen = (
        c_sheen
        * (
            params.sheen
            * (1.0 - params.metallic)
            * _schlick_weight(cos_d)
        )[..., None]
    )

    # ---- main specular (anisotropic GGX, principled Fresnel) ----
    ax, ay = _alphas(params)
    d = mf.eval_ndf(mf.GGX, ax, ay, h)
    g = mf.g2_separable(mf.GGX, ax, ay, wi, wo, h)
    cspec0 = _cspec0(params)
    f = cspec0 + (1.0 - cspec0) * _schlick_weight(cos_d)[..., None]
    spec = f * m.safe_div(d * g, 4.0 * ci)[..., None]

    # ---- clearcoat (GTR1, fixed 0.25 smith alpha) ----
    dc = _gtr1_ndf(_cc_alpha(params), h)
    fc = 0.04 + 0.96 * _schlick_weight(cos_d)
    gc = mf.g2_separable(mf.GGX, 0.25, 0.25, wi, wo, h)
    cc = (0.25 * params.clearcoat) * m.safe_div(dc * fc * gc, 4.0 * ci)

    out = (
        (diffuse + sheen) * jnp.maximum(co, 0.0)[..., None]
        + spec
        + cc[..., None]
    )
    return jnp.where(active[..., None], out, 0.0)


def pdf(params: PrincipledParams, wi, wo):
    active = jnp.logical_and(m.cos_theta(wi) > 0.0, m.cos_theta(wo) > 0.0)
    h = m.normalize(wi + wo)
    jac = m.safe_div(1.0, 4.0 * jnp.abs(m.dot(wo, h)))
    ax, ay = _alphas(params)
    p_diff_w, p_spec_w, p_cc_w = _lobe_probs(params, wi)
    p_spec = mf.pdf_micronormal(mf.GGX, ax, ay, wi, h) * jac
    dc = _gtr1_ndf(_cc_alpha(params), h)
    p_cc = jnp.abs(dc * m.cos_theta(h)) * jac
    p = (
        p_diff_w * square_to_cosine_hemisphere_pdf(wo)
        + p_spec_w * p_spec
        + p_cc_w * p_cc
    )
    return jnp.where(active, p, 0.0)


def _sample_gtr1(alpha, sample2):
    a2 = jnp.maximum(alpha * alpha, 1e-7)
    u0 = jnp.clip(sample2[..., 0], 0.0, 1.0 - 1e-7)
    c2 = m.safe_div(1.0 - jnp.power(a2, 1.0 - u0), 1.0 - a2)
    cos_t = m.safe_sqrt(jnp.clip(c2, 0.0, 1.0))
    sin_t = m.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * jnp.pi * sample2[..., 1]
    return jnp.stack(
        [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1
    )


def sample(params: PrincipledParams, wi, sample2, sample1=None):
    """Returns (wo, pdf, weight = f*cos/pdf, sampled_delta=False)."""
    p_diff_w, p_spec_w, _ = _lobe_probs(params, wi)
    if sample1 is None:
        sample1 = sample2[..., 0]
        t1 = p_diff_w
        t2 = p_diff_w + p_spec_w
        pick_diff = sample1 < t1
        pick_spec = jnp.logical_and(sample1 >= t1, sample1 < t2)
        u0 = jnp.where(
            pick_diff,
            m.safe_div(sample1, t1),
            jnp.where(
                pick_spec,
                m.safe_div(sample1 - t1, t2 - t1),
                m.safe_div(sample1 - t2, 1.0 - t2),
            ),
        )
        sample2 = jnp.stack(
            [jnp.clip(u0, 0.0, 1.0 - 1e-7), sample2[..., 1]], axis=-1
        )
    else:
        t1 = p_diff_w
        t2 = p_diff_w + p_spec_w
        pick_diff = sample1 < t1
        pick_spec = jnp.logical_and(sample1 >= t1, sample1 < t2)

    ax, ay = _alphas(params)
    h_spec = mf.sample_micronormal(mf.GGX, ax, ay, wi, sample2)
    h_cc = _sample_gtr1(_cc_alpha(params), sample2)
    h = jnp.where(pick_spec[..., None], h_spec, h_cc)
    wo_refl = 2.0 * m.dot_keep(wi, h) * h - wi
    wo_diff = square_to_cosine_hemisphere(sample2)
    wo = jnp.where(pick_diff[..., None], wo_diff, wo_refl)

    p = pdf(params, wi, wo)
    f_cos = eval(params, wi, wo)
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
