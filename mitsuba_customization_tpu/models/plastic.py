"""Smooth plastic: dielectric coating (delta lobe) over a diffuse base.

Counterpart of mitsuba3 src/bsdfs/plastic.cpp (SURVEY.md §2.4):
specular reflection with probability F(cos_i), otherwise diffuse scattering
with the (1-F_i)(1-F_o) transmission factors and the internal-scattering
compensation 1/(1 - rho * F_dr(1/eta)) of the reference model.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from mitsuba_customization_tpu.models.fresnel import fresnel_dielectric

INV_PI = 1.0 / jnp.pi


class PlasticParams(NamedTuple):
    diffuse_reflectance: jnp.ndarray  # (..., 3)
    specular_reflectance: jnp.ndarray  # (..., 3)
    eta: jnp.ndarray  # (...) relative IOR (int/ext)


def fresnel_diffuse_reflectance(eta):
    """Average Fresnel reflectance for diffuse illumination (polynomial fit,
    same model the reference uses for the internal scattering factor)."""
    return jnp.where(
        eta >= 1.0,
        -1.4399 / (eta * eta) + 0.7099 / eta + 0.6681 + 0.0636 * eta,
        -0.4399
        + 0.7099 / eta
        - 0.3319 / (eta * eta)
        + 0.0636 / (eta * eta * eta),
    )


def _spec_prob(params, wi):
    f_i, _, _, _ = fresnel_dielectric(m.cos_theta(wi), params.eta)
    return f_i


def _diffuse_lobe(params, wi, wo):
    """Non-delta part of f * cos_o."""
    f_i, _, _, _ = fresnel_dielectric(m.cos_theta(wi), params.eta)
    f_o, _, _, _ = fresnel_dielectric(m.cos_theta(wo), params.eta)
    fdr = fresnel_diffuse_reflectance(1.0 / params.eta)
    rho = params.diffuse_reflectance
    inv_eta2 = 1.0 / (params.eta * params.eta)
    val = (
        rho
        * (INV_PI * inv_eta2 * (1.0 - f_i) * (1.0 - f_o))[..., None]
        / (1.0 - rho * fdr[..., None])
        * jnp.maximum(m.cos_theta(wo), 0.0)[..., None]
    )
    active = jnp.logical_and(m.cos_theta(wi) > 0.0, m.cos_theta(wo) > 0.0)
    return jnp.where(active[..., None], val, 0.0)


def eval(params: PlasticParams, wi, wo):
    return _diffuse_lobe(params, wi, wo)


def pdf(params: PlasticParams, wi, wo):
    active = jnp.logical_and(m.cos_theta(wi) > 0.0, m.cos_theta(wo) > 0.0)
    p = (1.0 - _spec_prob(params, wi)) * square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(active, p, 0.0)


def sample(params: PlasticParams, wi, sample2, sample1=None):
    """Returns (wo, pdf, weight, sampled_delta)."""
    ps = _spec_prob(params, wi)
    if sample1 is None:
        # Lobe select reuses sample2.x; rescale the survivor back to U[0,1)
        # so the diffuse warp stays unbiased (mitsuba3 plastic.cpp reuses
        # the sample the same way).
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

    wo_spec = m.reflect(wi)
    wo_diff = square_to_cosine_hemisphere(sample2)
    wo = jnp.where(pick_spec[..., None], wo_spec, wo_diff)

    active = m.cos_theta(wi) > 0.0
    # Delta branch: weight = F * spec / ps = spec (ps == F).
    w_spec = params.specular_reflectance
    # Diffuse branch: weight = f*cos / ((1-ps) * cos/pi).
    p_diff = (1.0 - ps) * square_to_cosine_hemisphere_pdf(wo)
    w_diff = m.safe_div(_diffuse_lobe(params, wi, wo), p_diff[..., None])
    weight = jnp.where(pick_spec[..., None], w_spec, w_diff)
    p_out = jnp.where(pick_spec, ps, p_diff)
    ok = active & (p_out > 0.0)
    return (
        wo,
        jnp.where(ok, p_out, 0.0),
        jnp.where(ok[..., None], weight, 0.0),
        pick_spec,
    )
