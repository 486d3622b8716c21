"""Tabulated measured-BRDF core: Rusinkiewicz-grid storage, trilinear
interpolation, luminance-weighted importance sampling.

This is the shared machinery behind the reference customization's two
plugins (SURVEY.md §2.1): the MERL plugin (90x90x180 grid) and the
"customized_measurment" plugin (resolution-parameterized grid). It
implements exactly the capability contract of BASELINE.json north_star:

* storage over (theta_h, theta_d, phi_d) with the nonlinear sqrt warp on
  theta_h:  ind = sqrt(theta_h / (pi/2)) * n_th   (SURVEY.md §2.1)
* trilinear interpolation over the three axes (phi_d wraps with period pi
  — reciprocity folds [pi, 2pi) onto [0, pi), so phi_d = 0 and pi are the
  same physical configuration)
* luminance-weighted tabulated importance sampling: per incident-angle bin,
  a Marginal2D over the half-vector (sqrt-warped theta_h x phi_h) built
  from the table's luminance, inverted per lane, defensively mixed with a
  cosine lobe (mitsuba3's Marginal2D pattern, SURVEY.md §2.3).

Everything is jittable and differentiable w.r.t. the table (the trilinear
gather has a scatter-add VJP, which is how BRDF-table gradients accumulate
during path replay — SURVEY.md §3.2).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.distr import Marginal2D
from mitsuba_customization_tpu.core.rusinkiewicz import dirs_to_half_diff
from mitsuba_customization_tpu.core.spectrum import luminance
from mitsuba_customization_tpu.core.warp import (
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)

HALF_PI = jnp.pi / 2.0

# Dispatch contract (models/bsdf.py): stacked tensors, slot + lane mask.
NEEDS_SLOT = True
NEEDS_MASK = True

# Defensive-mixture weight: probability of falling back to a cosine lobe.
# Guarantees full-support sampling even where the measured luminance
# vanishes, bounding eval/pdf weights (SURVEY.md §7.3 item "MERL gather").
COSINE_MIX = 0.1

# Resolution of the tabulated sampler: number of incident-angle slices and
# the (theta_h, phi_h) grid per slice.
N_THETA_I = 32
SAMPLE_RES_H = 32
SAMPLE_RES_PHI = 64


class TabulatedBRDF(NamedTuple):
    """A measured BRDF table plus its derived sampling distributions.

    table:    (n_th, n_td, n_pd, 3) float32 — BRDF values (sr^-1), already
              channel-scaled (MERL scales applied at load); or a stacked
              (n_mat, n_th, n_td, n_pd, 3) tensor for multi-material scenes.
    sampling: Marginal2D stack with leading axis N_THETA_I (after the
              material axis when stacked) — per incident-angle-bin
              half-vector distribution.
    """

    table: jnp.ndarray
    sampling: Marginal2D

    @staticmethod
    def build(table):
        """Construct from a table; also (re)builds the sampling CDFs.

        Called inside the jitted optimization step after each table update
        (SURVEY.md §3.5 'params.update() rebuilds sampling CDFs')."""
        return TabulatedBRDF(table=table, sampling=_build_sampling(table))

    @staticmethod
    def build_stack(tables):
        """Construct from a stacked (n_mat, n_th, n_td, n_pd, 3) tensor.

        The multi-material device-resident BRDF stack (BASELINE configs[4]:
        "10 MERL materials"); eval/pdf/sample then take per-lane `slot`.
        """
        return TabulatedBRDF(
            table=tables, sampling=jax.vmap(_build_sampling)(tables)
        )


# --------------------------------------------------------------------------
# Index math + trilinear interpolation
# --------------------------------------------------------------------------


def _grid_coords(table_shape, theta_h, theta_d, phi_d):
    """Continuous (cell-centered) grid coordinates for the three axes.

    Standard MERL index semantics (SURVEY.md §2.1 'MERL numerics'), with
    0.5-cell centering so trilinear interpolation is symmetric.
    """
    n_th, n_td, n_pd = table_shape[-4], table_shape[-3], table_shape[-2]
    u_th = m.safe_sqrt(theta_h / HALF_PI) * n_th - 0.5
    u_td = theta_d / HALF_PI * n_td - 0.5
    phi_d = jnp.where(phi_d < 0.0, phi_d + jnp.pi, phi_d)  # reciprocity fold
    u_pd = phi_d / jnp.pi * n_pd - 0.5
    return u_th, u_td, u_pd


def _trilinear_gather(table, u_th, u_td, u_pd, slot=None):
    """Trilinear interpolation over (theta_h, theta_d, phi_d).

    8 corner gathers per channel (SURVEY.md §3.3: '8 gathers per channel').
    theta axes clamp at the borders; phi_d wraps (period pi). With a
    stacked table (n_mat, n_th, n_td, n_pd, 3) and per-lane `slot`, corners
    gather from each lane's material slice — the device-resident
    multi-material BRDF tensor of BASELINE.json north_star.
    """
    n_th, n_td, n_pd = table.shape[-4], table.shape[-3], table.shape[-2]

    i0 = jnp.floor(u_th).astype(jnp.int32)
    j0 = jnp.floor(u_td).astype(jnp.int32)
    k0 = jnp.floor(u_pd).astype(jnp.int32)
    fth = u_th - i0
    ftd = u_td - j0
    fpd = u_pd - k0

    i0c = jnp.clip(i0, 0, n_th - 1)
    i1c = jnp.clip(i0 + 1, 0, n_th - 1)
    j0c = jnp.clip(j0, 0, n_td - 1)
    j1c = jnp.clip(j0 + 1, 0, n_td - 1)
    k0c = jnp.mod(k0, n_pd)
    k1c = jnp.mod(k0 + 1, n_pd)

    if slot is None:
        def corner(ii, jj, kk):
            return table[ii, jj, kk]  # (..., 3) gather
    else:
        def corner(ii, jj, kk):
            return table[slot, ii, jj, kk]

    wth1, wth0 = fth[..., None], (1.0 - fth)[..., None]
    wtd1, wtd0 = ftd[..., None], (1.0 - ftd)[..., None]
    wpd1, wpd0 = fpd[..., None], (1.0 - fpd)[..., None]

    c000 = corner(i0c, j0c, k0c)
    c001 = corner(i0c, j0c, k1c)
    c010 = corner(i0c, j1c, k0c)
    c011 = corner(i0c, j1c, k1c)
    c100 = corner(i1c, j0c, k0c)
    c101 = corner(i1c, j0c, k1c)
    c110 = corner(i1c, j1c, k0c)
    c111 = corner(i1c, j1c, k1c)

    c00 = c000 * wpd0 + c001 * wpd1
    c01 = c010 * wpd0 + c011 * wpd1
    c10 = c100 * wpd0 + c101 * wpd1
    c11 = c110 * wpd0 + c111 * wpd1
    c0 = c00 * wtd0 + c01 * wtd1
    c1 = c10 * wtd0 + c11 * wtd1
    return c0 * wth0 + c1 * wth1


def eval_raw(table, wi, wo, slot=None):
    """Interpolated BRDF value f(wi, wo) (no cosine), zero below horizon.

    Eight (..., 3) corner gathers from the table itself; their VJP
    scatter-adds the table gradient.
    """
    theta_h, _, theta_d, phi_d = dirs_to_half_diff(wi, wo)
    u_th, u_td, u_pd = _grid_coords(table.shape[-4:], theta_h, theta_d, phi_d)
    val = _trilinear_gather(table, u_th, u_td, u_pd, slot=slot)
    above = jnp.logical_and(m.cos_theta(wi) > 0.0, m.cos_theta(wo) > 0.0)
    return jnp.where(above[..., None], jnp.maximum(val, 0.0), 0.0)


def _normalize_slot(params, slot):
    """Drop `slot` for unstacked tables.

    A slot index only selects a material from a stacked (n_mat, ...) build;
    passing one against a single-table build would otherwise mis-index the
    sampling stacks (slot would be consumed as the theta_i-bin index).
    """
    return slot if params.table.ndim == 5 else None


def eval_f(params: TabulatedBRDF, wi, wo, slot=None, mask=None):
    """Interpolated f(wi, wo) (no cosine); masked-out lanes read 0."""
    slot = _normalize_slot(params, slot)
    if mask is not None and slot is not None:
        slot = jnp.where(mask, slot, 0)
    out = eval_raw(params.table, wi, wo, slot=slot)
    if mask is not None:
        out = jnp.where(mask[..., None], out, 0.0)
    return out


def eval(params: TabulatedBRDF, wi, wo, slot=None, mask=None):
    """BSDF::eval — f(wi, wo) * cos(theta_o), Mitsuba convention."""
    return eval_f(
        params, wi, wo, slot=slot, mask=mask
    ) * jnp.maximum(m.cos_theta(wo), 0.0)[..., None]


# --------------------------------------------------------------------------
# Luminance-weighted importance sampling
# --------------------------------------------------------------------------
#
# Half-vector parameterization on the unit square, per incident direction:
#   y = u_h   in [0,1):  theta_h = (pi/2) * u_h^2        (sqrt warp, matches
#                        the table's theta_h axis => resolution where the
#                        specular peak lives)
#   x = u_phi in [0,1):  phi_h(rel) = 2*pi*u_phi - pi    (relative to phi_i)
# Solid-angle Jacobian:  d(omega_h) = pi^2 * u_h * sin(theta_h) du dx * 2
#   (d theta_h = pi * u_h du;  d phi = 2*pi dx)
# Reflection Jacobian:   d(omega_o) = 4 |wo . h| d(omega_h)
#
# The per-slice weight grid is  luminance(f) * |d omega_o / d(u,x)|  so the
# Marginal2D density in the square is proportional to luminance in omega_o
# measure — i.e. true luminance-weighted importance sampling.


def _halfvec_from_square(y, x):
    """Unit-square coords -> (half vector in canonical frame, |J| to omega_h)."""
    theta_h = HALF_PI * y * y
    phi_h = 2.0 * jnp.pi * x - jnp.pi
    h = m.sph_to_dir(theta_h, phi_h)
    jac = 2.0 * jnp.pi * jnp.pi * y * jnp.sin(theta_h)  # d omega_h / (du dx)
    return h, jac


def _square_from_halfvec(h):
    """Half vector (canonical frame) -> unit-square coords (y, x)."""
    theta_h, phi_h = m.dir_to_sph(h)
    y = m.safe_sqrt(theta_h / HALF_PI)
    x = (phi_h + jnp.pi) / (2.0 * jnp.pi)
    return y, jnp.clip(x, 0.0, 1.0 - 1e-7)


def _build_sampling(table):
    """Build the per-incident-angle-bin Marginal2D stack from the table."""
    ti = (jnp.arange(N_THETA_I, dtype=jnp.float32) + 0.5) / N_THETA_I * HALF_PI
    yy = (jnp.arange(SAMPLE_RES_H, dtype=jnp.float32) + 0.5) / SAMPLE_RES_H
    xx = (jnp.arange(SAMPLE_RES_PHI, dtype=jnp.float32) + 0.5) / SAMPLE_RES_PHI

    ti_g, y_g, x_g = jnp.meshgrid(ti, yy, xx, indexing="ij")
    wi = m.sph_to_dir(ti_g, jnp.zeros_like(ti_g))  # canonical phi_i = 0
    h, jac_h = _halfvec_from_square(y_g, x_g)
    wo = 2.0 * m.dot_keep(wi, h) * h - wi
    # Luminance of the interpolated BRDF at (wi, wo); masked below horizon.
    lum = luminance(eval_raw(jax.lax.stop_gradient(table), wi, wo))
    weight = lum * jac_h * 4.0 * jnp.abs(m.dot(wo, h))
    weight = jnp.where(m.cos_theta(wo) > 0.0, weight, 0.0)
    return Marginal2D.build(weight)


def _canonical_wi(wi):
    """Rotate wi to phi_i = 0; returns (theta_i, phi_i)."""
    return m.dir_to_sph(wi)


def _slice_index(theta_i):
    return jnp.clip(
        (theta_i / HALF_PI * N_THETA_I).astype(jnp.int32), 0, N_THETA_I - 1
    )


def _rotate_phi(v, phi):
    c, s = jnp.cos(phi), jnp.sin(phi)
    return jnp.stack(
        [
            c * v[..., 0] - s * v[..., 1],
            s * v[..., 0] + c * v[..., 1],
            v[..., 2],
        ],
        axis=-1,
    )


def _table_pdf_canonical(sampling, theta_i, wo_c, wi_c, slot=None,
                         mask=None):
    """Tabulated-half-vector pdf of wo (canonical frame), in omega_o measure."""
    h = m.normalize(wi_c + wo_c)
    y, x = _square_from_halfvec(h)
    tbin = _slice_index(theta_i)
    if mask is not None:
        tbin = jnp.where(mask, tbin, 0)
    slc = (tbin,) if slot is None else (slot, tbin)
    p_sq = sampling.eval_pdf(jnp.stack([y, x], axis=-1), slice_=slc)
    theta_h = HALF_PI * y * y
    jac_h = 2.0 * jnp.pi * jnp.pi * y * jnp.sin(theta_h)
    denom = jac_h * 4.0 * jnp.abs(m.dot(wo_c, h))
    return m.safe_div(p_sq, denom)


def pdf(params: TabulatedBRDF, wi, wo, slot=None, mask=None):
    """BSDF::pdf — density of sample() in solid angle at wo."""
    slot = _normalize_slot(params, slot)
    if mask is not None and slot is not None:
        slot = jnp.where(mask, slot, 0)
    theta_i, phi_i = _canonical_wi(wi)
    wo_c = _rotate_phi(wo, -phi_i)
    wi_c = m.sph_to_dir(theta_i, jnp.zeros_like(theta_i))
    p_tab = _table_pdf_canonical(
        params.sampling, theta_i, wo_c, wi_c, slot=slot, mask=mask
    )
    p_cos = square_to_cosine_hemisphere_pdf(wo)
    p = (1.0 - COSINE_MIX) * p_tab + COSINE_MIX * p_cos
    valid = jnp.logical_and(m.cos_theta(wi) > 0.0, m.cos_theta(wo) > 0.0)
    return jnp.where(valid, p, 0.0)


def sample(params: TabulatedBRDF, wi, sample2, sample1=None, slot=None,
           mask=None):
    """BSDF::sample — luminance-weighted half-vector sampling + cosine mix.

    sample2: (..., 2) for the lobe; sample1: (...) selects the mixture
    component (derived from sample2 by CDF-reuse if not given).
    Returns (wo, pdf, weight = f*cos/pdf).
    """
    slot = _normalize_slot(params, slot)
    theta_i, phi_i = _canonical_wi(wi)
    wi_c = m.sph_to_dir(theta_i, jnp.zeros_like(theta_i))

    if sample1 is None:
        # Reuse the first dimension: split at COSINE_MIX.
        u0 = sample2[..., 0]
        use_cos = u0 < COSINE_MIX
        u0r = jnp.where(
            use_cos, u0 / COSINE_MIX, (u0 - COSINE_MIX) / (1.0 - COSINE_MIX)
        )
        sample2 = jnp.stack(
            [jnp.clip(u0r, 0.0, 1.0 - 1e-7), sample2[..., 1]], axis=-1
        )
    else:
        use_cos = sample1 < COSINE_MIX

    # Tabulated branch (canonical frame).
    if mask is not None and slot is not None:
        slot = jnp.where(mask, slot, 0)
    tbin = _slice_index(theta_i)
    if mask is not None:
        tbin = jnp.where(mask, tbin, 0)
    slc = (tbin,) if slot is None else (slot, tbin)
    pos, p_sq = params.sampling.sample(sample2, slice_=slc)
    h, jac_h = _halfvec_from_square(pos[..., 0], pos[..., 1])
    wo_tab = 2.0 * m.dot_keep(wi_c, h) * h - wi_c

    # Cosine branch.
    wo_cos = square_to_cosine_hemisphere(sample2)

    wo_c = jnp.where(use_cos[..., None], wo_cos, wo_tab)
    wo = _rotate_phi(wo_c, phi_i)

    # Mixture pdf at wo. Tabulated-branch lanes reuse the inversion's own
    # exact cell masses (p_sq) instead of re-fetching CDF rows; only the
    # cosine-branch lanes need one fetch of the tabulated density at wo_cos.
    denom_tab = jac_h * 4.0 * jnp.abs(m.dot(wo_tab, h))
    p_tab_own = m.safe_div(p_sq, denom_tab)
    p_tab_cos = _table_pdf_canonical(
        params.sampling, theta_i, wo_cos, wi_c, slot=slot, mask=mask
    )
    p_tab = jnp.where(use_cos, p_tab_cos, p_tab_own)
    p_cos = square_to_cosine_hemisphere_pdf(wo_c)
    p = (1.0 - COSINE_MIX) * p_tab + COSINE_MIX * p_cos
    valid = (
        (p > 1e-12)
        & (m.cos_theta(wo_c) > 0.0)
        & (m.cos_theta(wi) > 0.0)
    )
    mask_eval = valid if mask is None else jnp.logical_and(mask, valid)
    f_cos = eval(params, wi, wo, slot=slot, mask=mask_eval)
    weight = m.safe_div(f_cos, p[..., None])
    weight = jnp.where(valid[..., None], weight, 0.0)
    return wo, jnp.where(valid, p, 0.0), weight, jnp.zeros_like(valid)


# --------------------------------------------------------------------------
# Fused per-bounce path (one sampling kernel pass + one combined eval pass)
# --------------------------------------------------------------------------


def _row_mass_at(rows, r):
    """Marginal-CDF cell mass at per-lane row r from fetched (lanes, H) rows."""
    from mitsuba_customization_tpu.core.distr import _select_at

    hi = _select_at(rows, r)
    lo = _select_at(rows, jnp.maximum(r - 1, 0)) * (r > 0)
    return hi - lo


def _square_cells(wi_c, wo_c):
    """Canonical-frame direction pair -> half-vector square coords + cells.

    Returns (y, x, r, c, denom) where denom = jac_h * 4|wo.h| converts the
    square density to solid angle at wo (matches _table_pdf_canonical).
    """
    h = m.normalize(wi_c + wo_c)
    y, x = _square_from_halfvec(h)
    r = jnp.clip((y * SAMPLE_RES_H).astype(jnp.int32), 0, SAMPLE_RES_H - 1)
    c = jnp.clip((x * SAMPLE_RES_PHI).astype(jnp.int32), 0,
                 SAMPLE_RES_PHI - 1)
    theta_h = HALF_PI * y * y
    jac_h = 2.0 * jnp.pi * jnp.pi * y * jnp.sin(theta_h)
    denom = jac_h * 4.0 * jnp.abs(m.dot(wo_c, h))
    return y, x, r, c, denom


def bounce_shade(params: TabulatedBRDF, wi, wo_nee, sample2, sample1=None,
                 slot=None, mask=None, mask_nee=None, need_attached=False):
    """All tabulated-BRDF work of one path-tracer bounce, fused.

    Equal to the sequence {eval_pdf(wo_nee), sample(), eval(wo)}, with
    shared work done once:

      * one marginal-CDF row fetch per lane, inverted for the luminance
        sample and read for the NEE and cosine-branch pdfs;
      * three conditional-CDF row fetches (own sample, NEE, cosine
        branch);
      * ONE combined trilinear eval over [wo_nee ; wo_sampled] (2N lanes).

    Returns (f_nee, pdf_nee, wo, pdf_s, weight, is_delta) with f_nee and
    weight including the cosine term, matching eval()/sample(). All
    sampling quantities (wo, pdfs) are detached; f_nee / weight carry
    table gradients through eval_f (detached-estimator contract,
    SURVEY.md §3.2). need_attached keeps signature parity with the
    dispatch layer (the attached eval at wo *is* the fused one here).
    """
    from mitsuba_customization_tpu.core.distr import _invert_cdf

    sg = jax.lax.stop_gradient
    slot = _normalize_slot(params, slot)
    wi = sg(wi)
    wo_nee = sg(wo_nee)
    n = wi.shape[0]
    cos_wi_ok = m.cos_theta(wi) > 0.0
    any_mask = cos_wi_ok
    if mask is not None and mask_nee is not None:
        any_mask = any_mask & (mask | mask_nee)
    elif mask is not None:
        any_mask = any_mask & mask

    theta_i, phi_i = _canonical_wi(wi)
    wi_c = m.sph_to_dir(theta_i, jnp.zeros_like(theta_i))
    tbin = _slice_index(theta_i)
    tbin = jnp.where(any_mask, tbin, 0)
    slot_safe = None
    if slot is not None:
        slot_safe = jnp.where(any_mask, slot, 0)

    # ---- mixture branch selection (identical to sample()) ----
    if sample1 is None:
        u0 = sample2[..., 0]
        use_cos = u0 < COSINE_MIX
        u0r = jnp.where(
            use_cos, u0 / COSINE_MIX, (u0 - COSINE_MIX) / (1.0 - COSINE_MIX)
        )
        sample2 = jnp.stack(
            [jnp.clip(u0r, 0.0, 1.0 - 1e-7), sample2[..., 1]], axis=-1
        )
    else:
        use_cos = sample1 < COSINE_MIX
    u_row, u_col = sample2[..., 0], sample2[..., 1]

    # ---- marginal-row work (row fetch + masked reductions) ----
    slc = (tbin,) if slot_safe is None else (slot_safe, tbin)
    cdf_rows = sg(params.sampling.cdf_row[slc])  # (N, H)
    r_own, row_lo, row_mass_own = _invert_cdf(cdf_rows, u_row)
    dy = jnp.clip(
        (u_row - row_lo) / jnp.maximum(row_mass_own, 1e-20), 0.0, 1.0 - 1e-7
    )

    # NEE / cosine-branch half-vector cells (canonical frame)
    wo_nee_c = _rotate_phi(wo_nee, -phi_i)
    nee_ok = m.cos_theta(wo_nee) > 0.0
    if mask_nee is not None:
        nee_ok = nee_ok & mask_nee
    wo_nee_c = jnp.where(nee_ok[..., None], wo_nee_c, wi_c)  # NaN-free
    _, _, r_nee, c_nee, denom_nee = _square_cells(wi_c, wo_nee_c)

    wo_cos = square_to_cosine_hemisphere(sample2)
    _, _, r_cos, c_cos, denom_cos = _square_cells(wi_c, wo_cos)

    # ---- conditional-CDF rows: own sample, NEE and cosine-branch cells ----
    cdf_cond = sg(params.sampling.cdf_cond)
    cond = cdf_cond[slc + (r_own,)]
    col, col_lo, mass_own = _invert_cdf(cond, u_col)
    dx = jnp.clip(
        (u_col - col_lo) / jnp.maximum(mass_own, 1e-20), 0.0, 1.0 - 1e-7
    )
    x = (col.astype(jnp.float32) + dx) / SAMPLE_RES_PHI
    mass_nee = _row_mass_at(cdf_cond[slc + (r_nee,)], c_nee)
    mass_cos = _row_mass_at(cdf_cond[slc + (r_cos,)], c_cos)

    hw = SAMPLE_RES_H * SAMPLE_RES_PHI

    # ---- assemble the sampled direction + its pdf ----
    y = (r_own.astype(jnp.float32) + dy) / SAMPLE_RES_H
    h, jac_h = _halfvec_from_square(y, x)
    wo_tab = 2.0 * m.dot_keep(wi_c, h) * h - wi_c
    denom_own = jac_h * 4.0 * jnp.abs(m.dot(wo_tab, h))
    p_tab_own = m.safe_div(row_mass_own * mass_own * hw, denom_own)
    row_mass_cos = _row_mass_at(cdf_rows, r_cos)
    p_tab_cos = m.safe_div(row_mass_cos * mass_cos * hw, denom_cos)

    wo_c = jnp.where(use_cos[..., None], wo_cos, wo_tab)
    wo = sg(_rotate_phi(wo_c, phi_i))
    p_tab = jnp.where(use_cos, p_tab_cos, p_tab_own)
    p_cos = square_to_cosine_hemisphere_pdf(wo_c)
    pdf_s = sg((1.0 - COSINE_MIX) * p_tab + COSINE_MIX * p_cos)
    valid_s = (
        (pdf_s > 1e-12) & (m.cos_theta(wo_c) > 0.0) & cos_wi_ok
    )
    if mask is not None:
        valid_s_m = valid_s & mask
    else:
        valid_s_m = valid_s

    # ---- NEE pdf (MIS) ----
    row_mass_nee = _row_mass_at(cdf_rows, r_nee)
    p_tab_nee = m.safe_div(row_mass_nee * mass_nee * hw, denom_nee)
    p_cos_nee = square_to_cosine_hemisphere_pdf(wo_nee_c)
    pdf_nee = (1.0 - COSINE_MIX) * p_tab_nee + COSINE_MIX * p_cos_nee
    pdf_nee = sg(jnp.where(nee_ok & cos_wi_ok, pdf_nee, 0.0))

    # ---- ONE combined trilinear eval over [wo_nee ; wo_sampled] ----
    wi2 = jnp.concatenate([wi, wi], axis=0)
    wo2 = jnp.concatenate([wo_nee, wo], axis=0)
    slot2 = None
    if slot_safe is not None:
        slot2 = jnp.concatenate([slot_safe, slot_safe], axis=0)
    mask2 = jnp.concatenate([nee_ok & cos_wi_ok, valid_s_m], axis=0)
    f2 = eval_f(params, wi2, wo2, slot=slot2, mask=mask2)
    cos2 = jnp.maximum(m.cos_theta(wo2), 0.0)[..., None]
    f2 = f2 * cos2
    f_nee, f_s = f2[:n], f2[n:]

    weight = m.safe_div(f_s, pdf_s[..., None])
    weight = jnp.where(valid_s[..., None], weight, 0.0)
    return (
        f_nee,
        pdf_nee,
        wo,
        jnp.where(valid_s, pdf_s, 0.0),
        weight,
        jnp.zeros_like(valid_s),
    )

