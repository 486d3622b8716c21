"""Phase-function kernels: isotropic, Henyey-Greenstein, Rayleigh.

Counterpart of the reference's phase-function plugins
(mitsuba3 src/phase/{isotropic,hg,rayleigh}.cpp, SURVEY.md §2.4
"Media / Phase / Volumes"; mitsuba 0.6 src/phase/). Like the BSDF layer
(models/bsdf.py) there are no virtual calls: each phase function is a pure
kernel over lane batches, dispatched by a static id in the medium table
(render/medium.py).

Conventions (mitsuba3 PhaseFunction): directions point *away* from the
interaction; `wi` toward the incoming ray origin, `wo` the new direction.
All phase functions here are normalized densities over the sphere, so
pdf == eval and the sample weight is identically 1.
"""

from __future__ import annotations

import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core import warp

ISOTROPIC = 0
HG = 1
RAYLEIGH = 2
SGGX = 3  # specular microflakes (Heitz et al. 2015; mitsuba3 sggx.cpp)

INV_FOURPI = 1.0 / (4.0 * jnp.pi)


# --------------------------------------------------------------------------
# Isotropic (mitsuba3 src/phase/isotropic.cpp)
# --------------------------------------------------------------------------


def iso_eval(wi, wo):
    return jnp.full(wo.shape[:-1], INV_FOURPI, dtype=wo.dtype)


def iso_sample(wi, sample2):
    wo = warp.square_to_uniform_sphere(sample2)
    pdf = jnp.full(wo.shape[:-1], INV_FOURPI, dtype=wo.dtype)
    return wo, pdf


# --------------------------------------------------------------------------
# Henyey-Greenstein (mitsuba3 src/phase/hg.cpp)
# --------------------------------------------------------------------------


def hg_eval(g, wi, wo):
    """HG density at cos_theta = dot(wi, wo) (forward scattering for g>0).

    Mitsuba's convention evaluates at -dot(wi, wo) because both directions
    point away from the interaction; with g>0 the lobe then peaks when wo
    continues in the propagation direction (wo = -wi).
    """
    cos_t = -m.dot(wi, wo)
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_t
    return INV_FOURPI * (1.0 - g2) / jnp.maximum(
        denom * m.safe_sqrt(denom), 1e-12
    )


def hg_sample(g, wi, sample2):
    """Exact HG inverse-CDF sampling (sqr term per the standard formula)."""
    u1 = sample2[..., 0]
    u2 = sample2[..., 1]
    g_safe = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u1)
    cos_theta = jnp.where(
        jnp.abs(g) < 1e-4,
        1.0 - 2.0 * u1,  # isotropic limit
        (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe),
    )
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * jnp.pi * u2
    # Local frame around the propagation direction -wi.
    fwd = -wi
    s, t = m.coordinate_system(fwd)
    wo = (
        (sin_theta * jnp.cos(phi))[..., None] * s
        + (sin_theta * jnp.sin(phi))[..., None] * t
        + cos_theta[..., None] * fwd
    )
    wo = m.normalize(wo)
    return wo, hg_eval(g, wi, wo)


# --------------------------------------------------------------------------
# Rayleigh (mitsuba3 src/phase/rayleigh.cpp)
# --------------------------------------------------------------------------


def rayleigh_eval(wi, wo):
    """(3/16pi)(1 + cos^2 theta) — symmetric, so the sign of cos is moot."""
    cos_t = m.dot(wi, wo)
    return (3.0 / (16.0 * jnp.pi)) * (1.0 + cos_t * cos_t)


def rayleigh_sample(wi, sample2):
    """Exact inversion via the depressed-cubic (Cardano) closed form
    (same construction as mitsuba3 rayleigh.cpp)."""
    u1 = sample2[..., 0]
    u2 = sample2[..., 1]
    z = 2.0 * (2.0 * u1 - 1.0)
    tmp = jnp.cbrt(z + jnp.sqrt(z * z + 1.0))
    cos_theta = jnp.clip(tmp - 1.0 / tmp, -1.0, 1.0)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * jnp.pi * u2
    fwd = -wi
    s, t = m.coordinate_system(fwd)
    wo = (
        (sin_theta * jnp.cos(phi))[..., None] * s
        + (sin_theta * jnp.sin(phi))[..., None] * t
        + cos_theta[..., None] * fwd
    )
    wo = m.normalize(wo)
    return wo, rayleigh_eval(wi, wo)


# --------------------------------------------------------------------------
# SGGX specular microflakes (Heitz, Dupuy, Crassin, Neyret 2015;
# mitsuba3 src/phase/sggx.cpp). The distribution is a symmetric PSD
# 3x3 matrix S packed as (..., 6) = [xx, yy, zz, xy, xz, yz]; the
# specular flake phase f_p(wi -> wo) = D(h) / (4 sigma(wi)) with
# h = normalize(wi + wo) is scale-invariant in S and integrates to 1,
# so eval == pdf and the sample weight is 1 — same contract as the
# other phases.
# --------------------------------------------------------------------------


def _s_unpack(S):
    return (S[..., 0], S[..., 1], S[..., 2],
            S[..., 3], S[..., 4], S[..., 5])


def _sggx_sigma(S, w):
    """Projected flake area sigma(w) = sqrt(w^T S w)."""
    xx, yy, zz, xy, xz, yz = _s_unpack(S)
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    q = (
        x * x * xx + y * y * yy + z * z * zz
        + 2.0 * (x * y * xy + x * z * xz + y * z * yz)
    )
    return m.safe_sqrt(q)


def _sggx_det(S):
    xx, yy, zz, xy, xz, yz = _s_unpack(S)
    return (
        xx * (yy * zz - yz * yz)
        - xy * (xy * zz - yz * xz)
        + xz * (xy * yz - yy * xz)
    )


def _sggx_ndf(S, h):
    """D(h) = 1 / (pi sqrt(|S|) (h^T S^-1 h)^2)."""
    xx, yy, zz, xy, xz, yz = _s_unpack(S)
    det = jnp.maximum(_sggx_det(S), 1e-20)
    # adjugate (cofactor) entries of S
    a_xx = yy * zz - yz * yz
    a_yy = xx * zz - xz * xz
    a_zz = xx * yy - xy * xy
    a_xy = xz * yz - xy * zz
    a_xz = xy * yz - xz * yy
    a_yz = xy * xz - xx * yz
    x, y, z = h[..., 0], h[..., 1], h[..., 2]
    q = (
        x * x * a_xx + y * y * a_yy + z * z * a_zz
        + 2.0 * (x * y * a_xy + x * z * a_xz + y * z * a_yz)
    ) / det
    q = jnp.maximum(q, 1e-12)
    return 1.0 / (jnp.pi * jnp.sqrt(det) * q * q)


def sggx_eval(S, wi, wo):
    h = m.normalize(wi + wo)
    # wi == -wo (grazing fold): h degenerate; density -> finite via guard
    sig = jnp.maximum(_sggx_sigma(S, wi), 1e-12)
    return _sggx_ndf(S, h) / (4.0 * sig)


def sggx_sample(S, wi, sample2):
    """Visible-normal sampling (paper listing 4) + mirror reflection."""
    wk, wj = m.coordinate_system(wi)
    xx, yy, zz, xy, xz, yz = _s_unpack(S)

    def quad(a, b):
        ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
        bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
        return (
            ax * bx * xx + ay * by * yy + az * bz * zz
            + (ax * by + ay * bx) * xy
            + (ax * bz + az * bx) * xz
            + (ay * bz + az * by) * yz
        )

    s_kk = jnp.maximum(quad(wk, wk), 1e-12)
    s_jj = jnp.maximum(quad(wj, wj), 1e-12)
    s_ii = jnp.maximum(quad(wi, wi), 1e-12)
    s_kj = quad(wk, wj)
    s_ki = quad(wk, wi)
    s_ji = quad(wj, wi)

    det = jnp.maximum(_sggx_det(S), 1e-20)
    tmp = m.safe_sqrt(jnp.maximum(s_jj * s_kk - s_kj * s_kj, 1e-20))
    inv_sqrt_sii = 1.0 / jnp.sqrt(s_ii)
    mk = jnp.stack(
        [jnp.sqrt(det) / tmp, jnp.zeros_like(tmp), jnp.zeros_like(tmp)],
        axis=-1,
    )
    mj = jnp.stack(
        [
            -inv_sqrt_sii * (s_ki * s_kj - s_kk * s_ji) / tmp,
            inv_sqrt_sii * tmp,
            jnp.zeros_like(tmp),
        ],
        axis=-1,
    )
    mi = jnp.stack(
        [inv_sqrt_sii * s_ki, inv_sqrt_sii * s_ji, inv_sqrt_sii * s_ii],
        axis=-1,
    )

    u1 = sample2[..., 0]
    u2 = sample2[..., 1]
    r = m.safe_sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    pu = (r * jnp.cos(phi))[..., None]
    pv = (r * jnp.sin(phi))[..., None]
    pw = m.safe_sqrt(1.0 - pu[..., 0] ** 2 - pv[..., 0] ** 2)[..., None]
    m_local = m.normalize(pu * mk + pv * mj + pw * mi)
    # back to world: components along (wk, wj, wi)
    normal = (
        m_local[..., 0:1] * wk
        + m_local[..., 1:2] * wj
        + m_local[..., 2:3] * wi
    )
    normal = m.normalize(normal)
    wo = m.normalize(2.0 * m.dot(normal, wi)[..., None] * normal - wi)
    return wo, sggx_eval(S, wi, wo)


# --------------------------------------------------------------------------
# Static dispatch over (phase_type, g[, S]) lanes — medium.py calls these.
# --------------------------------------------------------------------------


def eval(phase_type, g, wi, wo, S=None):
    """Per-lane phase density (== pdf). S: (..., 6) SGGX matrices or None
    (a structural fact — scenes without sggx media pay nothing)."""
    out = iso_eval(wi, wo)
    out = jnp.where(phase_type == HG, hg_eval(g, wi, wo), out)
    out = jnp.where(phase_type == RAYLEIGH, rayleigh_eval(wi, wo), out)
    if S is not None:
        out = jnp.where(phase_type == SGGX, sggx_eval(S, wi, wo), out)
    return out


def sample(phase_type, g, wi, sample2, S=None):
    """Per-lane phase sampling -> (wo, pdf). Weight is 1 (normalized)."""
    wo_i, pdf_i = iso_sample(wi, sample2)
    wo_h, pdf_h = hg_sample(g, wi, sample2)
    wo_r, pdf_r = rayleigh_sample(wi, sample2)
    is_hg = (phase_type == HG)[..., None]
    is_ray = (phase_type == RAYLEIGH)[..., None]
    wo = jnp.where(is_hg, wo_h, jnp.where(is_ray, wo_r, wo_i))
    pdf = jnp.where(
        phase_type == HG, pdf_h, jnp.where(phase_type == RAYLEIGH, pdf_r, pdf_i)
    )
    if S is not None:
        wo_s, pdf_s = sggx_sample(S, wi, sample2)
        wo = jnp.where((phase_type == SGGX)[..., None], wo_s, wo)
        pdf = jnp.where(phase_type == SGGX, pdf_s, pdf)
    return wo, pdf
