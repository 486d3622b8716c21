"""BSDF unit + chi^2 tests — pattern of mitsuba3 src/bsdfs/tests/test_*.py
(SURVEY.md §4.1): pointwise values vs closed forms, chi^2 sampling gates,
and the static dispatch table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.models import (
    bsdf as bsdf_mod,
    conductor,
    dielectric,
    diffuse,
    merl,
    microfacet as mf,
    roughconductor,
    tabulated,
)
from mitsuba_customization_tpu.models.fresnel import fresnel_dielectric
from mitsuba_customization_tpu.utils.chi2 import ChiSquareTest, SphericalDomain

from fixtures import synthetic_table

WI = jnp.asarray([0.35, 0.2, 0.916], dtype=jnp.float32)
WI = WI / jnp.linalg.norm(WI)


def _chi2_bsdf(sample_fn, pdf_fn, n=150_000, seed=0):
    """BSDFAdapter pattern: fixed wi, test wo-sampling against pdf.

    ires=16 (vs default 8) because microfacet pdfs vary steeply near
    grazing cells; test_count applies the Sidak correction over the ~8
    simultaneous chi2 tests in this file (mitsuba3 does the same)."""

    def s(u):
        wi = jnp.broadcast_to(WI, (len(u), 3))
        wo, p, w, _ = sample_fn(wi, jnp.asarray(u))
        valid = np.asarray(p) > 0
        return np.asarray(wo), valid.astype(np.float64)

    def pf(d):
        wi = jnp.broadcast_to(WI, (len(d), 3))
        return np.asarray(pdf_fn(wi, jnp.asarray(d)))

    test = ChiSquareTest(
        SphericalDomain(), s, pf, sample_count=n, res=25, ires=16, seed=seed
    )
    assert test.run(test_count=8), test.messages


# ---------------------------------------------------------------- diffuse


def test_diffuse_eval_closed_form():
    p = diffuse.DiffuseParams(reflectance=jnp.asarray([0.5, 0.25, 1.0]))
    wo = jnp.asarray([0.0, 0.0, 1.0])
    f = np.asarray(diffuse.eval(p, WI, wo))
    assert np.allclose(f, np.array([0.5, 0.25, 1.0]) / np.pi, rtol=1e-5)
    # below horizon -> 0
    f2 = np.asarray(diffuse.eval(p, WI, -wo))
    assert np.all(f2 == 0)


def test_diffuse_chi2():
    p = diffuse.DiffuseParams(reflectance=jnp.asarray([0.8, 0.8, 0.8]))
    _chi2_bsdf(
        lambda wi, u: diffuse.sample(p, wi, u),
        lambda wi, wo: diffuse.pdf(p, wi, wo),
    )


# ---------------------------------------------------------- roughconductor


def _rc_params(alpha=0.3):
    return roughconductor.RoughConductorParams(
        alpha_u=jnp.float32(alpha),
        alpha_v=jnp.float32(alpha),
        eta=jnp.asarray([0.2, 0.9, 1.4]),
        k=jnp.asarray([3.9, 2.5, 2.1]),
        specular_reflectance=jnp.ones(3),
    )


def test_roughconductor_beckmann_chi2():
    p = _rc_params(0.3)
    _chi2_bsdf(
        lambda wi, u: roughconductor.sample(p, wi, u, dist_type=mf.BECKMANN),
        lambda wi, wo: roughconductor.pdf(p, wi, wo, dist_type=mf.BECKMANN),
    )


def test_ggx_ndf_normalization():
    """Integral of D(h) cos(theta) over the hemisphere = 1 (closed form)."""
    alpha = 0.4
    n = 400
    theta = (np.arange(n) + 0.5) / n * (np.pi / 2)
    phi = (np.arange(2 * n) + 0.5) / (2 * n) * 2 * np.pi
    tg, pg = np.meshgrid(theta, phi, indexing="ij")
    h = np.stack(
        [np.sin(tg) * np.cos(pg), np.sin(tg) * np.sin(pg), np.cos(tg)], -1
    )
    d = np.asarray(
        mf.eval_ndf(mf.GGX, alpha, alpha, jnp.asarray(h, dtype=jnp.float32))
    )
    integral = np.sum(
        d * np.cos(tg) * np.sin(tg) * (np.pi / 2 / n) * (2 * np.pi / (2 * n))
    )
    assert abs(integral - 1.0) < 2e-2, integral


def test_ggx_smith_g1_closed_form():
    """Isotropic GGX G1 = 2 / (1 + sqrt(1 + a^2 tan^2 theta))."""
    alpha = 0.5
    theta = 0.9
    v = jnp.asarray([np.sin(theta), 0.0, np.cos(theta)], dtype=jnp.float32)
    h = jnp.asarray([0.0, 0.0, 1.0], dtype=jnp.float32)
    g1 = float(mf.smith_g1(mf.GGX, alpha, alpha, v, h))
    expect = 2.0 / (1.0 + np.sqrt(1.0 + (alpha * np.tan(theta)) ** 2))
    assert abs(g1 - expect) < 1e-5


@pytest.mark.parametrize("alpha", [0.1, 0.4])
def test_roughconductor_chi2(alpha):
    p = _rc_params(alpha)
    _chi2_bsdf(
        lambda wi, u: roughconductor.sample(p, wi, u),
        lambda wi, wo: roughconductor.pdf(p, wi, wo),
    )


def test_roughconductor_reciprocity():
    """f(wi,wo)/cos_o symmetric under wi<->wo swap."""
    p = _rc_params(0.3)
    wo = m.normalize(jnp.asarray([-0.4, 0.5, 0.7]))
    f1 = np.asarray(roughconductor.eval(p, WI, wo)) / float(m.cos_theta(wo))
    f2 = np.asarray(roughconductor.eval(p, wo, WI)) / float(m.cos_theta(WI))
    assert np.allclose(f1, f2, rtol=1e-4)


# ------------------------------------------------------- smooth conductor


def test_conductor_delta_sample():
    p = conductor.ConductorParams(
        eta=jnp.asarray([0.2, 0.9, 1.4]),
        k=jnp.asarray([3.9, 2.5, 2.1]),
        specular_reflectance=jnp.ones(3),
    )
    wo, pdf, w, is_d = conductor.sample(p, WI, jnp.asarray([0.5, 0.5]))
    assert bool(is_d)
    assert np.allclose(np.asarray(wo), np.asarray(m.reflect(WI)), atol=1e-6)
    assert float(pdf) == 1.0
    assert np.all(np.asarray(w) > 0) and np.all(np.asarray(w) <= 1.0)
    assert np.all(np.asarray(conductor.eval(p, WI, wo)) == 0)


# ------------------------------------------------------------- dielectric


def test_dielectric_energy_split():
    p = dielectric.DielectricParams(
        eta=jnp.float32(1.5),
        specular_reflectance=jnp.ones(3),
        specular_transmittance=jnp.ones(3),
    )
    f, ctt, eta_it, eta_ti = fresnel_dielectric(m.cos_theta(WI), 1.5)
    u = jnp.linspace(0.001, 0.999, 1000)
    wi = jnp.broadcast_to(WI, (1000, 3))
    u2 = jnp.stack([u, u], -1)
    wo, pdf, w, _ = dielectric.sample(p, wi, u2)
    refl = np.asarray(wo)[:, 2] > 0
    assert abs(refl.mean() - float(f)) < 0.01  # split matches Fresnel
    # refraction obeys Snell's law
    wt = np.asarray(wo)[~refl][0]
    sin_i = np.linalg.norm(np.asarray(WI)[:2])
    sin_t = np.linalg.norm(wt[:2])
    assert abs(sin_i / sin_t - 1.5) < 1e-3


def test_dielectric_tir():
    """Beyond critical angle from inside: all rays reflect."""
    p = dielectric.DielectricParams(
        eta=jnp.float32(1.5),
        specular_reflectance=jnp.ones(3),
        specular_transmittance=jnp.ones(3),
    )
    wi = m.normalize(jnp.asarray([0.9, 0.0, -0.436]))  # from inside, grazing
    wo, pdf, w, _ = dielectric.sample(p, wi, jnp.asarray([0.99, 0.5]))
    assert float(wo[2]) < 0  # reflected back inside
    assert np.allclose(np.asarray(w), 1.0, atol=1e-5)


# --------------------------------------------------------------- plastic


def test_plastic_chi2():
    from mitsuba_customization_tpu.models import plastic

    p = plastic.PlasticParams(
        diffuse_reflectance=jnp.asarray([0.5, 0.3, 0.2]),
        specular_reflectance=jnp.ones(3),
        eta=jnp.float32(1.49),
    )

    def sample_smooth_only(wi, u):
        # chi2 covers the smooth (diffuse) lobe; delta samples are dropped
        wo, pdf, w, is_d = plastic.sample(p, wi, u)
        pdf = jnp.where(is_d, 0.0, pdf)
        return wo, pdf, w, is_d

    _chi2_bsdf(
        sample_smooth_only,
        lambda wi, wo: plastic.pdf(p, wi, wo),
    )


def test_roughplastic_chi2():
    from mitsuba_customization_tpu.models import roughplastic

    p = roughplastic.RoughPlasticParams(
        diffuse_reflectance=jnp.asarray([0.5, 0.3, 0.2]),
        specular_reflectance=jnp.ones(3),
        eta=jnp.float32(1.49),
        alpha=jnp.float32(0.3),
    )
    _chi2_bsdf(
        lambda wi, u: roughplastic.sample(p, wi, u),
        lambda wi, wo: roughplastic.pdf(p, wi, wo),
    )


def test_plastic_energy_conservation():
    """White furnace weight never exceeds 1 (energy conservation of the
    coated-diffuse model)."""
    from mitsuba_customization_tpu.models import plastic

    p = plastic.PlasticParams(
        diffuse_reflectance=jnp.asarray([1.0, 1.0, 1.0]),
        specular_reflectance=jnp.ones(3),
        eta=jnp.float32(1.49),
    )
    u = jnp.asarray(np.random.default_rng(0).random((50_000, 2), np.float32))
    wi = jnp.broadcast_to(WI, (50_000, 3))
    wo, pdf, w, is_d = plastic.sample(p, wi, u)
    est = np.asarray(w).mean(0)  # directional albedo estimate
    assert np.all(est <= 1.01), est


# ----------------------------------------------------------------- MERL


@pytest.fixture(scope="module")
def merl_brdf():
    return tabulated.TabulatedBRDF.build(jnp.asarray(synthetic_table()))


def test_merl_chi2(merl_brdf):
    sample_j = jax.jit(tabulated.sample)
    pdf_j = jax.jit(tabulated.pdf)
    _chi2_bsdf(
        lambda wi, u: sample_j(merl_brdf, wi, u),
        lambda wi, wo: pdf_j(merl_brdf, wi, wo),
        n=200_000,
    )


def test_merl_eval_matches_table_peak(merl_brdf):
    """Mirror configuration reads the theta_h=0 cells (peak)."""
    wo = jnp.stack([-WI[0], -WI[1], WI[2]])
    f = np.asarray(tabulated.eval_raw(merl_brdf.table, WI, wo))
    tbl = np.asarray(merl_brdf.table)
    td_idx = int(
        np.clip(np.arccos(float(WI[2])) / (np.pi / 2) * 90 - 0.5, 0, 89)
    )
    ref = tbl[0, td_idx : td_idx + 2].mean(axis=(0, 1))
    assert np.all(f > 0)
    assert np.allclose(f, ref, rtol=0.35)  # coarse: interpolation smoothing


def test_merl_reciprocity(merl_brdf):
    wo = m.normalize(jnp.asarray([-0.5, 0.3, 0.81]))
    f1 = np.asarray(tabulated.eval_raw(merl_brdf.table, WI, wo))
    f2 = np.asarray(tabulated.eval_raw(merl_brdf.table, wo, WI))
    assert np.allclose(f1, f2, rtol=1e-3)


def test_merl_table_gradients(merl_brdf):
    """d eval / d table is a sparse scatter into the gathered corners —
    the quantity path replay accumulates (SURVEY.md §3.2)."""

    def loss(table):
        wo = m.normalize(jnp.asarray([-0.2, 0.1, 0.97]))
        return jnp.sum(tabulated.eval_raw(table, WI, wo))

    g = jax.grad(loss)(merl_brdf.table)
    nz = np.asarray(jnp.sum(g != 0))
    assert 0 < nz <= 24  # at most 8 corners x 3 channels
    assert np.isfinite(np.asarray(g)).all()


# ------------------------------------------------------- dispatch table


def test_bsdf_table_dispatch(merl_brdf):
    table = bsdf_mod.BSDFTable(
        mat_type=jnp.asarray(
            [bsdf_mod.DIFFUSE, bsdf_mod.TABULATED, bsdf_mod.ROUGHCONDUCTOR],
            dtype=jnp.int32,
        ),
        mat_slot=jnp.asarray([0, 0, 0], dtype=jnp.int32),
        stacks={
            bsdf_mod.DIFFUSE: diffuse.DiffuseParams(
                reflectance=jnp.asarray([[0.5, 0.5, 0.5]])
            ),
            bsdf_mod.TABULATED: tabulated.TabulatedBRDF(
                table=merl_brdf.table[None],
                sampling=jax.tree_util.tree_map(
                    lambda a: a[None], merl_brdf.sampling
                ),
            ),
            bsdf_mod.ROUGHCONDUCTOR: jax.tree_util.tree_map(
                lambda a: jnp.asarray(a)[None], _rc_params(0.2)
            ),
        },
    )
    n = 64
    mat_id = jnp.asarray(np.random.default_rng(0).integers(0, 3, n))
    wi = jnp.broadcast_to(WI, (n, 3))
    wo = m.normalize(
        jnp.asarray(
            np.abs(np.random.default_rng(1).normal(size=(n, 3)))
            * np.array([1, 1, 1.0])
        )
    )
    f = bsdf_mod.eval(table, mat_id, wi, wo)
    assert f.shape == (n, 3)
    # each lane must agree with a direct call to its kernel
    f_diffuse = diffuse.eval(
        diffuse.DiffuseParams(reflectance=jnp.asarray([0.5, 0.5, 0.5])), wi, wo
    )
    sel = np.asarray(mat_id) == bsdf_mod.DIFFUSE
    assert np.allclose(np.asarray(f)[sel], np.asarray(f_diffuse)[sel], rtol=1e-5)
    f_merl = tabulated.eval(merl_brdf, wi, wo)
    sel_t = np.asarray(mat_id) == bsdf_mod.TABULATED
    assert np.allclose(np.asarray(f)[sel_t], np.asarray(f_merl)[sel_t], rtol=1e-5)
    # sampling dispatch runs and produces finite results
    u = jnp.asarray(np.random.default_rng(2).random((n, 2)), dtype=jnp.float32)
    wo_s, p_s, w_s, _ = bsdf_mod.sample(table, mat_id, wi, u)
    assert np.isfinite(np.asarray(wo_s)).all()
    assert np.isfinite(np.asarray(w_s)).all()
    assert table.is_delta(jnp.asarray([0])).tolist() == [False]
