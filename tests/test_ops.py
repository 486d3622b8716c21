"""Plain-JAX table paths against independent numpy references.

The MERL trilinear eval (models/tabulated.eval_f), the Marginal2D CDF
inversion (core/distr.py), the fused per-bounce tabulated shading
(tabulated.bounce_shade) and per-lane row fetches, plus the small
platform plumbing around them: the load-time intersector choice, the
compile-cache location and chip_smoke.py's refusal to run without a GPU.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mitsuba_customization_tpu.core.distr import DiscreteDistribution, Marginal2D
from mitsuba_customization_tpu.models import tabulated as tb

from reference_renderer import merl_eval_trilinear_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unit(rng, n, hemi=False):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    if hemi:
        v[:, 2] = np.abs(v[:, 2]) + 1e-3
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


def _table(rng, shape=(16, 16, 32, 3), smooth=False):
    t = rng.random(shape).astype(np.float32)
    if smooth:
        for ax in range(-4, -1):
            t = (t + np.roll(t, 1, axis=ax)) / 2
    return t


def _reference(table, wi, wo, slot=None):
    """numpy float64 trilinear eval, per material slot."""
    if slot is None:
        return merl_eval_trilinear_reference(
            table.astype(np.float64), wi.astype(np.float64),
            wo.astype(np.float64),
        )
    out = np.zeros(wi.shape[:-1] + (3,))
    for s in range(table.shape[0]):
        m = slot == s
        out[m] = _reference(table[s], wi[m], wo[m])
    return out


def _assert_close_to_reference(got, ref):
    # f32 half/difference angles lose digits where the half vector nears
    # the normal (arccos of ~1); everywhere else agreement is ~1e-6.
    rel = np.abs(np.asarray(got) - ref) / np.maximum(np.abs(ref), 1e-3)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    assert rel.max() < 5e-3, rel.max()


def _params(table):
    return tb.TabulatedBRDF(table=jnp.asarray(table), sampling=None)


# ---------------------------------------------------------------------------
# MERL trilinear eval
# ---------------------------------------------------------------------------


def _eval_case(case, rng):
    if case in ("rough", "smooth"):
        table = _table(rng, smooth=case == "smooth")
        wi, wo = _unit(rng, 3000, True), _unit(rng, 3000, True)
        got = tb.eval_f(_params(table), jnp.asarray(wi), jnp.asarray(wo))
        _assert_close_to_reference(got, _reference(table, wi, wo))
    elif case == "masked":
        table = _table(rng)
        wi, wo = _unit(rng, 1000, True), _unit(rng, 1000, True)
        mask = rng.random(1000) > 0.5
        got = np.asarray(tb.eval_f(_params(table), jnp.asarray(wi),
                                   jnp.asarray(wo), mask=jnp.asarray(mask)))
        assert np.abs(got[~mask]).max() == 0.0
        _assert_close_to_reference(
            got[mask], _reference(table, wi[mask], wo[mask])
        )
    elif case == "multi_material":
        tables = _table(rng, shape=(3, 16, 16, 32, 3))
        wi, wo = _unit(rng, 2000, True), _unit(rng, 2000, True)
        slot = rng.integers(0, 3, 2000).astype(np.int32)
        got = tb.eval_f(_params(tables), jnp.asarray(wi), jnp.asarray(wo),
                        slot=jnp.asarray(slot))
        _assert_close_to_reference(got, _reference(tables, wi, wo, slot))
    elif case == "odd_lanes":
        table = _table(rng, smooth=True)
        for shape in ((7,), (3, 683)):
            n = int(np.prod(shape))
            wi = _unit(rng, n, True).reshape(shape + (3,))
            wo = _unit(rng, n, True).reshape(shape + (3,))
            got = tb.eval_f(_params(table), jnp.asarray(wi), jnp.asarray(wo))
            assert got.shape == shape + (3,)
            _assert_close_to_reference(
                np.asarray(got).reshape(-1, 3),
                _reference(table, wi.reshape(-1, 3), wo.reshape(-1, 3)),
            )
    elif case == "below_horizon":
        table = _table(rng)
        wi, wo = _unit(rng, 500, True), _unit(rng, 500)
        got = np.asarray(tb.eval_f(_params(table), jnp.asarray(wi),
                                   jnp.asarray(wo)))
        below = wo[:, 2] <= 0.0
        assert below.any() and np.abs(got[below]).max() == 0.0
    elif case == "gradient":
        # eval is linear in the table, so <d loss / d table, T2> must equal
        # the loss of any other table T2 — checked through the reference.
        table = _table(rng, shape=(8, 8, 16, 3))
        wi, wo = _unit(rng, 200, True), _unit(rng, 200, True)
        cot = rng.random((200, 3)).astype(np.float32)

        def loss(t):
            return jnp.sum(
                tb.eval_f(_params(t), jnp.asarray(wi), jnp.asarray(wo)) * cot
            )

        g = np.asarray(jax.grad(loss)(jnp.asarray(table)), np.float64)
        t2 = _table(rng, shape=(8, 8, 16, 3))
        want = np.sum(_reference(t2, wi, wo) * cot)
        assert abs(np.sum(g * t2) - want) < 1e-4 * abs(want)
    else:
        raise ValueError(case)


@pytest.mark.parametrize("case", [
    "rough", "smooth", "masked", "multi_material", "odd_lanes",
    "below_horizon", "gradient",
])
def test_eval_matches_reference(case, rng):
    _eval_case(case, rng)


# ---------------------------------------------------------------------------
# Marginal2D: CDF inversion against numpy
# ---------------------------------------------------------------------------


def _marginal_reference(weights, key, u):
    """numpy float64 two-stage inversion: (y, x) position and density."""
    w = np.maximum(weights.astype(np.float64), 0.0) + 1e-20
    n_sl, h, wd = w.shape
    pos = np.zeros((len(key), 2))
    pdf = np.zeros(len(key))
    for i, (k, (u0, u1)) in enumerate(zip(key, u)):
        total = w[k].sum()
        row_cdf = np.cumsum(w[k].sum(-1) / total)
        r = min(np.searchsorted(row_cdf, u0, side="left"), h - 1)
        lo = row_cdf[r - 1] if r else 0.0
        dy = np.clip((u0 - lo) / (row_cdf[r] - lo), 0.0, 1.0 - 1e-7)
        col_cdf = np.cumsum(w[k, r] / w[k, r].sum())
        c = min(np.searchsorted(col_cdf, u1, side="left"), wd - 1)
        lo = col_cdf[c - 1] if c else 0.0
        dx = np.clip((u1 - lo) / (col_cdf[c] - lo), 0.0, 1.0 - 1e-7)
        pos[i] = ((r + dy) / h, (c + dx) / wd)
        pdf[i] = w[k, r, c] / total * h * wd
    return pos, pdf


@pytest.mark.parametrize("u_kind", ["interior", "edges"])
def test_marginal2d_sample_matches_numpy(u_kind, rng):
    n_sl, h, w, n = 5, 16, 32, 600
    weights = (rng.random((n_sl, h, w)) ** 2 + 1e-4).astype(np.float32)
    key = rng.integers(0, n_sl, n).astype(np.int32)
    u = rng.random((n, 2)).astype(np.float32)
    if u_kind == "edges":
        u[0::2] = 0.0
        u[1::2] = np.float32(1.0 - 1e-7)
    m2d = Marginal2D.build(jnp.asarray(weights))
    pos, pdf = m2d.sample(jnp.asarray(u), slice_=(jnp.asarray(key),))
    pos_ref, pdf_ref = _marginal_reference(weights, key, u)
    np.testing.assert_allclose(np.asarray(pos), pos_ref, rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(pdf), pdf_ref, rtol=1e-4)
    assert float(pos.min()) >= 0.0 and float(pos.max()) <= 1.0


def test_marginal2d_eval_pdf_matches_numpy(rng):
    n_sl, h, w, n = 4, 16, 32, 800
    weights = (rng.random((n_sl, h, w)) + 1e-3).astype(np.float32)
    key = rng.integers(0, n_sl, n).astype(np.int32)
    pos = rng.random((n, 2)).astype(np.float32)
    m2d = Marginal2D.build(jnp.asarray(weights))
    got = np.asarray(m2d.eval_pdf(jnp.asarray(pos),
                                  slice_=(jnp.asarray(key),)))
    r = np.minimum((pos[:, 0] * h).astype(int), h - 1)
    c = np.minimum((pos[:, 1] * w).astype(int), w - 1)
    wd = weights.astype(np.float64)
    want = wd[key, r, c] / wd[key].sum(axis=(1, 2)) * h * w
    # densities come from f32 CDF differences: absolute, not relative,
    # rounding of about eps * (CDF scale)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Fused per-bounce tabulated shading
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stacked", [False, True])
def test_bounce_shade_matches_unfused(stacked, rng):
    """bounce_shade == {eval, pdf, sample} composed."""
    tables = _table(rng, shape=(2, 16, 16, 32, 3), smooth=True) * 0.5 + 0.05
    params = (tb.TabulatedBRDF.build_stack(jnp.asarray(tables)) if stacked
              else tb.TabulatedBRDF.build(jnp.asarray(tables[0])))
    n = 1500
    wi = jnp.asarray(_unit(rng, n, True))
    wo_nee = jnp.asarray(_unit(rng, n, True))
    sample2 = jnp.asarray(rng.random((n, 2)), jnp.float32)
    sample1 = jnp.asarray(rng.random(n), jnp.float32)
    slot = jnp.asarray(rng.integers(0, 2 if stacked else 1, n), jnp.int32)
    mask = jnp.asarray(rng.random(n) > 0.3)
    f_nee, pdf_nee, wo, pdf_s, weight, _ = tb.bounce_shade(
        params, wi, wo_nee, sample2, sample1, slot=slot, mask=mask,
        mask_nee=mask,
    )
    f_ref = tb.eval(params, wi, wo_nee, slot=slot, mask=mask)
    p_ref = tb.pdf(params, wi, wo_nee, slot=slot, mask=mask)
    wo_ref, p_s_ref, w_ref, _ = tb.sample(
        params, wi, sample2, sample1, slot=slot, mask=mask
    )
    v = np.asarray(mask)
    for got, want, atol in ((f_nee, f_ref, 1e-7), (pdf_nee, p_ref, 1e-7),
                            (wo, wo_ref, 1e-6), (pdf_s, p_s_ref, 1e-7),
                            (weight, w_ref, 1e-6)):
        np.testing.assert_allclose(np.asarray(got)[v], np.asarray(want)[v],
                                   rtol=1e-5, atol=atol)


# ---------------------------------------------------------------------------
# Row fetches: plain indexing is exact
# ---------------------------------------------------------------------------


def test_interaction_ids_exact_above_2048(rng):
    """Per-lane prim / material / shape ids past 2^11 come back exact
    (a one-hot product in TF32 would round them)."""
    from mitsuba_customization_tpu.render import geometry as geo
    from mitsuba_customization_tpu.render.records import Ray

    p = 5000
    p0 = rng.normal(size=(p, 3)).astype(np.float32)
    g = geo.Geometry(
        prim_type=jnp.zeros(p, jnp.int32),
        p0=jnp.asarray(p0),
        e1=jnp.asarray(np.tile([[0.1, 0, 0]], (p, 1)), jnp.float32),
        e2=jnp.asarray(np.tile([[0, 0.1, 0]], (p, 1)), jnp.float32),
        vn0=jnp.zeros((p, 3)), vn1=jnp.zeros((p, 3)), vn2=jnp.zeros((p, 3)),
        uv0=jnp.zeros((p, 2)), uv1=jnp.zeros((p, 2)), uv2=jnp.zeros((p, 2)),
        mat_id=jnp.arange(p, dtype=jnp.int32) * 3 + 1,
        emitter_id=jnp.arange(p, dtype=jnp.int32) - 7,
        shape_id=jnp.arange(p, dtype=jnp.int32) + (1 << 20),
    )
    prim = rng.integers(2048, p, 4096).astype(np.int32)
    # rays aimed at the centre of each chosen triangle
    target = p0[prim] + np.asarray([0.03, 0.03, 0.0], np.float32)
    o = target - np.asarray([0, 0, 1.0], np.float32)
    ray = Ray.make(jnp.asarray(o), jnp.tile(jnp.asarray([[0, 0, 1.0]]),
                                             (4096, 1)))
    si = geo.compute_interaction(
        g, ray, jnp.ones(4096), jnp.asarray(prim), jnp.full(4096, 0.3),
        jnp.full(4096, 0.3),
    )
    assert (np.asarray(si.prim) == prim).all()
    assert (np.asarray(si.mat_id) == prim * 3 + 1).all()
    assert (np.asarray(si.emitter) == prim - 7).all()


def test_stacked_rows_exact(rng):
    """Per-lane CDF rows of a wide stack equal numpy fancy indexing."""
    weights = rng.random((3000, 40)).astype(np.float32) + 1e-3
    dist = DiscreteDistribution.build(jnp.asarray(weights))
    idx = rng.integers(0, 3000, 5000).astype(np.int32)
    pmf, cdf = dist._rows((jnp.asarray(idx),))
    assert (np.asarray(pmf) == np.asarray(dist.pmf)[idx]).all()
    assert (np.asarray(cdf) == np.asarray(dist.cdf)[idx]).all()


# ---------------------------------------------------------------------------
# Platform plumbing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend, n_prims, requested, expected", [
    ("cpu", 12, None, "brute"),
    ("cpu", 500, None, "bvh"),
    ("gpu", 500, None, "kernel"),
    ("gpu", 500, "bvh", "bvh"),
])
def test_intersector_choice(backend, n_prims, requested, expected,
                            monkeypatch):
    from mitsuba_customization_tpu.render import scene as scene_mod

    monkeypatch.setattr(scene_mod.jax, "default_backend", lambda: backend)
    assert scene_mod._choose_intersector(requested, n_prims) == expected


def test_intersector_choice_rejects_unknown():
    from mitsuba_customization_tpu.render import scene as scene_mod

    with pytest.raises(ValueError, match="intersector"):
        scene_mod._choose_intersector("cluster", 500)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path):
    from mitsuba_customization_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", str(tmp_path))
            assert compile_cache.enable() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable()
            assert path == os.path.join(ROOT, ".jax_cache")
            assert os.path.isdir(path)
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        env=env, cwd=os.path.dirname(script), timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
