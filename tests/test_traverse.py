"""BVH traversal (render/bvh.py and the ops/traverse.py kernel) vs brute
force, and the load-time choice of intersector.

The kernel's CUDA source also builds for the host with g++, so its
arithmetic runs here on the CPU; the all-pairs intersector
(render/geometry.py) is the oracle — the same gate render/bvh.py passes
(SURVEY.md §4.1: scalar variant as the de-facto reference backend).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mitsuba_customization_tpu.ops import traverse
from mitsuba_customization_tpu.render import bvh as bvh_mod
from mitsuba_customization_tpu.render import geometry as geo
from mitsuba_customization_tpu.render.records import Ray
from mitsuba_customization_tpu.utils.meshgen import (
    icosphere_blob,
    vertex_normals,
)

INTERSECT = {"bvh": bvh_mod.intersect, "kernel": traverse.intersect}
OCCLUDED = {"bvh": bvh_mod.occluded, "kernel": traverse.occluded}
N_RAYS = 2048


def _mesh_geometry(n_sub=2, extra_analytic=False):
    v, f = icosphere_blob(n_sub=n_sub)
    vn = vertex_normals(v, f)
    p = f.shape[0]
    rng = np.random.RandomState(3)
    g = dict(
        prim_type=np.zeros(p, np.int32),
        p0=v[f[:, 0]],
        e1=v[f[:, 1]] - v[f[:, 0]],
        e2=v[f[:, 2]] - v[f[:, 0]],
        vn0=vn[f[:, 0]], vn1=vn[f[:, 1]], vn2=vn[f[:, 2]],
        uv0=rng.rand(p, 2).astype(np.float32),
        uv1=rng.rand(p, 2).astype(np.float32),
        uv2=rng.rand(p, 2).astype(np.float32),
        mat_id=(np.arange(p) % 5).astype(np.int32),
        emitter_id=np.where(np.arange(p) % 17 == 0, 1, -1).astype(np.int32),
        shape_id=(np.arange(p) % 3).astype(np.int32),
    )
    if extra_analytic:
        # append a sphere and a cylinder primitive
        def add(prim_type, p0, e1, e2):
            g["prim_type"] = np.concatenate(
                [g["prim_type"], [np.int32(prim_type)]]
            )
            for k, val in (("p0", p0), ("e1", e1), ("e2", e2)):
                g[k] = np.concatenate([g[k], np.asarray([val], np.float32)])
            for k in ("vn0", "vn1", "vn2"):
                g[k] = np.concatenate([g[k], [[0, 0, 1]]]).astype(np.float32)
            for k in ("uv0", "uv1", "uv2"):
                g[k] = np.concatenate([g[k], [[0, 0]]]).astype(np.float32)
            for k in ("mat_id", "shape_id"):
                g[k] = np.concatenate([g[k], [0]]).astype(np.int32)
            g["emitter_id"] = np.concatenate(
                [g["emitter_id"], [-1]]
            ).astype(np.int32)

        add(geo.SPHERE, [2.0, 0.3, 0.1], [0.7, 0, 0], [0, 0, 0])
        add(geo.CYLINDER, [-2.0, -1.0, 0.0], [0.0, 2.0, 0.0], [0.5, 0, 0])
    return geo.Geometry(**{k: jnp.asarray(val) for k, val in g.items()})


def _rays(n, seed=0, aim_frac=0.5):
    rng = np.random.RandomState(seed)
    o = (
        np.tile(np.asarray([[0, 0, -4.0]], np.float32), (n, 1))
        + rng.randn(n, 3).astype(np.float32) * 0.4
    )
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    k = int(n * aim_frac)
    d[:k] = -o[:k] + rng.randn(k, 3) * 0.5
    d[:k] /= np.linalg.norm(d[:k], axis=-1, keepdims=True)
    return Ray.make(jnp.asarray(o), jnp.asarray(d))


@pytest.fixture(scope="module")
def analytic_scene():
    g = _mesh_geometry(n_sub=2, extra_analytic=True)
    return g, bvh_mod.build(g)


@pytest.mark.parametrize("name", ["bvh", "kernel"])
def test_closest_matches_brute(name, analytic_scene):
    g, tree = analytic_scene
    ray = _rays(N_RAYS)
    t, prim, u, v = map(np.asarray, jax.jit(INTERSECT[name])(tree, g, ray))
    tb, pb, ub, vb = map(np.asarray, geo.intersect_brute(g, ray))
    assert ((prim >= 0) == (pb >= 0)).all()
    assert (prim >= 0).mean() > 0.3
    m = prim >= 0
    assert np.allclose(t[m], tb[m], rtol=1e-4, atol=1e-5)
    assert np.isinf(t[~m]).all()
    # ties on shared mesh edges may pick either prim; t equality is the
    # correctness statement, prim agreement the common case
    assert (prim[m] == pb[m]).mean() > 0.99
    assert (prim == g.n_prims - 1).any() or (prim == g.n_prims - 2).any()
    same = m & (prim == pb)
    assert np.allclose(u[same], ub[same], atol=2e-4)
    assert np.allclose(v[same], vb[same], atol=2e-4)


@pytest.mark.parametrize("name", ["bvh", "kernel"])
def test_interaction_fields_match_geometry_rows(name, analytic_scene):
    g, tree = analytic_scene
    ray = _rays(N_RAYS, seed=5)
    t, prim, u, v = INTERSECT[name](tree, g, ray)
    si = geo.compute_interaction(g, ray, t, prim, u, v)
    tb, pb, ub, vb = geo.intersect_brute(g, ray)
    ref = geo.compute_interaction(g, ray, tb, pb, ub, vb)
    same = np.asarray(prim == pb)
    assert same.mean() > 0.99
    for field in ("valid", "prim", "mat_id", "emitter"):
        assert (np.asarray(getattr(si, field))[same]
                == np.asarray(getattr(ref, field))[same]).all(), field
    hit = same & np.asarray(ref.valid)
    assert hit.mean() > 0.3
    for field in ("p", "n", "uv"):
        assert np.allclose(np.asarray(getattr(si, field))[hit],
                           np.asarray(getattr(ref, field))[hit],
                           atol=2e-4), field


@pytest.mark.parametrize("name", ["bvh", "kernel"])
def test_occluded_and_maxt(name, analytic_scene):
    g, tree = analytic_scene
    ray = _rays(N_RAYS, seed=9)
    # finite maxt: clip half the rays just before their brute-force hit
    tb, _, _, _ = geo.intersect_brute(g, ray)
    tb = np.asarray(tb)
    capped = np.isfinite(tb) & (np.arange(N_RAYS) % 2 == 0)
    maxt = np.where(capped, tb * 0.5, 1e30).astype(np.float32)
    ray2 = Ray(o=ray.o, d=ray.d, maxt=jnp.asarray(maxt))
    occ = np.asarray(OCCLUDED[name](tree, g, ray2))
    occ_ref = np.asarray(geo.occluded_brute(g, ray2))
    assert (occ == occ_ref).all()
    assert occ.any() and not occ.all()
    # closest-hit with capped maxt: capped lanes must miss
    _, p2, _, _ = INTERSECT[name](tree, g, ray2)
    assert (np.asarray(p2)[capped] == -1).all()


def test_kernel_batch_shapes_and_dead_lanes(analytic_scene):
    """The wrapper flattens any leading lane shape, broadcasts a scalar
    maxt, and a lane with maxt = 0 misses at once."""
    g, tree = analytic_scene
    ray = _rays(4 * 300, seed=2)
    ref = bvh_mod.intersect(tree, g, ray)
    ray2 = Ray(o=ray.o.reshape(4, 300, 3), d=ray.d.reshape(4, 300, 3),
               maxt=jnp.float32(jnp.inf))
    out = traverse.intersect(tree, g, ray2)
    assert [o.shape for o in out] == [(4, 300)] * 4
    assert out[1].dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(out[1]).reshape(-1),
                                  np.asarray(ref[1]))
    occ = traverse.occluded(tree, g, ray2)
    assert occ.shape == (4, 300) and occ.dtype == jnp.bool_
    dead = Ray(o=ray.o, d=ray.d, maxt=jnp.zeros(1200))
    t, prim, _, _ = traverse.intersect(tree, g, dead)
    assert (np.asarray(prim) == -1).all() and np.isinf(np.asarray(t)).all()
    assert not np.asarray(traverse.occluded(tree, g, dead)).any()


def _blob_scene(n_sub, intersector=None):
    import mitsuba_customization_tpu as mct

    v, f = icosphere_blob(n_sub=n_sub)
    return mct.load_dict(
        {
            "type": "scene",
            "integrator": {"type": "path", "max_depth": 2,
                           "intersector": intersector},
            "sensor": {
                "type": "perspective",
                "film": {"width": 8, "height": 8},
            },
            "blob": {"type": "mesh", "vertices": v, "faces": f,
                     "bsdf": {"type": "diffuse"}},
            "sky": {"type": "constant", "radiance": [1, 1, 1]},
        }
    )


def test_intersector_selection_by_size_and_platform():
    """Scenes up to BRUTE_FORCE_MAX_PRIMS test all pairs; larger ones get
    a BVH, walked by JAX on the CPU (the kernel on a GPU)."""
    from mitsuba_customization_tpu.render.scene import BRUTE_FORCE_MAX_PRIMS

    small = _blob_scene(0)  # 20 faces
    assert small.geometry.n_prims <= BRUTE_FORCE_MAX_PRIMS
    assert small.config.intersector == "brute"
    big = _blob_scene(2)  # 320 faces
    assert big.config.intersector == (
        "kernel" if jax.default_backend() == "gpu" else "bvh"
    )
    assert big.bvh.n_nodes > 1


def test_explicit_kernel_renders_like_bvh():
    from mitsuba_customization_tpu.render.integrator import render_jit

    a = np.asarray(render_jit(_blob_scene(2, "bvh"), spp=2, seed=0))
    b = np.asarray(render_jit(_blob_scene(2, "kernel"), spp=2, seed=0))
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_kernel_on_card_matches_bvh(gpu_device, analytic_scene):
    """The CUDA build on the card (chip_smoke.py phase `kernels` runs the
    same comparison at 2^21 rays on the matpreview mesh)."""
    g, tree = jax.device_put(analytic_scene, gpu_device)
    ray = jax.device_put(_rays(N_RAYS, seed=11), gpu_device)
    _, pk, _, _ = traverse.intersect(tree, g, ray)
    _, pb, _, _ = bvh_mod.intersect(tree, g, ray)
    assert (np.asarray(pk) == np.asarray(pb)).mean() > 0.999
