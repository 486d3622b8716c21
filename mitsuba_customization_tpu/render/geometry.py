"""Unified primitive soup (triangles + spheres + cylinders) and ray
intersection.

Counterpart of mitsuba3 src/render/{shape,mesh}.cpp and the
sphere/obj/ply/rectangle/cube shape plugins (SURVEY.md §2.3/§2.4). All
shapes flatten into per-primitive SoA arrays — denormalized, gather-friendly
— so one vectorized kernel intersects the whole scene in lock-step (the
device-resident analogue of the Embree/OptiX accel of SURVEY.md L3).

Two intersectors:
* `intersect_brute` — tests every primitive against every ray (N x P); the
  correctness reference and the fastest choice for the baseline configs'
  small scenes (SURVEY.md §7.3 item 1 'accept a test-everything fallback').
* BVH traversal lives in render/bvh.py (stackless skip links, lock-step).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.frame import Frame
from mitsuba_customization_tpu.render.records import Ray, SurfaceInteraction

TRI = 0
SPHERE = 1
CYLINDER = 2  # p0 = base point, e1 = axis vector (length = height),
              # e2[..., 0] = radius; open-ended (mitsuba3 cylinder.cpp)

_EPS = 1e-7


class Geometry(NamedTuple):
    """Primitive soup. For triangles: p0 + edge vectors e1, e2, per-vertex
    shading normals vn* and uvs. For spheres: p0 = center, e1[..., 0] =
    radius (other slots unused)."""

    prim_type: jnp.ndarray  # (P,) int32
    p0: jnp.ndarray  # (P, 3)
    e1: jnp.ndarray  # (P, 3)
    e2: jnp.ndarray  # (P, 3)
    vn0: jnp.ndarray  # (P, 3)
    vn1: jnp.ndarray  # (P, 3)
    vn2: jnp.ndarray  # (P, 3)
    uv0: jnp.ndarray  # (P, 2)
    uv1: jnp.ndarray  # (P, 2)
    uv2: jnp.ndarray  # (P, 2)
    mat_id: jnp.ndarray  # (P,) int32
    emitter_id: jnp.ndarray  # (P,) int32, -1 = not an emitter
    shape_id: jnp.ndarray  # (P,) int32

    @property
    def n_prims(self):
        return self.prim_type.shape[0]


def ray_triangle(o, d, p0, e1, e2):
    """Moller-Trumbore. Broadcasts ray (..., 3) against prims (..., 3).

    Returns (t, u, v, hit); t = inf on miss.
    """
    pvec = jnp.cross(d, e2)
    det = m.dot(e1, pvec)
    inv_det = m.safe_div(1.0, det)
    tvec = o - p0
    u = m.dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = m.dot(d, qvec) * inv_det
    t = m.dot(e2, qvec) * inv_det
    hit = (
        (jnp.abs(det) > _EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
    )
    return jnp.where(hit, t, jnp.inf), u, v, hit


def ray_cylinder(o, d, p0, axis, radius):
    """Open cylinder around the segment p0..p0+axis. Returns (t, hit).

    Mitsuba3 cylinder.cpp semantics: lateral surface only (no caps),
    nearest of the two quadratic roots whose axial coordinate lies on the
    segment.
    """
    length = jnp.maximum(m.norm(axis), 1e-12)
    a = axis / length[..., None]
    oc = o - p0
    d_par = m.dot(d, a)
    oc_par = m.dot(oc, a)
    dd = d - d_par[..., None] * a
    oo = oc - oc_par[..., None] * a
    qa = m.dot(dd, dd)
    qb = m.dot(dd, oo)
    qc = m.dot(oo, oo) - radius * radius
    disc = qb * qb - qa * qc
    sq = m.safe_sqrt(disc)
    inv_a = m.safe_div(1.0, qa)
    t0 = (-qb - sq) * inv_a
    t1 = (-qb + sq) * inv_a

    def on_seg(t):
        s = oc_par + t * d_par
        return (t > _EPS) & (s >= 0.0) & (s <= length)

    ok0 = on_seg(t0)
    ok1 = on_seg(t1)
    t = jnp.where(ok0, t0, jnp.where(ok1, t1, jnp.inf))
    hit = (disc >= 0.0) & (qa > 1e-12) & (ok0 | ok1)
    return jnp.where(hit, t, jnp.inf), hit


def ray_sphere(o, d, center, radius):
    """Stable quadratic sphere intersection. Returns (t, hit); t=inf on miss."""
    oc = o - center
    b = m.dot(oc, d)
    c = m.dot(oc, oc) - radius * radius
    disc = b * b - c
    sqrt_d = m.safe_sqrt(disc)
    t0 = -b - sqrt_d
    t1 = -b + sqrt_d
    t = jnp.where(t0 > _EPS, t0, t1)
    hit = (disc >= 0.0) & (t > _EPS)
    return jnp.where(hit, t, jnp.inf), hit


def _intersect_prims(geom: Geometry, o, d, prim_idx=None):
    """Intersect rays against (a subset of) primitives.

    o, d: (..., 3); prim data broadcast along a trailing prim axis supplied
    by the caller. Returns (t, u, v) with t=inf on miss.
    """
    g = geom if prim_idx is None else jax.tree_util.tree_map(
        lambda a: a[prim_idx], geom
    )
    t_tri, u, v, _ = ray_triangle(o, d, g.p0, g.e1, g.e2)
    t_sph, _ = ray_sphere(o, d, g.p0, g.e1[..., 0])
    t_cyl, _ = ray_cylinder(o, d, g.p0, g.e1, g.e2[..., 0])
    is_tri = g.prim_type == TRI
    is_cyl = g.prim_type == CYLINDER
    t = jnp.where(is_tri, t_tri, jnp.where(is_cyl, t_cyl, t_sph))
    return t, jnp.where(is_tri, u, 0.0), jnp.where(is_tri, v, 0.0)


def intersect_brute(geom: Geometry, ray: Ray):
    """All-pairs intersection: rays (N, 3) x prims (P,) -> nearest hit.

    Returns (t, prim, u, v): t clipped at ray.maxt (inf = miss), prim = -1
    on miss.
    """
    o = ray.o[..., None, :]  # (N, 1, 3)
    d = ray.d[..., None, :]
    t, u, v = _intersect_prims(
        geom,
        o,
        d,
        prim_idx=None,
    )  # (N, P) via broadcast
    t = jnp.where(t < ray.maxt[..., None], t, jnp.inf)
    # Masked reductions pick the first nearest prim (P is small here).
    t_best = jnp.min(t, axis=-1)
    p_count = t.shape[-1]
    iota = jax.lax.broadcasted_iota(jnp.int32, t.shape, t.ndim - 1)
    is_best = t == t_best[..., None]
    big = jnp.int32(2**30)
    best = jnp.min(jnp.where(is_best, iota, big), axis=-1)
    first = iota == best[..., None]
    u_best = jnp.sum(jnp.where(first, u, 0.0), axis=-1)
    v_best = jnp.sum(jnp.where(first, v, 0.0), axis=-1)
    prim = jnp.where(jnp.isinf(t_best), -1, jnp.minimum(best, p_count - 1))
    return t_best, prim, u_best, v_best


def occluded_brute(geom: Geometry, ray: Ray):
    """Shadow-ray test: any hit with t < maxt (Scene::ray_test)."""
    o = ray.o[..., None, :]
    d = ray.d[..., None, :]
    t, _, _ = _intersect_prims(geom, o, d)
    return jnp.any(t < ray.maxt[..., None], axis=-1)


def compute_interaction(geom: Geometry, ray: Ray, t, prim, u, v):
    """Build the SurfaceInteraction for nearest hits (compute_surface_
    interaction analogue — mitsuba3 PreliminaryIntersection3f)."""
    safe = jnp.maximum(prim, 0)
    g = jax.tree_util.tree_map(lambda a: a[safe], geom)
    valid = prim >= 0

    p = ray.o + ray.d * jnp.where(valid, t, 0.0)[..., None]

    is_tri = g.prim_type == TRI
    is_cyl = g.prim_type == CYLINDER
    # Triangle geometric normal from the edges; sphere from center;
    # cylinder radial about its axis.
    n_tri = m.normalize(jnp.cross(g.e1, g.e2))
    radius = jnp.maximum(g.e1[..., 0:1], 1e-12)
    n_sph = (p - g.p0) / radius
    cyl_len = jnp.maximum(m.norm(g.e1), 1e-12)
    cyl_a = g.e1 / cyl_len[..., None]
    pl = p - g.p0
    cyl_s = m.dot(pl, cyl_a)
    n_cyl = m.normalize(pl - cyl_s[..., None] * cyl_a)
    n_geo = jnp.where(
        is_tri[..., None], n_tri,
        jnp.where(is_cyl[..., None], n_cyl, n_sph),
    )

    # Shading normal: interpolated vertex normals (falls back to geometric
    # when a mesh carries none — scene build stores n_geo in vn*).
    w = (1.0 - u - v)[..., None]
    n_sh = m.normalize(
        jnp.where(
            is_tri[..., None],
            w * g.vn0 + u[..., None] * g.vn1 + v[..., None] * g.vn2,
            jnp.where(is_cyl[..., None], n_cyl, n_sph),
        )
    )
    # Flip the *shading* frame to the side the ray arrived from (two-sided
    # shading). si.n keeps the authored geometric orientation — emitter
    # front-face logic needs it (render/emitters.py eval_hit).
    facing = m.dot(n_geo, ray.d) < 0.0
    n_sh = jnp.where(facing[..., None], n_sh, -n_sh)

    uv_tri = w * g.uv0 + u[..., None] * g.uv1 + v[..., None] * g.uv2
    theta, phi = m.dir_to_sph(n_sph)
    uv_sph = jnp.stack(
        [phi / (2.0 * jnp.pi) + 0.5, theta / jnp.pi], axis=-1
    )
    cyl_frame = Frame.from_normal(cyl_a)
    phi_cyl = jnp.arctan2(
        m.dot(pl, cyl_frame.s), m.dot(pl, cyl_frame.t)
    )
    uv_cyl = jnp.stack(
        [phi_cyl / (2.0 * jnp.pi) + 0.5, cyl_s / cyl_len], axis=-1
    )
    uv = jnp.where(
        is_tri[..., None], uv_tri,
        jnp.where(is_cyl[..., None], uv_cyl, uv_sph),
    )

    frame = Frame.from_normal(n_sh)
    wi_local = frame.to_local(-ray.d)

    return SurfaceInteraction(
        valid=valid,
        t=t,
        p=p,
        n=n_geo,
        frame=frame,
        uv=uv,
        wi=wi_local,
        prim=jnp.where(valid, prim, -1),
        mat_id=jnp.where(valid, g.mat_id, 0),
        emitter=jnp.where(valid, g.emitter_id, -1),
        bary=jnp.where(
            (valid & is_tri)[..., None],
            jnp.stack([u, v], axis=-1), 0.0,
        ),
    )


def spawn_ray(si: SurfaceInteraction, d_world):
    """Offset a secondary ray origin along the geometric normal to avoid
    self-intersection (mitsuba3 si.spawn_ray)."""
    sign = jnp.where(m.dot(d_world, si.n) >= 0.0, 1.0, -1.0)
    scale = m.RAY_EPSILON * (1.0 + jnp.max(jnp.abs(si.p), axis=-1))
    o = si.p + (sign * scale)[..., None] * si.n
    return Ray.make(o, d_world)


def aabbs(geom: Geometry):
    """Per-primitive AABBs (numpy-friendly; used by the BVH builder)."""
    is_tri = geom.prim_type == TRI
    is_cyl = geom.prim_type == CYLINDER
    p1 = geom.p0 + geom.e1
    p2 = geom.p0 + geom.e2
    tri_min = jnp.minimum(geom.p0, jnp.minimum(p1, p2))
    tri_max = jnp.maximum(geom.p0, jnp.maximum(p1, p2))
    r = geom.e1[..., 0:1]
    sph_min = geom.p0 - r
    sph_max = geom.p0 + r
    rc = geom.e2[..., 0:1]
    cyl_min = jnp.minimum(geom.p0, p1) - rc
    cyl_max = jnp.maximum(geom.p0, p1) + rc
    bb_min = jnp.where(
        is_tri[..., None], tri_min,
        jnp.where(is_cyl[..., None], cyl_min, sph_min),
    )
    bb_max = jnp.where(
        is_tri[..., None], tri_max,
        jnp.where(is_cyl[..., None], cyl_max, sph_max),
    )
    return bb_min, bb_max

