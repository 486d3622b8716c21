"""Emitters: area, constant, envmap, point, spot, directional,
directionalarea, projector.

Counterpart of mitsuba3 src/emitters/ (SURVEY.md §2.4) plus the
scene-level emitter sampling of src/render/scene.cpp
(Scene::sample_emitter_direction / pdf_emitter_direction — SURVEY.md §2.3).
Same masked static dispatch as the BSDF table (SURVEY.md §7.1): emitter
types are a fixed enum, lanes select an emitter from a discrete
distribution, each present type evaluates under a mask.

Area emitters reference emissive primitives in the scene Geometry. All
emissive prims live in one global array `em_prims` (Q,); each area emitter
owns a pmf row over it (zero outside its own prims), so prim selection is
one CDF inversion regardless of which emitter a lane picked.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.distr import DiscreteDistribution, Marginal2D
from mitsuba_customization_tpu.core.spectrum import luminance
from mitsuba_customization_tpu.core.warp import (
    square_to_uniform_sphere,
    square_to_uniform_triangle,
)
from mitsuba_customization_tpu.render import geometry as geo
from mitsuba_customization_tpu.render.records import DirectionSample

AREA = 0
CONSTANT = 1
ENVMAP = 2
POINT = 3
SPOT = 4
DIRECTIONAL = 5
DIRECTIONALAREA = 6   # collimated area source (mitsuba3 directionalarea.cpp)
PROJECTOR = 7         # textured perspective point source (projector.cpp)

DELTA_EMITTERS = (POINT, SPOT, DIRECTIONAL, DIRECTIONALAREA, PROJECTOR)

INV_FOUR_PI = 1.0 / (4.0 * jnp.pi)


class EmitterTable(NamedTuple):
    """All emitters of a scene (K emitters, Q emissive prims).

    radiance doubles as: area/constant/envmap scale -> radiance, point/spot
    -> intensity, directional -> irradiance.
    """

    em_type: jnp.ndarray  # (K,) int32
    select: DiscreteDistribution  # over K emitters
    radiance: jnp.ndarray  # (K, 3)
    position: jnp.ndarray  # (K, 3) point/spot
    direction: jnp.ndarray  # (K, 3) spot/directional (unit, pointing away)
    cutoff_cos: jnp.ndarray  # (K,) spot outer cone
    beam_cos: jnp.ndarray  # (K,) spot inner cone
    prim_dist: DiscreteDistribution  # (K, Q) per-emitter pmf over em_prims
    em_prims: jnp.ndarray  # (Q,) int32 prim ids (>=1, padded with 0)
    prim_area: jnp.ndarray  # (Q,) surface areas
    prim_to_q: jnp.ndarray  # (P,) prim id -> q index or -1
    env_image: jnp.ndarray  # (H, W, 3) envmap bitmap (1x1 zeros if none)
    env_dist: Marginal2D  # over env pixels (luminance * sin theta)
    env_to_world: jnp.ndarray  # (3, 3) rotation
    env_index: jnp.ndarray  # () int32: emitter id of the envmap, -1 if none
    background_index: jnp.ndarray  # () int32: constant emitter id, -1 if none
    em_prim_emitter: jnp.ndarray = None  # (Q,) int32 owning emitter per q
    proj_image: jnp.ndarray = None  # (H, W, 3) projector texture (1x1 if none)
    proj_to_world: jnp.ndarray = None  # (3, 3) columns = right/up/forward
    proj_tan: jnp.ndarray = None  # () tan(fov_x / 2)
    proj_index: jnp.ndarray = None  # () int32 projector emitter id, -1 none
    # Compact (Q,)-row copy of the emissive prims' Geometry: NEE position
    # sampling gathers from these Q rows instead of the full P-prim soup.
    em_geom: object = None

    @property
    def n_emitters(self):
        return self.em_type.shape[0]


# --------------------------------------------------------------------------
# Helpers: per-primitive area sampling
# --------------------------------------------------------------------------


def prim_surface_area(geom: geo.Geometry, prim):
    g = jax.tree_util.tree_map(lambda a: a[prim], geom)
    tri_area = 0.5 * m.norm(jnp.cross(g.e1, g.e2))
    sph_area = 4.0 * jnp.pi * g.e1[..., 0] ** 2
    cyl_area = 2.0 * jnp.pi * g.e2[..., 0] * m.norm(g.e1)
    return jnp.where(
        g.prim_type == geo.TRI, tri_area,
        jnp.where(g.prim_type == geo.CYLINDER, cyl_area, sph_area),
    )


def _sample_position_on_prim(geom: geo.Geometry, prim, sample2):
    """Uniform-area point + outward normal on a primitive."""
    g = jax.tree_util.tree_map(lambda a: a[prim], geom)
    # Triangle: uniform barycentric.
    b = square_to_uniform_triangle(sample2)
    p_tri = g.p0 + b[..., 0:1] * g.e1 + b[..., 1:2] * g.e2
    n_tri = m.normalize(jnp.cross(g.e1, g.e2))
    # Sphere: uniform on the surface.
    d = square_to_uniform_sphere(sample2)
    r = g.e1[..., 0:1]
    p_sph = g.p0 + r * d
    # Cylinder: uniform on the lateral surface.
    from mitsuba_customization_tpu.core.frame import Frame

    cyl_len = jnp.maximum(m.norm(g.e1), 1e-12)
    cyl_a = g.e1 / cyl_len[..., None]
    fr = Frame.from_normal(cyl_a)
    phi = 2.0 * jnp.pi * sample2[..., 0]
    n_cyl = (
        jnp.cos(phi)[..., None] * fr.s + jnp.sin(phi)[..., None] * fr.t
    )
    p_cyl = (
        g.p0
        + (sample2[..., 1] * cyl_len)[..., None] * cyl_a
        + g.e2[..., 0:1] * n_cyl
    )
    is_tri = (g.prim_type == geo.TRI)[..., None]
    is_cyl = (g.prim_type == geo.CYLINDER)[..., None]
    p = jnp.where(is_tri, p_tri, jnp.where(is_cyl, p_cyl, p_sph))
    n = jnp.where(is_tri, n_tri, jnp.where(is_cyl, n_cyl, d))
    return p, n


# --------------------------------------------------------------------------
# Envmap helpers
# --------------------------------------------------------------------------


def build_env_distribution(image):
    """Luminance * sin(theta) Marginal2D over a lat-long envmap."""
    h = image.shape[0]
    theta = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h * jnp.pi
    w = luminance(image) * jnp.sin(theta)[:, None]
    return Marginal2D.build(w)


def _env_dir_from_uv(uv, to_world):
    """uv (..., 2) = (y=theta, x=phi) unit square -> world direction."""
    theta = uv[..., 0] * jnp.pi
    phi = uv[..., 1] * 2.0 * jnp.pi - jnp.pi
    d_local = m.sph_to_dir(theta, phi)
    return m.matvec(to_world, d_local)


def _env_uv_from_dir(d_world, to_world):
    d = m.vecmat(d_world, to_world)  # inverse of rotation = transpose
    theta, phi = m.dir_to_sph(d)
    return jnp.stack(
        [theta / jnp.pi, (phi + jnp.pi) / (2.0 * jnp.pi)], axis=-1
    )


def env_radiance(table: EmitterTable, d_world):
    """Bilinear lookup of the envmap in direction d (world)."""
    img = table.env_image
    h, w = img.shape[0], img.shape[1]
    uv = _env_uv_from_dir(d_world, table.env_to_world)
    y = jnp.clip(uv[..., 0] * h - 0.5, 0.0, h - 1.0)
    x = uv[..., 1] * w - 0.5
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    y0 = jnp.clip(y0, 0, h - 1)
    x0w = jnp.mod(x0, w)
    x1w = jnp.mod(x0 + 1, w)
    c00, c01 = img[y0, x0w], img[y0, x1w]
    c10, c11 = img[y1, x0w], img[y1, x1w]
    return (
        (c00 * (1 - fx) + c01 * fx) * (1 - fy)
        + (c10 * (1 - fx) + c11 * fx) * fy
    )


def _env_pdf(table: EmitterTable, d_world):
    """Solid-angle pdf of envmap importance sampling in direction d."""
    uv = _env_uv_from_dir(d_world, table.env_to_world)
    p_sq = table.env_dist.eval_pdf(uv)
    sin_theta = jnp.sin(uv[..., 0] * jnp.pi)
    # d(omega) = 2 pi^2 sin(theta) du dv  (u = theta/pi, v = phi/2pi)
    return m.safe_div(p_sq, 2.0 * jnp.pi * jnp.pi * sin_theta)


# --------------------------------------------------------------------------
# Scene-level emitter sampling (NEE)
# --------------------------------------------------------------------------


def sample_direction(
    table: EmitterTable, geom: geo.Geometry, p_ref, sample3
) -> DirectionSample:
    """Scene::sample_emitter_direction — pick an emitter, sample a direction
    toward it, return radiance/pdf in solid angle at p_ref.

    sample3: (..., 3) uniforms (emitter select via reuse + 2-D position).
    """
    k, u0 = table.select.sample_reuse(sample3[..., 0])
    u2 = jnp.stack([u0, sample3[..., 1]], axis=-1)
    u_pos = sample3[..., 1:3]
    et = table.em_type[k]
    sel_pmf = table.select.eval_pmf(k)

    out_d = jnp.zeros(p_ref.shape)
    out_dist = jnp.full(p_ref.shape[:-1], jnp.inf)
    out_pdf = jnp.zeros(p_ref.shape[:-1])
    out_rad = jnp.zeros(p_ref.shape)
    out_delta = jnp.zeros(p_ref.shape[:-1], dtype=bool)

    def put(mask, d, dist, pdf, rad, delta):
        nonlocal out_d, out_dist, out_pdf, out_rad, out_delta
        out_d = jnp.where(mask[..., None], d, out_d)
        out_dist = jnp.where(mask, dist, out_dist)
        out_pdf = jnp.where(mask, pdf * sel_pmf, out_pdf)
        out_rad = jnp.where(mask[..., None], rad, out_rad)
        out_delta = jnp.where(mask, delta, out_delta)

    out_p_area = jnp.zeros(p_ref.shape[:-1])

    # ---- area ----
    mask_area = et == AREA
    q, _ = table.prim_dist.sample_reuse(u2[..., 0], slice_=(k,))
    if table.em_geom is not None:
        x, n_e = _sample_position_on_prim(table.em_geom, q, u_pos)
    else:
        prim = table.em_prims[q]
        x, n_e = _sample_position_on_prim(geom, prim, u_pos)
    to_x = x - p_ref
    dist2 = m.squared_norm(to_x)
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-12))
    d = to_x / dist[..., None]
    cos_e = m.dot(n_e, -d)
    pmf_q = table.prim_dist.eval_pmf(q, slice_=(k,))
    p_area = m.safe_div(pmf_q, table.prim_area[q])
    pdf_sa = m.safe_div(p_area * dist2, cos_e)
    front = cos_e > 0.0
    rad = jnp.where(
        front[..., None], table.radiance[k], 0.0
    )
    put(
        mask_area,
        d,
        dist,
        jnp.where(front, pdf_sa, 0.0),
        rad,
        jnp.zeros_like(front),
    )
    out_p_area = jnp.where(
        mask_area & front, p_area * sel_pmf, out_p_area
    )

    # ---- constant ----
    mask_const = et == CONSTANT
    d_c = square_to_uniform_sphere(u2)
    put(
        mask_const,
        d_c,
        jnp.full(dist.shape, jnp.inf),
        jnp.full(dist.shape, INV_FOUR_PI),
        table.radiance[k],
        jnp.zeros_like(mask_const),
    )

    # ---- envmap (structurally gated: a real envmap has > 1 texel) ----
    if table.env_image.size > 3:
        mask_env = et == ENVMAP
        uv_e, p_sq = table.env_dist.sample(u2)
        d_e = _env_dir_from_uv(uv_e, table.env_to_world)
        sin_t = jnp.sin(uv_e[..., 0] * jnp.pi)
        pdf_e = m.safe_div(p_sq, 2.0 * jnp.pi * jnp.pi * sin_t)
        rad_e = env_radiance(table, d_e) * table.radiance[k]
        put(
            mask_env,
            d_e,
            jnp.full(dist.shape, jnp.inf),
            pdf_e,
            rad_e,
            jnp.zeros_like(mask_env),
        )

    # ---- point ----
    mask_point = et == POINT
    to_p = table.position[k] - p_ref
    pdist2 = m.squared_norm(to_p)
    pdist = jnp.sqrt(jnp.maximum(pdist2, 1e-12))
    d_p = to_p / pdist[..., None]
    rad_p = table.radiance[k] / pdist2[..., None]
    put(
        mask_point,
        d_p,
        pdist,
        jnp.ones_like(pdist),
        rad_p,
        jnp.ones_like(mask_point),
    )

    # ---- spot ----
    mask_spot = et == SPOT
    cos_spot = m.dot(table.direction[k], -d_p)
    falloff = jnp.clip(
        m.safe_div(
            cos_spot - table.cutoff_cos[k],
            table.beam_cos[k] - table.cutoff_cos[k],
        ),
        0.0,
        1.0,
    )
    rad_s = rad_p * falloff[..., None]
    put(
        mask_spot,
        d_p,
        pdist,
        jnp.ones_like(pdist),
        rad_s,
        jnp.ones_like(mask_spot),
    )

    # ---- directional ----
    mask_dir = et == DIRECTIONAL
    d_d = -table.direction[k]
    put(
        mask_dir,
        jnp.broadcast_to(d_d, p_ref.shape),
        jnp.full(dist.shape, jnp.inf),
        jnp.ones_like(dist),
        table.radiance[k],
        jnp.ones_like(mask_dir),
    )

    # ---- directionalarea (collimated area source) ----
    # Emits only along the authored surface normal; from p_ref the light
    # arrives from d = -n_em iff p_ref projects onto the emitting surface
    # along n_em (planar/mesh emitter shapes — scene build stores the
    # mean authored prim normal in `direction`).
    mask_da = et == DIRECTIONALAREA
    if table.em_prim_emitter is not None:
        d_da = -table.direction[k]
        geom_q = jax.tree_util.tree_map(
            lambda a: a[table.em_prims], geom
        )
        t_q, _, _ = geo._intersect_prims(
            geom_q, p_ref[..., None, :], d_da[..., None, :]
        )
        owned = table.em_prim_emitter[None, :] == k[..., None]
        t_q = jnp.where(owned, t_q, jnp.inf)
        t_hit = jnp.min(t_q, axis=-1)
        on_beam = jnp.isfinite(t_hit)
        put(
            mask_da,
            d_da,
            jnp.where(on_beam, t_hit, jnp.inf),
            jnp.where(on_beam, 1.0, 0.0),
            table.radiance[k],
            jnp.ones_like(mask_da),
        )

    # ---- projector (textured perspective point source) ----
    mask_proj = et == PROJECTOR
    if table.proj_index is not None:
        # direction/distance identical to the point branch (d_p, pdist)
        dl = m.vecmat(-d_p, table.proj_to_world)  # local: x right, y up, z fwd
        z = jnp.maximum(dl[..., 2], 1e-12)
        x = dl[..., 0] / z
        y = dl[..., 1] / z
        img = table.proj_image
        aspect = img.shape[1] / img.shape[0]
        tx = table.proj_tan
        ty = tx / aspect
        inside = (dl[..., 2] > 0) & (jnp.abs(x) <= tx) & (jnp.abs(y) <= ty)
        uv = jnp.stack(
            [0.5 - y / ty * 0.5, x / tx * 0.5 + 0.5], axis=-1
        )  # (row from top, col)
        tex = _bilinear_lookup(img, uv)
        rad_pr = (
            tex * table.radiance[k] / pdist2[..., None]
            * inside[..., None]
        )
        put(
            mask_proj,
            d_p,
            pdist,
            jnp.ones_like(pdist),
            rad_pr,
            jnp.ones_like(mask_proj),
        )

    return DirectionSample(
        d=out_d, dist=out_dist, pdf=out_pdf, radiance=out_rad,
        delta=out_delta, p_area=out_p_area,
    )


def _bilinear_lookup(img, uv):
    """uv (..., 2) = (row in [0,1], col in [0,1]) clamped bilinear fetch."""
    h, w = img.shape[0], img.shape[1]
    y = jnp.clip(uv[..., 0] * h - 0.5, 0.0, h - 1.0)
    x = jnp.clip(uv[..., 1] * w - 0.5, 0.0, w - 1.0)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    c00, c01 = img[y0, x0], img[y0, x1]
    c10, c11 = img[y1, x0], img[y1, x1]
    return (
        (c00 * (1 - fx) + c01 * fx) * (1 - fy)
        + (c10 * (1 - fx) + c11 * fx) * fy
    )


def _q_of_prim(table: EmitterTable, prim):
    """q index (row in em_prims / em_geom) of a hit emissive prim.

    em_prims is built sorted ascending (scene compile appends shapes in
    prim order), so q is the rank of `prim` among em_prims — a broadcast
    compare+reduce of ~Q vector ops per lane. Falls back to the (P,)-entry
    prim_to_q gather for very large Q. Only valid
    on lanes where si.emitter >= 0 (callers mask)."""
    Q = table.em_prims.shape[0]
    if Q <= 1024:
        le = table.em_prims[None, :] <= prim[..., None]
        return jnp.clip(jnp.sum(le.astype(jnp.int32), axis=-1) - 1, 0, Q - 1)
    return jnp.maximum(table.prim_to_q[jnp.maximum(prim, 0)], 0)


def pdf_hit_direction(table: EmitterTable, geom: geo.Geometry, si, p_ref):
    """pdf_emitter_direction for a BSDF ray that *hit* emissive prim si.prim
    — the MIS denominator for area lights (SURVEY.md §3.1)."""
    qs = _q_of_prim(table, si.prim)
    valid = (si.prim >= 0) & (si.emitter >= 0)
    em = jnp.maximum(si.emitter, 0)
    pmf_q = table.prim_dist.eval_pmf(qs, slice_=(em,))
    sel = table.select.eval_pmf(em)
    to_x = si.p - p_ref
    dist2 = m.squared_norm(to_x)
    d = to_x * m.safe_rsqrt(dist2)[..., None]
    cos_e = m.dot(si.n, -d)
    pdf_sa = m.safe_div(
        pmf_q / jnp.maximum(table.prim_area[qs], 1e-12) * dist2,
        cos_e,
    )
    return jnp.where(valid & (cos_e > 0), sel * pdf_sa, 0.0)


def pdf_hit_area(table: EmitterTable, si):
    """Area-measure density of NEE / light-path emission sampling picking
    the surface point si.p on the hit emissive prim: sel_pmf * prim_pmf /
    prim_area (0 for non-emitter hits). The BDPT MIS ratios compare
    strategy densities in the area product measure (render/bdpt.py)."""
    qs = _q_of_prim(table, si.prim)
    valid = (si.prim >= 0) & (si.emitter >= 0)
    em = jnp.maximum(si.emitter, 0)
    pmf_q = table.prim_dist.eval_pmf(qs, slice_=(em,))
    sel = table.select.eval_pmf(em)
    p = sel * pmf_q / jnp.maximum(table.prim_area[qs], 1e-12)
    return jnp.where(valid, p, 0.0)


def pdf_miss_direction(table: EmitterTable, d_world):
    """pdf_emitter_direction for a BSDF ray that escaped (env emitters)."""
    p = jnp.zeros(d_world.shape[:-1])
    has_const = table.background_index >= 0
    const_sel = table.select.eval_pmf(jnp.maximum(table.background_index, 0))
    p = p + jnp.where(has_const, const_sel * INV_FOUR_PI, 0.0)
    if table.env_image.size > 3:
        has_env = table.env_index >= 0
        env_sel = table.select.eval_pmf(jnp.maximum(table.env_index, 0))
        p = p + jnp.where(has_env, env_sel * _env_pdf(table, d_world), 0.0)
    return p


def eval_background(table: EmitterTable, d_world):
    """Radiance carried by escaped rays (constant + envmap emitters)."""
    rad = jnp.zeros(d_world.shape)
    has_const = table.background_index >= 0
    bi = jnp.maximum(table.background_index, 0)
    rad = rad + jnp.where(has_const, table.radiance[bi], 0.0)
    if table.env_image.size > 3:
        has_env = table.env_index >= 0
        ei = jnp.maximum(table.env_index, 0)
        rad = rad + jnp.where(
            has_env, env_radiance(table, d_world) * table.radiance[ei], 0.0
        )
    return rad


def eval_hit(table: EmitterTable, si):
    """Radiance emitted by a surface hit toward the ray origin (area
    emitters; front side only)."""
    valid = si.emitter >= 0
    em = jnp.maximum(si.emitter, 0)
    # Front face: authored geometric normal points back toward the ray
    # origin (si.n is unflipped; to_world(si.wi) points toward the origin).
    front = m.dot(si.n, si.to_world(si.wi)) > 0.0
    # only area emitters emit from surfaces
    is_area = table.em_type[em] == AREA
    return jnp.where(
        (valid & front & is_area)[..., None], table.radiance[em], 0.0
    )
