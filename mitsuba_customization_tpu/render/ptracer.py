"""Particle (light) tracer — `ptracer` integrator.

Counterpart of mitsuba3 src/integrators/ptracer.cpp (SURVEY.md
§2.4 integrators row; the natural first member of the 0.6 `libbidir`
family, round-3 verdict item 5). Paths start on emitters, scatter through
the scene, and every vertex splats a camera connection onto the film
through the existing `film.splat` machinery — the adjoint image-formation
direction of the backward path tracer.

Estimator (pinhole perspective sensor, film plane at z=1):

    I_pix = (1/A_pix) integral_dirs-in-pix L(omega) / cos^3(theta) domega
          = (1/A_pix) integral_surf L_o(x->cam) cos(theta_x)/(r^2 cos^3) dA

so a particle with power-throughput beta at vertex x contributes
    beta * f(x, w_i -> w_cam) * cos(theta_x) / (r^2 cos^3(theta) A_film)
to the pixel x projects to, and the film divides by paths-per-pixel
(spp) at develop time — mitsuba3 develops its ptracer ImageBlock the
same way (splat + spp normalization, not weight normalization).

Documented contract vs the reference:
  * Sensors: perspective pinhole only (thinlens with zero aperture works;
    mitsuba3 connects through Sensor::sample_direction generally).
  * Emitters: area, point, spot (constant/envmap/directional light paths
    need a scene-bounding-disk emission sampler — rejected at load time).
  * Transport symmetry: the reference applies TransportMode::Importance
    corrections for shading-normal / refraction asymmetry; validated
    scenes here are reflective with geometric==shading normals.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.frame import Frame
from mitsuba_customization_tpu.core.sampler import make_sampler
from mitsuba_customization_tpu.core.warp import (
    square_to_cosine_hemisphere,
    square_to_uniform_sphere,
)
from mitsuba_customization_tpu.models import bsdf as bsdf_mod
from mitsuba_customization_tpu.render import emitters as em_mod
from mitsuba_customization_tpu.render import film as film_mod
from mitsuba_customization_tpu.render import geometry as geo
from mitsuba_customization_tpu.render.records import Ray
from mitsuba_customization_tpu.render.sensors import PERSPECTIVE, THINLENS

# Sampler dimension layout (EM_DIMS draws start a path, BOUNCE_DIMS per
# bounce — replay-exact discipline, same as render/integrator.py).
EM_DIMS = 6  # 0 emitter select, 1-2 position/prim, 3-4 direction
BOUNCE_DIMS = 8  # 0-1 bsdf 2d, 2 lobe, 3 RR

SUPPORTED_EMITTERS = (em_mod.AREA, em_mod.POINT, em_mod.SPOT)


def _camera_frame(sensor):
    rot = sensor.to_world[:3, :3]
    origin = sensor.to_world[:3, 3]
    fwd = rot[:, 2]
    return origin, rot, fwd


def _film_area(sensor, aspect):
    """World-measure film area on the z=1 camera plane."""
    tan_half = jnp.tan(jnp.deg2rad(sensor.fov_x) * 0.5)
    return (2.0 * tan_half) * (2.0 * tan_half / aspect)


def connect_sensor(sensor, p, h, w):
    """Project world point p through the pinhole.

    Returns (film_xy (..., 2), w_cam unit dir p->camera (..., 3),
    imp (…) = 1 / (r^2 cos^3 theta A_film), valid).
    """
    aspect = w / h
    origin, rot, _fwd = _camera_frame(sensor)
    rel = p - origin
    pc = m.vecmat(rel, rot)  # camera-space (rot columns are the camera axes)
    z = pc[..., 2]
    valid = z > jnp.maximum(sensor.near_clip, 1e-6)
    zs = jnp.where(valid, z, 1.0)
    tan_half = jnp.tan(jnp.deg2rad(sensor.fov_x) * 0.5)
    x = pc[..., 0] / zs
    y = pc[..., 1] / zs
    u = (x / tan_half + 1.0) * 0.5
    v = (1.0 - y * aspect / tan_half) * 0.5
    valid = valid & (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
    film_xy = jnp.stack([u * w, v * h], axis=-1)
    r2 = jnp.maximum(m.squared_norm(rel), 1e-12)
    cos_t = jnp.clip(z / jnp.sqrt(r2), 1e-6, 1.0)
    a_film = _film_area(sensor, aspect)
    imp = 1.0 / (r2 * cos_t**3 * a_film)
    return film_xy, -m.normalize(rel), jnp.where(valid, imp, 0.0), valid


def sample_emitter_ray(emitters, geom, u_sel, u_pos, u_dir):
    """Start a light path: (ray, beta (..., 3), p0, n0, le0, area_w).

    beta = Le * cos / (p_sel p_A p_omega) (power throughput after leaving
    the emission vertex). p0/n0/le0/area_w describe the emission vertex
    itself for the direct camera connection: its world position, normal,
    emitted radiance toward arbitrary directions (area emitters), and the
    surface-measure weight 1/(p_sel p_A); area_w = 0 for delta emitters.
    """
    k, u_rest = emitters.select.sample_reuse(u_sel)
    p_sel = emitters.select.eval_pmf(k)
    et = emitters.em_type[k]
    rad = emitters.radiance[k]
    pos = emitters.position[k]
    sdir = emitters.direction[k]
    cutoff = emitters.cutoff_cos[k]
    beam = emitters.beam_cos[k]

    # ---- area: prim ~ per-emitter pmf, uniform position, cosine dir ----
    q, u_rest2 = emitters.prim_dist.sample_reuse(u_rest, slice_=(k,))
    pmf_q = emitters.prim_dist.eval_pmf(q, slice_=(k,))
    area = jnp.maximum(emitters.prim_area[q], 1e-12)
    u2q = jnp.stack([u_pos, u_rest2], axis=-1)
    if emitters.em_geom is not None:
        p_area, n_area = em_mod._sample_position_on_prim(
            emitters.em_geom, q, u2q
        )
    else:
        prim = emitters.em_prims[q]
        p_area, n_area = em_mod._sample_position_on_prim(geom, prim, u2q)
    fr = Frame.from_normal(n_area)
    d_loc = square_to_cosine_hemisphere(u_dir)
    d_area = fr.to_world(d_loc)
    # beta = Le * cos / (p_sel * (pmf/area) * cos/pi) = Le pi area/(p_sel pmf)
    w_area = jnp.pi * area / jnp.maximum(pmf_q * p_sel, 1e-12)

    # ---- point: uniform sphere ----
    d_point = square_to_uniform_sphere(u_dir)
    w_point = 4.0 * jnp.pi / jnp.maximum(p_sel, 1e-12)

    # ---- spot: uniform cone around `direction` ----
    cos_theta = 1.0 - u_dir[..., 0] * (1.0 - cutoff)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * jnp.pi * u_dir[..., 1]
    fr_s = Frame.from_normal(sdir)
    d_spot = fr_s.to_world(
        jnp.stack(
            [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta],
            axis=-1,
        )
    )
    pdf_cone = 1.0 / jnp.maximum(
        2.0 * jnp.pi * (1.0 - cutoff), 1e-12
    )
    # linear falloff between beam and cutoff (mitsuba3 spot falloff)
    fall = jnp.clip(
        (cos_theta - cutoff) / jnp.maximum(beam - cutoff, 1e-6), 0.0, 1.0
    )
    w_spot = fall / jnp.maximum(pdf_cone * p_sel, 1e-12)

    is_area = et == em_mod.AREA
    is_point = et == em_mod.POINT
    is_spot = et == em_mod.SPOT
    supported = is_area | is_point | is_spot

    o = jnp.where(is_area[..., None], p_area, pos)
    d = jnp.where(
        is_area[..., None],
        d_area,
        jnp.where(is_spot[..., None], d_spot, d_point),
    )
    w = jnp.where(
        is_area, w_area, jnp.where(is_spot, w_spot, w_point)
    )
    w = jnp.where(supported, w, 0.0)
    beta = rad * w[..., None]
    eps = 1e-4
    ray = Ray.make(o + eps * jnp.where(is_area[..., None], n_area, d), d)

    area_w = jnp.where(
        is_area, area / jnp.maximum(pmf_q * p_sel, 1e-12), 0.0
    )
    return ray, beta, o, jnp.where(is_area[..., None], n_area, d), rad, area_w


def trace_light_paths(scene, n_paths, spp, seed, max_depth, rr_depth):
    """Trace n_paths light subpaths; returns (splat_values (V, 3),
    film_xy (V, 2), n_rays) with V = n_paths * (max_depth + 1) camera
    connections (invalid ones carry zero weight)."""
    cfg = scene.config
    h, w = cfg.height, cfg.width
    sensor = scene.sensor
    lanes = jnp.arange(n_paths, dtype=jnp.uint32)
    smp = make_sampler(
        "independent", jnp.uint32(seed) ^ jnp.uint32(0x9E3779B9), lanes,
        jnp.zeros_like(lanes), 1,
    )

    u_sel = smp.next_1d()
    u_pos = smp.next_1d()
    u_dir = smp.next_2d()
    ray, beta, p0, n0, le0, area_w = sample_emitter_ray(
        scene.emitters, scene.geometry, u_sel, u_pos, u_dir
    )

    # ---- direct emitter -> camera connection (path length 1) ----
    origin, _, _ = _camera_frame(sensor)
    film0, w_cam0, imp0, ok0 = connect_sensor(sensor, p0, h, w)
    cos0 = jnp.maximum(m.dot(n0, w_cam0), 0.0)
    vis_ray0 = Ray(
        o=p0 + 1e-4 * w_cam0,
        d=w_cam0,
        maxt=m.norm(origin - p0) * (1.0 - 1e-3),
    )
    occ0 = scene.ray_test(vis_ray0)
    c0 = (
        le0
        * (area_w * cos0 * imp0)[..., None]
    )
    c0 = jnp.where((ok0 & jnp.logical_not(occ0))[..., None], c0, 0.0)

    zero = ray.o[..., 0] * 0.0
    init = (ray, beta, zero < 0.5)

    def bounce(carry, b):
        ray, beta, active = carry
        smp_b = smp.with_dim(
            jnp.uint32(EM_DIMS) + b.astype(jnp.uint32) * BOUNCE_DIMS
        )
        si = scene.ray_intersect(ray)
        si = jax.tree_util.tree_map(jax.lax.stop_gradient, si)
        active = active & si.valid
        n_rays = jnp.sum(active.astype(jnp.uint32))

        # ---- camera connection from the surface vertex ----
        film_xy, w_cam, imp, okc = connect_sensor(sensor, si.p, h, w)
        wo_cam = si.to_local(w_cam)
        f_cam = bsdf_mod.eval(
            scene.bsdfs, si.mat_id, si.wi, wo_cam, uv=si.uv
        )
        dist_cam = m.norm(origin - si.p)
        shadow = geo.spawn_ray(si, w_cam)
        occ = scene.ray_test(
            Ray(o=shadow.o, d=shadow.d, maxt=dist_cam * (1.0 - 1e-3))
        )
        contrib = beta * f_cam * imp[..., None]
        good = active & okc & jnp.logical_not(occ)
        contrib = jnp.where(good[..., None], contrib, 0.0)

        # ---- continue the light path ----
        u2 = smp_b.next_2d()
        u_lobe = smp_b.next_1d()
        wo, pdf_s, weight, _delta = bsdf_mod.sample(
            scene.bsdfs, si.mat_id, si.wi, u2, u_lobe, uv=si.uv
        )
        beta = beta * jnp.where(active[..., None], weight, 1.0)
        d_world = si.to_world(wo)
        nray = geo.spawn_ray(si, d_world)
        ray = Ray(
            o=jnp.where(active[..., None], nray.o, ray.o),
            d=jnp.where(active[..., None], nray.d, ray.d),
            maxt=jnp.full_like(ray.maxt, jnp.inf),
        )
        active = (
            active & (pdf_s > 0.0) & jnp.any(weight > 0.0, axis=-1)
        )
        u_rr = smp_b.next_1d()
        q = jnp.clip(jnp.max(jnp.minimum(weight, 1e3), axis=-1), 0.05, 0.95)
        do_rr = b + 1 >= rr_depth
        survive = jnp.logical_or(jnp.logical_not(do_rr), u_rr < q)
        beta = jnp.where((do_rr & survive)[..., None], beta / q[..., None],
                         beta)
        active = active & survive
        return (ray, beta, active), (contrib, film_xy, n_rays)

    (_, _, _), (contribs, film_xys, rays_pb) = jax.lax.scan(
        bounce, init, jnp.arange(max_depth)
    )
    values = jnp.concatenate([c0[None], contribs], axis=0).reshape(-1, 3)
    film_all = jnp.concatenate([film0[None], film_xys], axis=0).reshape(-1, 2)
    return values, film_all, jnp.sum(rays_pb) + n_paths


def render_ptracer(scene, spp=None, seed=0, max_depth=None,
                   return_stats=False):
    """Full ptracer render: n_paths = H * W * spp light subpaths."""
    cfg = scene.config
    if getattr(scene.sensor, "child_types", None) is not None:
        # batch sensors store a (B,) sensor_type array; int() below would
        # raise an opaque TypeError (round-4 advisor finding)
        raise ValueError(
            "integrator 'ptracer' does not support the 'batch' sensor: "
            "light-path camera connections need a single camera"
        )
    st = int(scene.sensor.sensor_type)
    if st not in (PERSPECTIVE, THINLENS):
        raise ValueError("ptracer supports perspective/thinlens sensors only")
    spp = spp or cfg.spp
    max_depth = max_depth or cfg.max_depth
    h, w = cfg.height, cfg.width
    from mitsuba_customization_tpu.render.integrator import MAX_WAVEFRONT

    total = h * w * spp
    n_pass = max(1, (total + MAX_WAVEFRONT - 1) // MAX_WAVEFRONT)
    while total % n_pass:
        n_pass += 1
    n_chunk = total // n_pass

    def one_pass(p, img):
        vals, xy, n_rays = trace_light_paths(
            scene, n_chunk, spp,
            jnp.uint32(seed) + p.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B),
            max_depth, cfg.rr_depth,
        )
        part, _ = film_mod.splat(
            vals, xy, h, w, film_mod.FILTER_NAMES[cfg.rfilter]
        )
        return img + part, n_rays

    img = jnp.zeros((h, w, 3))
    rays = jnp.float32(0.0)
    if n_pass == 1:
        img, nr = one_pass(jnp.uint32(0), img)
        rays = nr.astype(jnp.float32)
    else:
        def body(carry, p):
            img, rays = carry
            img, nr = one_pass(p, img)
            return (img, rays + nr.astype(jnp.float32)), None

        (img, rays), _ = jax.lax.scan(
            body, (img, rays), jnp.arange(n_pass)
        )
    out = img / jnp.float32(spp)
    if return_stats:
        return out, {"rays_traced": rays}
    return out
