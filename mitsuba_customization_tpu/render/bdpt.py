"""Bidirectional path tracer (`bdpt`) — streaming 3-strategy BDPT.

First member of the reference's bidirectional family
([S0] mitsuba/src/libbidir/ + src/integrators/bdpt/ — SURVEY.md §2.6;
round-4 verdict "begin bdpt"). The classic implementation stores both
subpaths as vertex arrays and connects every (s, t) pair; storing
max_depth vertices per lane at wavefront scale is HBM-hostile, so this
module implements the three strategy families that need NO vertex
storage, with full power-heuristic MIS between them:

  * s=0  — eye path hits an emitter (BSDF sampling),
  * s=1  — eye path connects to an emitter sample (NEE),
  * t=1  — light path connects to the camera (light tracing / splat).

Every full path of length k can be generated by all three (s=0/s=1 need
k>=1/k>=2; t=1 needs a non-delta connection vertex), and the MIS weight
for each uses the true area-measure density ratios of the other two,
computed STREAMING with the one-bounce-delayed recurrence of the
VCM/SmallVCM family (Georgiev 2012 technical report's dVCM/dVC idea,
restricted to the implemented strategy set): each tracer carries

  R_run = prod_j  pdf_area_reverse(x_j) / pdf_area_forward(x_j)

over its interior vertices, where the reverse density of vertex x_j
becomes computable one bounce later (it needs the BSDF pdf at x_{j+1}
evaluated back toward x_j given the NEXT incident direction).

Documented contract (validated by tests/test_bdpt.py):
  * surfaces only (no media), perspective/thinlens pinhole sensor;
  * area emitters drive the t=1 strategy; constant/envmap backgrounds
    contribute through the eye strategies only (exactly as in `ptracer`);
  * Russian roulette is OFF in both passes (path pdfs stay exact; the
    static max_depth bounds work instead) — rr_depth is ignored;
  * paths containing a delta (specular) vertex drop the t=1 strategy on
    both sides consistently (eye side weights s-strategies as if t=1
    did not exist; light side kills the splat) — unbiased, at the cost
    of light-traced specular caustics. Delta-free scenes get the full
    3-strategy MIS.

Estimator equivalence gate: bdpt must match `path` in expectation on any
supported scene (both unbiased) — tests Z-test bdpt vs path on a
diffuse/glossy scene and on a small-bright-emitter scene where s
strategies alone converge slowly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.sampler import make_sampler
from mitsuba_customization_tpu.models import bsdf as bsdf_mod
from mitsuba_customization_tpu.render import emitters as em_mod
from mitsuba_customization_tpu.render import film as film_mod
from mitsuba_customization_tpu.render import geometry as geo
from mitsuba_customization_tpu.render.integrator import (
    BOUNCE_DIMS,
    CAMERA_DIMS,
    _OFF_NEE,
    texcoords,
)
from mitsuba_customization_tpu.render.ptracer import (
    EM_DIMS,
    _camera_frame,
    connect_sensor,
    sample_emitter_ray,
)
from mitsuba_customization_tpu.render.records import Ray
from mitsuba_customization_tpu.render.sensors import sample_ray

_SHADOW_INF = 1e30


def _pw2(x):
    return x * x


def _w_of(*ratios):
    """Power-heuristic (beta=2) weight 1 / (1 + sum ratios^2)."""
    denom = 1.0
    for r in ratios:
        denom = denom + _pw2(r)
    return 1.0 / denom


def _edge(p_from, n_from, p_to):
    """(cos at from-vertex toward to, 1/d^2) of the edge; safe on zeros."""
    v = p_to - p_from
    d2 = jnp.maximum(m.squared_norm(v), 1e-12)
    d = v * jax.lax.rsqrt(d2)[..., None]
    cos_f = jnp.abs(m.dot(n_from, d))
    return cos_f, 1.0 / d2, d


def _cam_area_pdf(sensor, p, n_at_p, h, w):
    """Area-measure density of the eye pass generating vertex x_1 = p:
    pdf of the pixel-jittered primary direction converted to area at p.
    = (H*W) * imp(p) * cos(theta_p)   [render/ptracer.py importance]."""
    _, w_cam, imp, ok = connect_sensor(sensor, p, h, w)
    cos_p = jnp.abs(m.dot(n_at_p, w_cam))
    return jnp.where(ok, (h * w) * imp * cos_p, 0.0), w_cam


def trace_eye_bdpt(scene, ray0, sampler, max_depth):
    """Eye pass: s=0 and s=1 contributions with 3-strategy MIS.

    Structurally trace_paths (render/integrator.py) with the streaming
    MIS carries added and RR removed. Returns (L (N, 3), n_rays).
    """
    h, w = scene.config.height, scene.config.width
    sensor = scene.sensor
    sg = jax.lax.stop_gradient
    has_em = bool(scene.emitters.n_emitters > 0)

    zero = ray0.o[..., 0] * 0.0
    init = (
        Ray(o=ray0.o, d=ray0.d, maxt=ray0.maxt + zero),
        1.0 + zero[..., None] * jnp.ones(3),  # throughput
        zero[..., None] * jnp.ones(3),        # L
        zero < 0.5,                           # active
        zero,                                 # prev bsdf pdf (solid angle)
        zero < 0.5,                           # prev edge delta (camera=True)
        1.0 + zero,                           # R_run (through x_{c-2})
        1.0 + zero,                           # pend pA_fwd(x_{c-1})
        jnp.zeros_like(ray0.o),               # n at x_{c-1}
        jnp.zeros_like(ray0.o),               # p at x_{c-1}
        zero > 0.5,                           # any_delta on the path
        zero,                                 # n_rays accumulator
    )

    def bounce(carry, b):
        (ray, thr, L, active, prev_pdf, prev_delta, R_run, pend_pA,
         n_prev, p_prev, any_delta, n_rays) = carry
        first = b == 0
        smp = sampler.with_dim(
            CAMERA_DIMS + b.astype(jnp.uint32) * BOUNCE_DIMS
        )
        smp_nee = sampler.with_dim(
            CAMERA_DIMS + b.astype(jnp.uint32) * BOUNCE_DIMS + _OFF_NEE
        )

        si = scene.ray_intersect(
            Ray(o=ray.o, d=ray.d, maxt=jnp.where(active, ray.maxt, 0.0))
        )
        si = jax.tree_util.tree_map(sg, si)
        n_rays = n_rays + jnp.sum(active.astype(jnp.float32))

        # geometry of the edge (x_{c-1} -> x_c); at b=0 x_{c-1} is the
        # camera (cos_prev unused: pA_cam plays pend_pA's role)
        cos_prev, inv_d2, _ = _edge(p_prev, n_prev, si.p)
        cos_cur = jnp.abs(m.dot(si.n, -ray.d))
        # pA_fwd(x_c): area density of the current vertex from the eye side
        pA_cam, _ = _cam_area_pdf(sensor, si.p, si.n, h, w)
        pA_fwd_cur = jnp.where(
            first, pA_cam, prev_pdf * cos_cur * inv_d2
        )

        # ---- s=0 close: emitter hit / background ----
        if has_em:
            hit_rad = em_mod.eval_hit(scene.emitters, si)
            hit_pdf = em_mod.pdf_hit_direction(
                scene.emitters, scene.geometry, si, ray.o
            )
            bg_rad = em_mod.eval_background(scene.emitters, ray.d)
            bg_pdf = em_mod.pdf_miss_direction(scene.emitters, ray.d)
            rad = jnp.where(si.valid[..., None], hit_rad, bg_rad)
            em_pdf = jnp.where(si.valid, hit_pdf, bg_pdf)
            # B/A (NEE over BSDF) in solid angle at the same vertex
            BA = jnp.where(
                prev_delta | first, 0.0, m.safe_div(em_pdf, prev_pdf)
            )
            # C/A: light-trace density over eye density (area measure).
            # pA_L / pA_fwd(x_k) * [p_emdir * cos_prev / d^2] / pend_pA
            # * R_run; emission direction is cosine-hemisphere at the
            # light (ptracer sample_emitter_ray), p_omega = cos_L / pi.
            pA_L = em_mod.pdf_hit_area(scene.emitters, si)
            cos_L = jnp.abs(m.dot(si.n, -ray.d))
            p_emdir = cos_L / jnp.pi
            pA_rev_prev = p_emdir * cos_prev * inv_d2
            CA = m.safe_div(pA_L, pA_fwd_cur) * jnp.where(
                first, 1.0, m.safe_div(pA_rev_prev, pend_pA) * R_run
            )
            CA = jnp.where(any_delta | (si.emitter < 0), 0.0, CA)
            w_mis = jnp.where(
                si.valid & (si.emitter >= 0), _w_of(BA, CA),
                # background: only A and B exist
                jnp.where(prev_delta | first, 1.0, _w_of(BA)),
            )
            contrib = thr * rad * sg(w_mis)[..., None]
            L = L + jnp.where(active[..., None], contrib, 0.0)

        active = active & si.valid

        # ---- NEE + BSDF sampling (fused dispatch) ----
        u2 = smp.next_2d()
        u_lobe = smp.next_1d()
        if has_em:
            u3 = jnp.stack(
                [smp_nee.next_1d(), smp_nee.next_1d(), smp_nee.next_1d()],
                axis=-1,
            )
            ds = em_mod.sample_direction(
                scene.emitters, scene.geometry, si.p, u3
            )
            nee_ok = active & (ds.pdf > 0.0) & (b + 2 <= max_depth)
            wo_nee = si.to_local(ds.d)
        else:
            wo_nee = si.wi

        f_nee, pdf_nee, wo, bsdf_pdf, weight, is_delta, _ = (
            bsdf_mod.bounce_shade(
                scene.bsdfs, si.mat_id, si.wi, wo_nee, u2, u_lobe,
                uv=texcoords(scene, si), need_attached=False, has_nee=has_em,
                active=active,
            )
        )
        wo = sg(wo)
        bsdf_pdf = sg(bsdf_pdf)

        # reverse BSDF pdfs at the current vertex (both needed variants)
        pdf_rev_cont = bsdf_mod.pdf(
            scene.bsdfs, si.mat_id, wo, si.wi, uv=texcoords(scene, si)
        )
        if has_em:
            pdf_rev_nee = bsdf_mod.pdf(
                scene.bsdfs, si.mat_id, wo_nee, si.wi, uv=texcoords(scene, si)
            )

        # ---- s=1 close: NEE connection ----
        if has_em:
            shadow = geo.spawn_ray(si, ds.d)
            maxt = jnp.where(
                jnp.isinf(ds.dist), _SHADOW_INF, ds.dist * (1.0 - 1e-3)
            )
            maxt = jnp.where(nee_ok, maxt, 0.0)
            occ = scene.ray_test(Ray(o=shadow.o, d=shadow.d, maxt=maxt))
            n_rays = n_rays + jnp.sum(nee_ok.astype(jnp.float32))
            AB = jnp.where(ds.delta, 0.0, m.safe_div(pdf_nee, ds.pdf))
            # C/B for the NEE-completed path: the ratio for the CURRENT
            # vertex uses the light-side density of x_c from the sampled
            # light point (emission cos-hemisphere), and x_{c-1}'s ratio
            # uses pdf_rev_nee. cos at the light toward x_c: ds carries no
            # normal, but pdf_sa = p_area * d^2 / cos_l
            # => cos_l = p_area * d^2 / pdf.
            d2_nee = jnp.where(jnp.isinf(ds.dist), 1.0, ds.dist * ds.dist)
            cos_l_nee = m.safe_div(ds.p_area * d2_nee, ds.pdf)
            p_emdir_nee = cos_l_nee / jnp.pi
            cos_cur_to_l = jnp.abs(m.dot(si.n, ds.d))
            pA_rev_cur = p_emdir_nee * cos_cur_to_l / d2_nee
            ratio_cur = m.safe_div(pA_rev_cur, pA_fwd_cur)
            pA_rev_prev_nee = (
                pdf_rev_nee * cos_prev * inv_d2
            )
            ratio_prev = jnp.where(
                first, 1.0, m.safe_div(pA_rev_prev_nee, pend_pA) * R_run
            )
            CB = ratio_cur * ratio_prev
            CB = jnp.where(
                any_delta | ds.delta | (ds.p_area <= 0.0), 0.0, CB
            )
            w_nee = jnp.where(ds.delta, 1.0, sg(_w_of(AB, CB)))
            contrib = (
                thr * f_nee * ds.radiance
                * sg(m.safe_div(w_nee, ds.pdf))[..., None]
            )
            L = L + jnp.where(
                (nee_ok & jnp.logical_not(occ))[..., None], contrib, 0.0
            )

        # ---- continuation ----
        thr = thr * jnp.where(active[..., None], weight, 1.0)
        d_world = si.to_world(wo)
        new_ray = geo.spawn_ray(si, d_world)
        ray = Ray(
            o=jnp.where(active[..., None], new_ray.o, ray.o),
            d=jnp.where(active[..., None], new_ray.d, ray.d),
            maxt=jnp.where(ray.maxt < 0.0, ray.maxt, jnp.inf),
        )
        # complete x_{c-1}'s ratio with the continuation's reverse pdf
        pA_rev_prev_cont = pdf_rev_cont * cos_prev * inv_d2
        ratio_cont = jnp.where(
            is_delta | jnp.isclose(pend_pA, 0.0), 1.0,
            m.safe_div(pA_rev_prev_cont, pend_pA),
        )
        R_run = jnp.where(first, R_run, R_run * ratio_cont)
        pend_pA = pA_fwd_cur
        any_delta = any_delta | (active & is_delta)
        n_prev = si.n
        p_prev = si.p
        prev_pdf = bsdf_pdf
        prev_delta = is_delta
        active = active & (bsdf_pdf > 0.0) & jnp.any(weight > 0.0, axis=-1)
        active = active & (b + 1 < max_depth)

        return (ray, thr, L, active, prev_pdf, prev_delta, R_run, pend_pA,
                n_prev, p_prev, any_delta, n_rays), None

    carry, _ = jax.lax.scan(bounce, init, jnp.arange(max_depth))
    return carry[2], carry[11]


def trace_light_bdpt(scene, n_paths, seed, max_depth):
    """Light pass: t=1 contributions with 3-strategy MIS.

    Structurally trace_light_paths (render/ptracer.py) with the mirror
    streaming carries. Returns (splat values (V, 3), film_xy (V, 2),
    n_rays)."""
    cfg = scene.config
    h, w = cfg.height, cfg.width
    sensor = scene.sensor
    lanes = jnp.arange(n_paths, dtype=jnp.uint32)
    smp = make_sampler(
        "independent", jnp.uint32(seed) ^ jnp.uint32(0x51633E2D), lanes,
        jnp.zeros_like(lanes), 1,
    )

    u_sel = smp.next_1d()
    u_pos = smp.next_1d()
    u_dir = smp.next_2d()
    ray, beta, p0, n0, le0, area_w = sample_emitter_ray(
        scene.emitters, scene.geometry, u_sel, u_pos, u_dir
    )
    pA_L = m.safe_div(1.0, area_w)  # 0 (inf guard) for delta emitters
    is_area0 = area_w > 0.0

    origin, _, _ = _camera_frame(sensor)

    # ---- k=1: emission vertex -> camera (competes with the eye pass's
    # primary emitter hit; A/C = pA_cam(x_1) / pA_L) ----
    film0, w_cam0, imp0, ok0 = connect_sensor(sensor, p0, h, w)
    cos0 = jnp.maximum(m.dot(n0, w_cam0), 0.0)
    occ0 = scene.ray_test(Ray(
        o=p0 + 1e-4 * w_cam0, d=w_cam0,
        maxt=m.norm(origin - p0) * (1.0 - 1e-3),
    ))
    pA_cam0 = (h * w) * imp0 * cos0
    AC0 = m.safe_div(pA_cam0, pA_L)
    w0 = _w_of(AC0)
    c0 = le0 * (area_w * cos0 * imp0 * w0)[..., None]
    c0 = jnp.where(
        (ok0 & is_area0 & jnp.logical_not(occ0))[..., None], c0, 0.0
    )

    zero = ray.o[..., 0] * 0.0
    cos_em = jnp.abs(m.dot(n0, ray.d))
    init = (
        ray, beta,
        is_area0,                      # active (area emission only)
        cos_em / jnp.pi,               # prev light-side pdf = emission dir
        1.0 + zero,                    # S_run (through y_{c-2})
        pA_L + zero,                   # pend pA_rev(y_{c-1}); y_0 -> pA_L
        n0, p0,                        # normal/pos of y_{c-1}
        1.0 + zero,                    # em_fac = pA_fwd(x_k)/pA_L
        zero > 0.5,                    # any_delta
    )

    def bounce(carry, b):
        (ray, beta, active, prev_pdf, S_run, pend_pA, n_prev, p_prev,
         em_fac, any_delta) = carry
        first = b == 0
        smp_b = smp.with_dim(
            jnp.uint32(EM_DIMS) + b.astype(jnp.uint32) * BOUNCE_DIMS
        )
        si = scene.ray_intersect(
            Ray(o=ray.o, d=ray.d, maxt=jnp.where(active, ray.maxt, 0.0))
        )
        si = jax.tree_util.tree_map(jax.lax.stop_gradient, si)
        active = active & si.valid
        n_rays = jnp.sum(active.astype(jnp.float32))

        cos_prev, inv_d2, _ = _edge(p_prev, n_prev, si.p)
        cos_cur = jnp.abs(m.dot(si.n, -ray.d))
        pA_rev_cur = prev_pdf * cos_cur * inv_d2  # light-side density of y_c

        # ---- camera connection at y_c ----
        film_xy, w_cam, imp, okc = connect_sensor(sensor, si.p, h, w)
        wo_cam = si.to_local(w_cam)
        f_cam = bsdf_mod.eval(scene.bsdfs, si.mat_id, si.wi, wo_cam,
                              uv=texcoords(scene, si))
        dist_cam = m.norm(origin - si.p)
        shadow = geo.spawn_ray(si, w_cam)
        occ = scene.ray_test(Ray(
            o=shadow.o, d=shadow.d,
            maxt=jnp.where(active & okc, dist_cam * (1.0 - 1e-3), 0.0),
        ))
        cos_c = jnp.abs(m.dot(si.n, w_cam))
        pA_cam_c = (h * w) * imp * cos_c

        # connection-aware ratio for y_{c-1}: eye-side pdf at y_c toward
        # y_{c-1} given incidence FROM THE CAMERA
        pdf_fwd_conn = bsdf_mod.pdf(
            scene.bsdfs, si.mat_id, wo_cam, si.wi, uv=texcoords(scene, si)
        )
        ratio_conn = m.safe_div(pdf_fwd_conn * cos_prev * inv_d2, pend_pA)
        camfac = m.safe_div(pA_cam_c, pA_rev_cur)
        # c=1: y_{c-1} is the emission vertex; ratio_conn then IS the
        # connection-aware em_fac and no pipeline em_fac applies yet.
        AC = camfac * jnp.where(
            first, ratio_conn, ratio_conn * S_run * em_fac
        )
        BC = camfac * jnp.where(first, 1.0, ratio_conn * S_run)
        # weight for strategy C: 1 / (1 + (A/C)^2 + (B/C)^2)
        w_mis = _w_of(AC, BC)
        contrib = beta * f_cam * (imp * w_mis)[..., None]
        good = active & okc & jnp.logical_not(occ) & jnp.logical_not(
            any_delta
        )
        contrib = jnp.where(good[..., None], contrib, 0.0)

        # ---- continue the light path ----
        u2 = smp_b.next_2d()
        u_lobe = smp_b.next_1d()
        wo, pdf_s, weight, is_delta = bsdf_mod.sample(
            scene.bsdfs, si.mat_id, si.wi, u2, u_lobe, uv=texcoords(scene, si)
        )
        # pipeline ratio for y_{c-1}: eye-side pdf at y_c toward y_{c-1}
        # given incidence from y_{c+1} (the sampled continuation)
        pdf_fwd_cont = bsdf_mod.pdf(
            scene.bsdfs, si.mat_id, wo, si.wi, uv=texcoords(scene, si)
        )
        ratio_cont = jnp.where(
            is_delta, 1.0,
            m.safe_div(pdf_fwd_cont * cos_prev * inv_d2, pend_pA),
        )
        # first completed ratio is em_fac (kept separate); later ones
        # accumulate into S_run
        em_fac = jnp.where(first, ratio_cont, em_fac)
        S_run = jnp.where(first, S_run, S_run * ratio_cont)

        beta = beta * jnp.where(active[..., None], weight, 1.0)
        d_world = si.to_world(wo)
        nray = geo.spawn_ray(si, d_world)
        ray = Ray(
            o=jnp.where(active[..., None], nray.o, ray.o),
            d=jnp.where(active[..., None], nray.d, ray.d),
            maxt=jnp.full_like(ray.maxt, jnp.inf),
        )
        pend_pA = pA_rev_cur
        n_prev = si.n
        p_prev = si.p
        prev_pdf = pdf_s
        any_delta = any_delta | (active & is_delta)
        active = active & (pdf_s > 0.0) & jnp.any(weight > 0.0, axis=-1)

        return (ray, beta, active, prev_pdf, S_run, pend_pA, n_prev,
                p_prev, em_fac, any_delta), (contrib, film_xy, n_rays)

    _, (contribs, film_xys, rays_pb) = jax.lax.scan(
        bounce, init, jnp.arange(max_depth - 1)
    )
    values = jnp.concatenate([c0[None], contribs], axis=0).reshape(-1, 3)
    film_all = jnp.concatenate(
        [film0[None], film_xys], axis=0
    ).reshape(-1, 2)
    return values, film_all, jnp.sum(rays_pb) + n_paths


def render_bdpt(scene, spp=None, seed=0, max_depth=None,
                return_stats=False):
    """Full BDPT render: eye pass (box-developed) + light pass (splat).

    Both passes use H*W*spp paths; the light film divides by spp exactly
    as render_ptracer does, which makes the strategy densities comparable
    lane-for-lane (see module docstring derivation).
    """
    from mitsuba_customization_tpu.render.ptracer import (
        PERSPECTIVE,
        THINLENS,
    )

    cfg = scene.config
    if getattr(scene.sensor, "child_types", None) is not None:
        raise ValueError("bdpt does not support the 'batch' sensor")
    if int(scene.sensor.sensor_type) not in (PERSPECTIVE, THINLENS):
        raise ValueError("bdpt supports perspective/thinlens sensors only")
    if scene.media.n_media:
        raise ValueError("bdpt does not support participating media")
    import numpy as _np

    etypes = set(_np.asarray(scene.emitters.em_type).tolist())
    bad = etypes - {em_mod.AREA, em_mod.CONSTANT, em_mod.ENVMAP}
    if bad and scene.emitters.n_emitters:
        raise ValueError(
            "bdpt supports area emitters (+ constant/envmap backgrounds "
            "through the eye strategies); scene has unsupported emitter "
            f"types {sorted(bad)}"
        )
    spp = spp or cfg.spp
    max_depth = max_depth or cfg.max_depth
    h, w = cfg.height, cfg.width
    from mitsuba_customization_tpu.render.integrator import MAX_WAVEFRONT

    total = h * w * spp
    n_pass = max(1, (total + MAX_WAVEFRONT - 1) // MAX_WAVEFRONT)
    while total % n_pass:
        n_pass += 1
    n_chunk = total // n_pass

    def eye_pass(p):
        lanes = (
            p.astype(jnp.uint32) * jnp.uint32(n_chunk)
            + jnp.arange(n_chunk, dtype=jnp.uint32)
        )
        pixel = lanes // jnp.uint32(spp)
        sidx = lanes % jnp.uint32(spp)
        smp = make_sampler(cfg.sampler, jnp.uint32(seed), pixel, sidx, spp)
        jitter = smp.next_2d()
        ap = smp.next_2d()
        px = (pixel % jnp.uint32(w)).astype(jnp.float32)
        py = (pixel // jnp.uint32(w)).astype(jnp.float32)
        film_xy = jnp.stack([px, py], axis=-1) + jitter
        film_uv = film_xy / jnp.asarray([w, h], dtype=jnp.float32)
        ray0 = sample_ray(scene.sensor, film_uv, ap, w / h)
        L, n_rays = trace_eye_bdpt(scene, ray0, smp, max_depth)
        return L, n_rays

    def light_pass(p):
        return trace_light_bdpt(
            scene, n_chunk,
            jnp.uint32(seed) + p.astype(jnp.uint32) * jnp.uint32(0x9E3779B9),
            max_depth,
        )

    light_img = jnp.zeros((h, w, 3))
    rays = jnp.float32(0.0)
    eye_parts = []
    for p in range(n_pass):
        L, nr = eye_pass(jnp.uint32(p))
        eye_parts.append(L)
        vals, xy, nr2 = light_pass(jnp.uint32(p))
        part, _ = film_mod.splat(vals, xy, h, w, film_mod.BOX)
        light_img = light_img + part
        rays = rays + nr + nr2
    # eye lanes are contiguous pixel-major chunks -> concat is the full
    # pixel-major wavefront
    eye_img = film_mod.develop_box(
        jnp.concatenate(eye_parts, axis=0), h, w, spp
    )
    img = eye_img + light_img / spp
    if return_stats:
        return img, {"rays_traced": rays}
    return img
