"""Drive the renderer's main path once on one GPU and check what comes out.

    python chip_smoke.py                # every one-card phase
    python chip_smoke.py --phase main   # chosen phases only (repeatable)
    python chip_smoke.py --four-cards   # the four-card phase, and no other

Everything runs in this one process and reaches the card only through JAX.
Every phase prints lines that name the card; any failed check raises, so
the script exits nonzero and prints no result. The last line of a passing
run is one JSON object naming the device JAX ran on. Without a GPU, or
outside a checkout of the repository, the script exits nonzero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# Full width of the bench's headline scene: 512^2 pixels x 8 spp is one
# 2^21-lane wavefront; depth 8; 20,480 blob triangles + floor + light.
RES, SPP, DEPTH = 512, 8, 8
MATPREVIEW_PRIMS = 20484
N_LANES = RES * RES * SPP
# Inverse rendering on the flagship: optimize at OPT_RES, compare the
# step-0 gradient with the CPU backend at GRAD_RES, per table cell and
# summed per channel. A rounding difference can flip one path's discrete
# decision and move its whole contribution to other cells: the CPU alone,
# float32 against float64, differs per cell by 4.8e-4 at 32^2 and 1.9e-2
# at 64^2 while the sums agree to 2e-6. On an H100 the per-cell gap to
# the CPU read 8.2e-4 at 32^2 and 1.4e-3 at 64^2; the sums at 32^2 read
# 9.2e-8 or 7.8e-7, depending on the host CPU that XLA compiled for. So
# the per-cell check holds at 32^2 only, and the sums carry the tight
# check.
OPT_RES, GRAD_RES = 256, 32
# Four-card phase: matpreview cut to SHARD_RES^2 x 4 spp, depth 2 (the
# collectives, not the frame, are under test).
SHARD_RES, SHARD_DEPTH = 64, 2

_card = "?"


def log(msg):
    print(f"[{_card}] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    log(f"ok: {what}")


def timed(fn, *args, n=5):
    """Median wall seconds of fn(*args) to block_until_ready (warm)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def memory_line(jitted, *args):
    mem = jitted.lower(*args).compile().memory_analysis()
    if mem is None:
        return "memory_analysis: not reported"
    return (
        f"memory_analysis: args {mem.argument_size_in_bytes} B, "
        f"out {mem.output_size_in_bytes} B, temp {mem.temp_size_in_bytes} B"
    )


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()


def with_intersector(scene, name):
    import dataclasses

    return dataclasses.replace(
        scene, config=dataclasses.replace(scene.config, intersector=name)
    )


def primary_rays(scene, spp, seed=0):
    """The renderer's primary rays in row-major lane order, and the sampler
    positioned after the camera dimensions."""
    import jax.numpy as jnp

    from mitsuba_customization_tpu.render.integrator import camera_rays

    lanes = jnp.arange(scene.config.height * scene.config.width * spp,
                       dtype=jnp.uint32)
    ray, _, smp = camera_rays(scene, spp, jnp.uint32(seed),
                              lanes // jnp.uint32(spp),
                              lanes % jnp.uint32(spp))
    return ray, smp


def grazing_cos(geom, ray, lane, prim):
    """|cos| between a ray and its hit triangle's normal (small = grazing,
    where rounding moves t the most)."""
    n = np.cross(np.asarray(geom.e1[prim]), np.asarray(geom.e2[prim]))
    d = np.asarray(ray.d[lane])
    return float(abs(n @ d) / (np.linalg.norm(n) * np.linalg.norm(d)))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels():
    """Traversal kernel vs the plain BVH, and the MERL eval vs the numpy
    reference, at real widths on the card."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _matpreview_scene, _synthetic_merl_table
    from mitsuba_customization_tpu.core.warp import square_to_cosine_hemisphere
    from mitsuba_customization_tpu.models import tabulated as tb
    from mitsuba_customization_tpu.ops import traverse
    from mitsuba_customization_tpu.render import bvh as bvh_mod
    from mitsuba_customization_tpu.render import geometry as geo
    from mitsuba_customization_tpu.render.records import Ray
    from reference_renderer import merl_eval_trilinear_reference

    t0 = time.perf_counter()
    scene = _matpreview_scene(res=RES, spp=SPP, depth=DEPTH)
    traverse.ensure_built()
    log(f"matpreview load + kernel build {time.perf_counter() - t0:.3f} s, "
        f"{scene.geometry.n_prims} prims, {scene.bvh.n_nodes} BVH nodes")
    tree, geom = scene.bvh, scene.geometry

    k_hit = jax.jit(traverse.intersect)
    b_hit = jax.jit(bvh_mod.intersect)
    k_occ = jax.jit(traverse.occluded)
    b_occ = jax.jit(bvh_mod.occluded)

    @jax.jit
    def bounce_rays(scene):
        ray, smp = primary_rays(scene, SPP)
        t, prim, u, v = traverse.intersect(scene.bvh, scene.geometry, ray)
        si = geo.compute_interaction(scene.geometry, ray, t, prim, u, v)
        d = si.to_world(square_to_cosine_hemisphere(smp.next_2d()))
        out = geo.spawn_ray(si, d)
        return Ray(o=out.o, d=out.d, maxt=jnp.where(si.valid, jnp.inf, 0.0))

    primary = jax.jit(lambda s: primary_rays(s, SPP)[0])(scene)
    rays = {"primary": primary, "bounce": bounce_rays(scene)}
    log("closest-hit kernel " + memory_line(k_hit, tree, geom, primary))
    log("any-hit kernel " + memory_line(k_occ, tree, geom, primary))
    for name, ray in rays.items():
        check(ray.o.shape[0] == N_LANES, f"{name}: {N_LANES} rays")
        tk, pk, _, _ = map(np.asarray, k_hit(tree, geom, ray))
        tb_, pb, _, _ = map(np.asarray, b_hit(tree, geom, ray))
        agree = float(np.mean(pk == pb))
        same = np.nonzero((pk == pb) & (pk >= 0))[0]
        t_rel = np.abs(tk[same] - tb_[same]) / tb_[same]
        worst = same[np.argmax(t_rel)]
        log(f"{name}: hit share {np.mean(pb >= 0):.6f}, prim agreement "
            f"{agree:.7f}, max t rel diff {t_rel.max():.3e} (|cos(d, n)| "
            f"{grazing_cos(geom, ray, worst, pb[worst]):.3e} there)")
        check(agree >= 0.9999, f"{name}: prim agrees on >= 99.99% of lanes")
        check(t_rel.max() <= 1e-5, f"{name}: t agrees to rel 1e-5 on every "
              "common hit")
        # shadow rays: half the lanes stop halfway to their hit
        half = np.isfinite(tb_) & (np.arange(N_LANES) % 2 == 0)
        maxt = np.where(half, tb_ * 0.5, np.inf).astype(np.float32)
        shadow = Ray(o=ray.o, d=ray.d, maxt=jnp.asarray(maxt))
        ok_ = np.asarray(k_occ(tree, geom, shadow))
        ob = np.asarray(b_occ(tree, geom, shadow))
        occ_agree = float(np.mean(ok_ == ob))
        log(f"{name}: occluded share {ob.mean():.6f}, agreement "
            f"{occ_agree:.7f}")
        check(occ_agree >= 0.9999, f"{name}: any-hit agrees on >= 99.99%")
        log(f"{name}: closest-hit kernel "
            f"{timed(k_hit, tree, geom, ray) * 1e3:.3f} ms, plain BVH "
            f"{timed(b_hit, tree, geom, ray) * 1e3:.3f} ms; any-hit kernel "
            f"{timed(k_occ, tree, geom, shadow) * 1e3:.3f} ms, plain BVH "
            f"{timed(b_occ, tree, geom, shadow) * 1e3:.3f} ms")

    # MERL eval: 10-material stack at 90x90x180, 2^21 lanes
    rng = np.random.default_rng(0)
    tables = np.stack([
        _synthetic_merl_table(0.08 + 0.04 * i, (1.0, 0.5 + 0.05 * i, 0.4))
        for i in range(10)
    ])

    def hemi(n):
        v = rng.normal(size=(n, 3))
        v[:, 2] = np.abs(v[:, 2])
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32
        )

    wi, wo = hemi(N_LANES), hemi(N_LANES)
    slot = rng.integers(0, 10, N_LANES).astype(np.int32)
    args = (jnp.asarray(tables), jnp.asarray(wi), jnp.asarray(wo),
            jnp.asarray(slot))
    ev = jax.jit(tb.eval_raw)
    log("MERL eval " + memory_line(ev, *args))
    got = np.asarray(ev(*args))
    ref = np.zeros((N_LANES, 3))
    for s in range(10):
        m = slot == s
        ref[m] = merl_eval_trilinear_reference(
            tables[s].astype(np.float64), wi[m].astype(np.float64),
            wo[m].astype(np.float64),
        )
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)
    log(f"MERL eval: max rel {rel.max():.3e}, share within 1e-5 "
        f"{np.mean(rel <= 1e-5):.6f}, {timed(ev, *args) * 1e3:.3f} ms")
    # f32 angles lose digits where the half vector nears the normal
    # (arccos of ~1): the tail read 4.0e-5 on an H100 and 6.5e-5 on the
    # CPU backend.
    check(np.mean(rel <= 1e-5) >= 0.995, "MERL eval: 99.5% of lanes to "
          "rel 1e-5 of the float64 reference")
    check(rel.max() <= 1e-4, "MERL eval: every lane to rel 1e-4")


def phase_reference():
    """The blob-mesh MERL + GGX scene against the numpy path tracer."""
    import jax

    from mitsuba_customization_tpu.render.integrator import render_jit
    from reference_renderer import render_path_reference
    from test_golden_path import CAM, _build_scene_pair

    with tempfile.TemporaryDirectory() as tmp:
        scene, ref_scene = _build_scene_pair(tmp)
    spp, ref_spp = 256, 384
    img = np.asarray(jax.block_until_ready(
        render_jit(scene, spp=spp, seed=11)
    ))
    ours = img[..., :3]
    ours_var = np.maximum(img[..., 3:] - ours * ours, 0.0)
    t0 = time.perf_counter()
    ref, ref_var = render_path_reference(
        ref_scene, CAM, res=24, spp=ref_spp, max_depth=3, seed=5
    )
    log(f"numpy reference {time.perf_counter() - t0:.1f} s; intersector "
        f"{scene.config.intersector}")
    # the gate of tests/test_golden_path.py
    se = np.sqrt(ours_var / spp + ref_var / ref_spp) + 0.015 * (ref + 0.05)
    frac_ok = float(np.mean(np.abs(ours - ref) / se < 4.0))
    rel_mean = abs(ours.mean() - ref.mean()) / ref.mean()
    log(f"reference: |z| < 4 on {frac_ok:.4f} of values, mean rel diff "
        f"{rel_mean:.4f}")
    check(frac_ok > 0.98, "reference image: Z-test passes on > 98%")
    check(rel_mean < 0.05, "reference image: means agree within 5%")


def phase_main():
    """Matpreview through load_dict + render_jit at full width."""
    import jax

    from __graft_entry__ import _matpreview_scene
    from mitsuba_customization_tpu.models.bsdf import TABULATED
    from mitsuba_customization_tpu.render.integrator import render_jit

    t0 = time.perf_counter()
    scene = _matpreview_scene(res=RES, spp=SPP, depth=DEPTH)
    log(f"matpreview load {time.perf_counter() - t0:.3f} s: "
        f"{scene.geometry.n_prims} prims, "
        f"{scene.bsdfs.stacks[TABULATED].table.shape[0]} MERL tables, "
        f"intersector {scene.config.intersector}")
    check(scene.geometry.n_prims == MATPREVIEW_PRIMS, "20,484 triangles")
    check(scene.config.intersector == "kernel", "GPU picks the kernel")

    frames = {}
    for name in ("kernel", "bvh"):
        sc = with_intersector(scene, name)
        t0 = time.perf_counter()
        img, st = jax.block_until_ready(
            render_jit(sc, seed=0, return_stats=True)
        )
        first = time.perf_counter() - t0
        sec = timed(lambda s: render_jit(s, seed=1), sc, n=3)
        rays = float(st["rays_traced"])
        frames[name] = sec
        img = np.asarray(img)
        log(f"{name}: first call (compile + run) {first:.3f} s, frame "
            f"{sec:.4f} s, {rays:.0f} rays, {rays / sec:.6e} rays/s, "
            f"image mean {img.mean():.6f}")
        check(img.shape == (RES, RES, 3) and np.isfinite(img).all(),
              f"{name}: 512x512 image is finite")
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    log(f"peak device memory {peak} B; kernel / plain BVH frame time "
        f"{frames['kernel'] / frames['bvh']:.4f}")

    # 64^2 x 4 spp on the GPU (kernel) and on the CPU backend (plain BVH)
    t0 = time.perf_counter()
    small = _matpreview_scene(res=64, spp=4, depth=DEPTH)
    gpu = np.asarray(render_jit(small, seed=3))
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        small_cpu = jax.device_put(with_intersector(small, "bvh"), cpu_dev)
        cpu = np.asarray(render_jit(small_cpu, seed=3))
    diff = np.abs(gpu - cpu)
    rel_l1 = float(diff.sum() / np.abs(cpu).sum())
    close = float(np.mean(diff <= 1e-4 + 1e-3 * np.abs(cpu)))
    log(f"GPU vs CPU 64x64x4 ({time.perf_counter() - t0:.1f} s with "
        f"compiles): relative L1 {rel_l1:.3e}, values within 1e-4 + 1e-3 "
        f"rel: {close:.5f}")
    # Same stateless samples; paths differ only where float rounding
    # flips a decision (a hit on an edge, a roulette threshold).
    check(rel_l1 < 1e-3, "GPU and CPU images agree: relative L1 < 1e-3")
    check(close > 0.999, "GPU and CPU images agree on > 99.9% of values")


CLI_XML = """<scene version="3.0.0">
  <integrator type="path"><integer name="max_depth" value="2"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world">
      <lookat origin="0, 1, -3" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="64"/><integer name="height" value="48"/>
    </film>
    <sampler type="independent"><integer name="sample_count" value="4"/></sampler>
  </sensor>
  <shape type="sphere">
    <float name="radius" value="0.6"/>
    <bsdf type="roughconductor"><float name="alpha" value="0.2"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><rotate x="1" angle="-90"/><scale value="3"/><translate y="-0.6"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.5 0.4"/></bsdf>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="0.8"/></emitter>
</scene>"""


def phase_cli():
    """The CLI, in-process, on a small XML scene, writing a PNG."""
    from mitsuba_customization_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "scene.xml")
        png = os.path.join(tmp, "out.png")
        with open(xml, "w") as f:
            f.write(CLI_XML)
        check(cli.main([xml, "-o", png]) == 0, "CLI returned 0")
        with open(png, "rb") as f:
            data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 100,
          f"CLI wrote a PNG ({len(data)} B)")


def phase_inverse():
    """Three ad.optimize steps recovering a MERL table on the flagship."""
    import jax

    from __graft_entry__ import _flagship_scene
    from mitsuba_customization_tpu.render import ad
    from mitsuba_customization_tpu.render import params as params_mod
    from mitsuba_customization_tpu.render.integrator import render_jit

    key = "bsdf.tabulated.table"

    def setup(res):
        scene = _flagship_scene(res=res, spp=8, depth=4)
        true = params_mod.traverse(scene)[key]
        target = render_jit(scene, spp=8, seed=100)
        start = params_mod.update(scene, {key: true * 0.4})
        return start, target

    start, target = setup(OPT_RES)
    t0 = time.perf_counter()
    params, losses = ad.optimize(start, target, [key], n_steps=3, lr=0.02,
                                 spp=8)
    log(f"ad.optimize {OPT_RES}^2 spp 8: losses {losses}, "
        f"{time.perf_counter() - t0:.3f} s for 3 steps (incl. compile)")
    check(np.isfinite(np.asarray(params[key])).all(), "updated table finite")
    check(losses[-1] < losses[0], "loss falls over 3 steps")

    start, target = setup(GRAD_RES)
    p0 = {key: params_mod.traverse(start)[key]}
    loss_g, g_gpu = ad.grad_render(start, p0, target, spp=8, seed=1)
    g_gpu = np.asarray(g_gpu[key])
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        loss_c, g_cpu = ad.grad_render(
            jax.device_put(start, cpu_dev), jax.device_put(p0, cpu_dev),
            jax.device_put(target, cpu_dev), spp=8, seed=1,
        )
    g_cpu = np.asarray(g_cpu[key])
    rel = float(np.linalg.norm(g_gpu - g_cpu) / np.linalg.norm(g_cpu))
    sums = [g.astype(np.float64).sum(axis=(0, 1, 2, 3))
            for g in (g_gpu, g_cpu)]
    sum_rel = float(np.max(np.abs(sums[0] - sums[1]) / np.abs(sums[1])))
    log(f"step-0 gradient {GRAD_RES}^2: loss GPU {float(loss_g):.6e} CPU "
        f"{float(loss_c):.6e}, |g_gpu - g_cpu| / |g_cpu| = {rel:.3e}, "
        f"per-channel table sums max rel diff {sum_rel:.3e}")
    check(np.isfinite(g_gpu).all() and np.abs(g_gpu).max() > 0,
          "gradient finite and nonzero")
    check(rel <= 1e-3, "GPU gradient matches the CPU backend to rel 1e-3")
    check(sum_rel <= 1e-5, "GPU gradient's table sums match the CPU's to "
          "rel 1e-5")


def one_card_slices(scene, spp, n_dev):
    """The sharded render's per-device lane slices, each traced as its own
    program on one card, developed together: the same arithmetic as the
    shards without the mesh."""
    import jax
    import jax.numpy as jnp

    from mitsuba_customization_tpu.render import film as film_mod
    from mitsuba_customization_tpu.render.integrator import render_lanes

    cfg = scene.config
    n = cfg.height * cfg.width * spp // n_dev
    run = jax.jit(lambda sc, off: render_lanes(
        sc, spp, jnp.uint32(0), lane_offset=off, n_lanes=n)[:2])
    parts = [run(scene, jnp.uint32(k * n)) for k in range(n_dev)]
    L = jnp.concatenate([p[0] for p in parts])
    if cfg.rfilter == "box":
        return np.asarray(film_mod.develop_box(L, cfg.height, cfg.width, spp))
    xy = jnp.concatenate([p[1] for p in parts])
    img, wsum = film_mod.splat(L, xy, cfg.height, cfg.width,
                               film_mod.FILTER_NAMES[cfg.rfilter])
    return np.asarray(img / jnp.maximum(wsum, 1e-12)[..., None])


def phase_four_cards():
    """render_sharded and loss_and_grad_sharded over 4 GPUs vs one.

    Results are gathered first and checked at the end, so one run reports
    every comparison.
    """
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _matpreview_scene
    from mitsuba_customization_tpu.parallel import mesh as pmesh
    from mitsuba_customization_tpu.render import params as params_mod
    from mitsuba_customization_tpu.render.ad import grad_render
    from mitsuba_customization_tpu.render.integrator import render_jit

    devs = jax.devices()
    check(len(devs) >= 4, f"4 devices present ({devs[0].platform})")
    mesh = pmesh.make_mesh(devs[:4])
    res, spp, key = SHARD_RES, 4, "bsdf.tabulated.table"
    checks = []

    def compare(img, ref):
        diff = np.abs(img - ref)
        row = diff.sum(axis=(1, 2)) / np.abs(ref).sum(axis=(1, 2))
        px = diff / (np.abs(ref) + 1e-6)
        return float(row.max()), (
            f"max row rel L1 {row.max():.3e}, max value rel {px.max():.3e}, "
            f"values within rel 1e-5 {np.mean(px <= 1e-5):.5f}")

    for rfilter in ("box", "gaussian"):
        scene = _matpreview_scene(res=res, spp=spp, depth=SHARD_DEPTH)
        scene.config.rfilter = rfilter
        t0 = time.perf_counter()
        img_s = np.asarray(pmesh.render_sharded_jit(scene, mesh, spp=spp,
                                                    seed=0))
        t_s = time.perf_counter() - t0
        row_sl, msg_sl = compare(img_s, one_card_slices(scene, spp, 4))
        row_1, msg_1 = compare(
            img_s, np.asarray(render_jit(scene, spp=spp, seed=0)))
        log(f"render_sharded {rfilter}: {res}^2 x {spp} spp, intersector "
            f"{scene.config.intersector}, on 4 devices (first call "
            f"{t_s:.2f} s); vs the same lane slices on one device: "
            f"{msg_sl}; vs render_jit: {msg_1}")
        # Same lanes, same arithmetic: only the mesh (offsets, halo
        # ppermute, gather) differs.
        checks.append((row_sl <= 1e-5,
                       f"{rfilter}: every sharded row matches the one-device "
                       "slices to rel 1e-5 (L1)"))
        # render_jit traces all 16,384 lanes as one program. XLA rounds a
        # 4,096-lane slice differently on some lanes (on one H100 18% of
        # lanes differ in the last bits, with or without FMA contraction;
        # primary rays and first hits are identical), and a few of those
        # flip a sampling decision. Rows read 1.87e-5 (box) and 1.51e-5
        # (gaussian) on four H100s, and 1.85e-5 for the slices on one.
        checks.append((row_1 <= 3e-5,
                       f"{rfilter}: every sharded row matches render_jit "
                       "to rel 3e-5 (L1)"))

    # gradients under the splat filter: the halo ppermute and its
    # transpose, and the explicit gradient psum
    params = {key: params_mod.traverse(scene)[key]}
    target = jnp.zeros((res, res, 3))
    loss_s, g_s = pmesh.loss_and_grad_sharded_jit(
        scene, params, target, mesh, spp, jnp.uint32(3)
    )
    loss_1, g_1 = grad_render(scene, params, target, spp=spp, seed=3)
    g_s, g_1 = np.asarray(g_s[key]), np.asarray(g_1[key])
    rel = float(np.linalg.norm(g_s - g_1) / np.linalg.norm(g_1))
    log(f"loss_and_grad_sharded gaussian: loss {float(loss_s):.6e} vs "
        f"{float(loss_1):.6e}, gradient rel diff {rel:.3e}")
    checks.append((abs(float(loss_s) - float(loss_1)) <= 1e-4 * float(loss_1),
                   "sharded loss matches one device to rel 1e-4"))
    checks.append((rel <= 1e-3,
                   "sharded gradient matches one device to rel 1e-3"))
    for ok, what in checks:
        check(ok, what)


PHASES = {
    "kernels": phase_kernels,
    "reference": phase_reference,
    "main": phase_main,
    "cli": phase_cli,
    "inverse": phase_inverse,
}


def main(argv=None):
    global _card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded four-card phase")
    ap.add_argument("--phase", action="append", choices=sorted(PHASES),
                    help="run only these one-card phases")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from mitsuba_customization_tpu.utils import compile_cache

    cache = compile_cache.enable()
    smi = nvidia_smi()
    _card = devices[0].device_kind
    log(f"platform {devices[0].platform}, device_kind "
        f"{devices[0].device_kind}, {len(devices)} devices, JAX "
        f"{jax.__version__}, compile cache {cache}")
    for line in smi:
        log(f"nvidia-smi: {line}")

    phases = (
        {"four_cards": phase_four_cards} if args.four_cards
        else {k: PHASES[k] for k in (args.phase or PHASES)}
    )
    for name, fn in phases.items():
        t0 = time.perf_counter()
        log(f"phase {name}: start")
        fn()
        log(f"phase {name}: passed in {time.perf_counter() - t0:.1f} s")

    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
