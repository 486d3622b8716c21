"""Signed-distance-field grid shape (mitsuba3 src/shapes/sdfgrid.cpp).

A regular (Nx, Ny, Nz) grid of signed distances over the local unit cube
[0,1]^3, placed by `to_world`, and intersected by lock-step sphere
tracing: every lane advances `t += max(sdf(p), floor)` inside one
`lax.while_loop` — uniform control flow, no per-lane divergence beyond
masks, exactly the wavefront discipline of the rest of the renderer.
No BVH participates (the grid IS the acceleration structure), matching
SURVEY.md §2.4's sdfgrid row.

Per-lane trilinear grid samples use XLA's gather, and every lane steps
in lock-step until the slowest converges, so sdfgrid is a *capability*
shape: correct everywhere, fast for small grids. Its speed on the GPU is
not measured.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.frame import Frame
from mitsuba_customization_tpu.render.records import Ray, SurfaceInteraction

MAX_STEPS = 128
HIT_EPS = 1e-4


class SDFGrid(NamedTuple):
    """One SDF grid shape.

    values:   (Nx, Ny, Nz) f32 signed distances at the grid nodes,
              sampled over the local unit cube (x-major index order)
    to_world: (4, 4) placement
    to_local: (4, 4) inverse
    scale:    () conservative world-units-per-local-unit step scale
              (min axis scale of to_world — keeps sphere tracing safe
              under anisotropic placement)
    mat_id:   () int32 BSDF row
    shape_id: () int32
    """

    values: jnp.ndarray
    to_world: jnp.ndarray
    to_local: jnp.ndarray
    scale: jnp.ndarray
    mat_id: jnp.ndarray
    shape_id: jnp.ndarray


def make(values, to_world=None, mat_id=0, shape_id=0):
    values = jnp.asarray(values, jnp.float32)
    tw = np.eye(4, dtype=np.float32) if to_world is None else np.asarray(
        to_world, np.float32
    )
    tl = np.linalg.inv(tw.astype(np.float64)).astype(np.float32)
    axis_scale = np.linalg.norm(tw[:3, :3], axis=0)
    return SDFGrid(
        values=values,
        to_world=jnp.asarray(tw),
        to_local=jnp.asarray(tl),
        scale=jnp.asarray(float(axis_scale.min()), jnp.float32),
        mat_id=jnp.asarray(int(mat_id), jnp.int32),
        shape_id=jnp.asarray(int(shape_id), jnp.int32),
    )


def sample(sdf: SDFGrid, p_local):
    """Trilinear SDF value at local positions (..., 3), clamped to the
    grid support. Distances are in LOCAL units."""
    nx, ny, nz = sdf.values.shape
    dims = jnp.asarray([nx, ny, nz], jnp.float32)
    u = p_local * (dims - 1.0)
    i0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0,
                  jnp.asarray([nx - 2, ny - 2, nz - 2]))
    f = jnp.clip(u - i0, 0.0, 1.0)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    v = sdf.values

    def at(dx, dy, dz):
        return v[x0 + dx, y0 + dy, z0 + dz]

    c00 = at(0, 0, 0) * (1 - fz) + at(0, 0, 1) * fz
    c01 = at(0, 1, 0) * (1 - fz) + at(0, 1, 1) * fz
    c10 = at(1, 0, 0) * (1 - fz) + at(1, 0, 1) * fz
    c11 = at(1, 1, 0) * (1 - fz) + at(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def normal(sdf: SDFGrid, p_local):
    """World-space normal via central differences of the local SDF."""
    h = 1.0 / jnp.asarray(max(sdf.values.shape), jnp.float32)
    e = jnp.eye(3, dtype=jnp.float32) * h

    def d(axis):
        return sample(sdf, p_local + e[axis]) - sample(sdf, p_local - e[axis])

    g_local = jnp.stack([d(0), d(1), d(2)], axis=-1)
    # normals transform by the inverse-transpose of to_world
    g_world = m.vecmat(g_local, sdf.to_local[:3, :3])
    return m.normalize(g_world + 1e-20)


def intersect(sdf: SDFGrid, ray: Ray):
    """Sphere-trace nearest hit. Returns (t_world, hit, p_local)."""
    rot = sdf.to_local[:3, :3]
    o_l = m.matvec(rot, ray.o) + sdf.to_local[:3, 3]
    d_l = m.matvec(rot, ray.d)  # NOT normalized: t stays in world units

    # clip to the local unit cube
    inv = 1.0 / jnp.where(jnp.abs(d_l) < 1e-12, 1e-12, d_l)
    t0 = (0.0 - o_l) * inv
    t1 = (1.0 - o_l) * inv
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    enters = (near <= far) & (far > 0.0)
    t_start = jnp.maximum(near, 0.0) + 1e-5

    d_norm = jnp.maximum(m.norm(d_l), 1e-12)  # local units per world t

    def body(state):
        t, active, hit = state
        p = o_l + t[..., None] * d_l
        dist = sample(sdf, p)
        is_hit = active & (dist < HIT_EPS)
        # conservative march: local distance -> world t via |d_l|
        step = jnp.maximum(dist, HIT_EPS) / d_norm
        t_new = jnp.where(active & ~is_hit, t + step, t)
        active = active & ~is_hit & (t_new <= jnp.minimum(far, ray.maxt))
        return t_new, active, hit | is_hit

    def cond(state):
        _, active, _ = state
        return jnp.any(active)

    n_lanes = ray.o.shape[:-1]
    state = (t_start, enters & (t_start < ray.maxt),
             jnp.zeros(n_lanes, bool))
    t, active, hit = _bounded_trace(cond, body, state)
    p_local = o_l + t[..., None] * d_l
    return jnp.where(hit, t, jnp.inf), hit, p_local


def _bounded_trace(cond, body, state):
    """while_loop with a hard MAX_STEPS bound (static shapes, no
    runaway loops on degenerate grids)."""
    def body2(state2):
        s, k = state2
        return body(s), k + 1

    def cond2(state2):
        s, k = state2
        return cond(s) & (k < MAX_STEPS)

    out, _ = jax.lax.while_loop(cond2, body2, (state, jnp.int32(0)))
    return out


def interaction(sdf: SDFGrid, ray: Ray, t, hit, p_local):
    """SurfaceInteraction for SDF hits (prim = 0 sentinel: SDF shapes are
    never emitters, so prim-indexed emitter lookups are masked off)."""
    p = ray.o + ray.d * jnp.where(hit, t, 0.0)[..., None]
    n = normal(sdf, p_local)
    # two-sided shading: flip toward the ray like the mesh path
    facing = m.dot(n, ray.d) < 0.0
    n_sh = jnp.where(facing[..., None], n, -n)
    frame = Frame.from_normal(n_sh)
    zero = jnp.zeros(t.shape, jnp.int32)
    return SurfaceInteraction(
        valid=hit,
        t=t,
        p=p,
        n=n,
        frame=frame,
        uv=jnp.stack([p_local[..., 0], p_local[..., 1]], axis=-1),
        wi=frame.to_local(-ray.d),
        prim=zero,
        mat_id=zero + sdf.mat_id,
        emitter=zero - 1,
        bary=jnp.zeros(t.shape + (2,)),
        )


def merge_interaction(si: SurfaceInteraction, si_sdf: SurfaceInteraction):
    """Pick the nearer of a soup hit and an SDF hit per lane."""
    closer = si_sdf.valid & (~si.valid | (si_sdf.t < si.t))

    def pick(a, b):
        c = closer
        while c.ndim < a.ndim:
            c = c[..., None]
        return jnp.where(c, a, b)

    return jax.tree_util.tree_map(pick, si_sdf, si)


def sphere_sdf(n=32, center=(0.5, 0.5, 0.5), radius=0.35):
    """Analytic-sphere SDF grid — the test fixture (exact distances)."""
    ax = (np.arange(n) + 0.0) / (n - 1)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    d = np.sqrt(
        (x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2
    ) - radius
    return d.astype(np.float32)
