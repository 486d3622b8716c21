"""Participating media: homogeneous + heterogeneous (grid) volumes.

Counterpart of mitsuba3 src/media/{homogeneous,heterogeneous}.cpp
+ src/volumes/{gridvolume,constvolume}.cpp (SURVEY.md §2.4 "Media / Phase /
Volumes"; mitsuba 0.6 src/media/). Design notes:

* All media of a scene compile into one `MediumTable` (the medium analogue
  of models/bsdf.py's BSDFTable): per-medium static type + parameters, and
  density grids stacked into one (K, D, H, W) tensor gathered per lane —
  no virtual calls, no dynamic shapes.
* Homogeneous media use closed-form spectral transmittance and
  channel-MIS analytic distance sampling (mitsuba3 homogeneous.cpp
  semantics: pick a channel uniformly, pdf averages over channels).
* Heterogeneous media use *weighted delta tracking* for distance sampling
  and *ratio tracking* for shadow-ray transmittance, both under a scalar
  majorant, expressed as lane-vectorized `lax.while_loop`s with bounded
  iteration — the unbounded free-flight loop of the reference becomes the
  same masked lock-step wavefront structure as the BVH traversal
  (SURVEY.md §2.7 P5).
* Media attach to shapes: `shape_interior[shape_id]` gives the medium
  entered when a ray crosses that shape's boundary inward (the reference
  binds media to shapes the same way via <medium name="interior">).

RNG: free-flight loops draw an unbounded number of decisions, so they hash
(seed, lane, dim_base + step) directly (core/qmc) — replay-exact like every
other sampling decision (SURVEY.md §7.3 item 3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.qmc import hash_combine

HOMOGENEOUS = 0
HETEROGENEOUS = 1

# Hard cap on null-collision loop iterations (majorant-normalized media
# terminate in a handful of steps whp; the cap only guards degenerate
# majorants).
MAX_TRACKING_STEPS = 256

# Static tracking-loop length for differentiable (ad_mode) renders:
# lax.while_loop is not reverse-differentiable, so ad_mode runs the
# tracking loops as a fixed-length masked lax.scan instead (the detached
# sampling decisions are identical; only the unrolled bound differs).
AD_TRACKING_STEPS = 48


def _tracking_loop(cond, body, init, ad_mode):
    """while_loop in primal renders, fixed-length masked scan in ad_mode.

    body takes and returns the full state tuple whose first element is the
    step counter; `cond` is ignored under ad_mode (the done-masking inside
    body keeps converged lanes frozen).
    """
    if not ad_mode:
        return jax.lax.while_loop(cond, body, init)

    def scan_body(state, _):
        return body(state), None

    state, _ = jax.lax.scan(
        scan_body, init, None, length=AD_TRACKING_STEPS
    )
    return state

_U32 = jnp.uint32


class MediumTable(NamedTuple):
    """All media of a scene, compiled for masked static dispatch.

    m_type:        (K,) int32 HOMOGENEOUS/HETEROGENEOUS
    sigma_t:       (K, 3) extinction (already scaled)
    albedo:        (K, 3) single-scattering albedo (sigma_s = albedo*sigma_t)
    phase_type:    (K,) int32 (models/phase.py enum)
    phase_g:       (K,) HG anisotropy
    grid:          (Kg, D, H, W) stacked densities (Kg >= 1; 1x1x1x1 dummy)
    grid_slot:     (K,) int32 index into grid
    world_to_grid: (K, 3, 4) affine world -> normalized grid coords [0,1]^3
    grid_dims:     (K, 3) int32 actual (D, H, W) of each medium's grid
                   (grids are zero-padded into the shared stack)
    majorant:      (K,) scalar majorant of mean extinction (delta tracking)
    shape_interior:(S,) int32 medium id entered through shape s (-1 = vacuum)
    emission:      (K, 3) emitted radiance Le (emissive media — the 0.6
                   stack's medium emission capability; sigma_a = (1 -
                   albedo) * sigma_t scales it at collision events)
    """

    m_type: jnp.ndarray
    sigma_t: jnp.ndarray
    albedo: jnp.ndarray
    phase_type: jnp.ndarray
    phase_g: jnp.ndarray
    grid: jnp.ndarray
    grid_slot: jnp.ndarray
    world_to_grid: jnp.ndarray
    grid_dims: jnp.ndarray
    majorant: jnp.ndarray
    shape_interior: jnp.ndarray
    emission: jnp.ndarray = None
    # (K, 6) SGGX matrices [xx, yy, zz, xy, xz, yz] — None when no sggx
    # phase exists in the scene (structural gate; models/phase.py SGGX)
    phase_S: jnp.ndarray = None

    @property
    def n_media(self):
        return self.m_type.shape[0]


def empty_table(n_shapes=1):
    """A table with zero media (every lookup is vacuum)."""
    return MediumTable(
        m_type=jnp.zeros((0,), jnp.int32),
        sigma_t=jnp.zeros((0, 3)),
        albedo=jnp.zeros((0, 3)),
        phase_type=jnp.zeros((0,), jnp.int32),
        phase_g=jnp.zeros((0,)),
        grid=jnp.ones((1, 1, 1, 1)),
        grid_slot=jnp.zeros((0,), jnp.int32),
        world_to_grid=jnp.zeros((0, 3, 4)),
        grid_dims=jnp.ones((0, 3), jnp.int32),
        majorant=jnp.zeros((0,)),
        shape_interior=jnp.full((max(n_shapes, 1),), -1, jnp.int32),
        emission=jnp.zeros((0, 3)),
    )


# --------------------------------------------------------------------------
# Density lookup (gridvolume trilinear, mitsuba3 src/volumes/gridvolume.cpp)
# --------------------------------------------------------------------------


def _density(table: MediumTable, mid, p):
    """Trilinear density at world p for heterogeneous lanes (1.0 for
    homogeneous). mid must be pre-clamped >= 0."""
    w2g = table.world_to_grid[mid]  # (..., 3, 4)
    g = (
        m.matvec(w2g[..., :3], p) + w2g[..., 3]
    )  # normalized [0,1]^3 as (z, y, x) fractions
    grid = table.grid
    slot = table.grid_slot[mid]
    dims = table.grid_dims[mid]  # (..., 3) per-lane actual (D, H, W)
    d = dims[..., 0].astype(jnp.float32)
    h = dims[..., 1].astype(jnp.float32)
    w = dims[..., 2].astype(jnp.float32)
    fz = jnp.clip(g[..., 0], 0.0, 1.0) * (d - 1)
    fy = jnp.clip(g[..., 1], 0.0, 1.0) * (h - 1)
    fx = jnp.clip(g[..., 2], 0.0, 1.0) * (w - 1)
    z0 = jnp.clip(
        jnp.floor(fz).astype(jnp.int32), 0, jnp.maximum(dims[..., 0] - 2, 0)
    )
    y0 = jnp.clip(
        jnp.floor(fy).astype(jnp.int32), 0, jnp.maximum(dims[..., 1] - 2, 0)
    )
    x0 = jnp.clip(
        jnp.floor(fx).astype(jnp.int32), 0, jnp.maximum(dims[..., 2] - 2, 0)
    )
    tz = fz - z0
    ty = fy - y0
    tx = fx - x0
    z1 = jnp.minimum(z0 + 1, dims[..., 0] - 1)
    y1 = jnp.minimum(y0 + 1, dims[..., 1] - 1)
    x1 = jnp.minimum(x0 + 1, dims[..., 2] - 1)

    def at(zi, yi, xi):
        return grid[slot, zi, yi, xi]

    c00 = m.lerp(at(z0, y0, x0), at(z0, y0, x1), tx)
    c01 = m.lerp(at(z0, y1, x0), at(z0, y1, x1), tx)
    c10 = m.lerp(at(z1, y0, x0), at(z1, y0, x1), tx)
    c11 = m.lerp(at(z1, y1, x0), at(z1, y1, x1), tx)
    c0 = m.lerp(c00, c01, ty)
    c1 = m.lerp(c10, c11, ty)
    dens = m.lerp(c0, c1, tz)
    # outside [0,1]^3 the medium is empty
    inside = jnp.all((g >= 0.0) & (g <= 1.0), axis=-1)
    het = table.m_type[mid] == HETEROGENEOUS
    return jnp.where(het & inside, dens, jnp.where(het, 0.0, 1.0))


def sigma_t_at(table: MediumTable, mid, p):
    """(..., 3) extinction at p; zero for vacuum lanes (mid < 0)."""
    safe = jnp.maximum(mid, 0)
    base = table.sigma_t[safe]
    dens = _density(table, safe, p)
    return jnp.where((mid >= 0)[..., None], base * dens[..., None], 0.0)


# --------------------------------------------------------------------------
# Free-flight RNG: hash stream over (seed, lane, dim_base + step)
# --------------------------------------------------------------------------


def _draw(seed, lane, dim):
    bits = hash_combine(hash_combine(seed, lane), dim)
    return (bits >> _U32(8)).astype(jnp.float32) * jnp.float32(
        1.0 / (1 << 24)
    )


# --------------------------------------------------------------------------
# Distance sampling (medium_sample / sample_interaction)
# --------------------------------------------------------------------------


class MediumSample(NamedTuple):
    """Free-flight sample along a ray segment inside medium `mid`.

    is_medium: (...) bool — scattered inside the medium before t_max
    t:         (...) interaction distance (valid when is_medium)
    weight:    (..., 3) throughput factor: tr*sigma_s/pdf on scatter,
               tr/pr_pass on pass-through (already includes albedo)
    """

    is_medium: jnp.ndarray
    t: jnp.ndarray
    weight: jnp.ndarray
    # collision-estimator emission: tr * sigma_a * Le / pdf at the sampled
    # event (zero for pass-through / non-emissive media); add
    # thr_before_weight * emitted to L on medium events
    emitted: jnp.ndarray = None


def sample_interaction(table: MediumTable, mid, ray_o, ray_d, t_max,
                       seed, lane, dim_base, ad_mode=False):
    """Sample a free-flight distance for lanes inside a medium.

    Vacuum lanes (mid < 0) return is_medium=False, weight=1. The sampling
    estimator matches mitsuba3's: homogeneous = analytic channel-MIS;
    heterogeneous = weighted delta tracking (spectral weights under a
    scalar majorant on the channel-mean extinction).
    """
    in_medium = mid >= 0
    safe = jnp.maximum(mid, 0)
    k = table.n_media
    if k == 0:
        ones = jnp.ones(ray_o.shape[:-1] + (3,))
        f = jnp.zeros(ray_o.shape[:-1])
        return MediumSample(
            is_medium=f > 1.0, t=f, weight=ones, emitted=ones * 0.0
        )

    is_het = table.m_type[safe] == HETEROGENEOUS
    sig = table.sigma_t[safe]  # (..., 3)
    alb = table.albedo[safe]
    le = (
        table.emission[safe]
        if table.emission is not None
        else jnp.zeros_like(alb)
    )

    # ---- homogeneous: analytic (mitsuba3 homogeneous.cpp) ----
    u_ch = _draw(seed, lane, dim_base)
    u_t = _draw(seed, lane, dim_base + _U32(1))
    ch = jnp.minimum((u_ch * 3).astype(jnp.int32), 2)
    # 3-way channel select
    sig_ch = jnp.where(
        ch == 0, sig[..., 0], jnp.where(ch == 1, sig[..., 1], sig[..., 2])
    )
    # Detached-estimator discipline (prbvolpath, SURVEY.md §3.2): sampled
    # distances and pdfs are stop-gradded; transmittance/extinction values
    # in the numerator stay attached so sigma_t/albedo gradients flow.
    sg = jax.lax.stop_gradient
    t_hom = sg(
        -jnp.log1p(-jnp.clip(u_t, 0.0, 1.0 - 1e-7)) / jnp.maximum(
            sig_ch, 1e-20
        )
    )
    scat_hom = t_hom < t_max
    tr_t = jnp.exp(-sig * jnp.minimum(t_hom, t_max)[..., None])
    pdf_scat = sg(jnp.mean(sig * tr_t, axis=-1))  # channel-avg density
    pdf_pass = sg(jnp.mean(tr_t, axis=-1))
    base_hom = m.safe_div(tr_t * sig, pdf_scat[..., None])
    w_hom = jnp.where(
        scat_hom[..., None],
        base_hom * alb,
        m.safe_div(tr_t, pdf_pass[..., None]),
    )
    em_hom = jnp.where(
        scat_hom[..., None], base_hom * (1.0 - alb) * le, 0.0
    )

    # ---- heterogeneous: weighted delta tracking ----
    maj = sg(jnp.maximum(table.majorant[safe], 1e-20))

    def dt_body(state):
        step, t, w, done, scat = state
        u1 = _draw(seed, lane, dim_base + _U32(2) + step * _U32(2))
        u2 = _draw(seed, lane, dim_base + _U32(3) + step * _U32(2))
        t_new = t - jnp.log1p(-jnp.clip(u1, 0.0, 1.0 - 1e-7)) / maj
        passed = t_new >= t_max
        p = ray_o + t_new[..., None] * ray_d
        sig_p = sig * _density(table, safe, p)[..., None]  # (..., 3)
        mean_sig = jnp.mean(sig_p, axis=-1)
        p_real = sg(jnp.clip(mean_sig / maj, 0.0, 1.0))
        real = u2 < p_real
        # spectral weight corrections (weighted delta tracking): attached
        # extinction in the numerators, detached selection pdfs below
        w_real = m.safe_div(sig_p, sg(mean_sig)[..., None])
        w_null = m.safe_div(
            maj[..., None] - sig_p,
            sg(maj * (1.0 - p_real))[..., None],
        )
        upd = jnp.logical_not(done)
        t = jnp.where(upd, jnp.where(passed, t_max, t_new), t)
        w = jnp.where(
            (upd & jnp.logical_not(passed))[..., None],
            w * jnp.where(real[..., None], w_real, w_null),
            w,
        )
        scat = scat | (upd & jnp.logical_not(passed) & real)
        done = done | passed | scat | (step >= MAX_TRACKING_STEPS)
        return step + _U32(1), t, w, done, scat

    def dt_cond(state):
        _, _, _, done, _ = state
        return jnp.logical_not(jnp.all(done))

    # carries derive data-dependently from t_max so their varying-mesh
    # annotation matches the loop outputs under shard_map (scan-vma rule);
    # t_max may be +inf (inf * 0 = NaN would poison every where-gradient)
    zero_t = jnp.where(jnp.isfinite(t_max), t_max, 0.0) * 0.0
    need_het = in_medium & is_het
    init = (
        _U32(0),
        zero_t,
        zero_t[..., None] + jnp.ones(3),
        jnp.logical_not(need_het),
        zero_t > 1.0,
    )
    _, t_het, w_het, _, scat_het = _tracking_loop(
        dt_cond, dt_body, init, ad_mode
    )
    em_het = jnp.where(
        scat_het[..., None], w_het * (1.0 - alb) * le, 0.0
    )
    w_het = jnp.where(scat_het[..., None], w_het * alb, w_het)

    is_medium = in_medium & jnp.where(is_het, scat_het, scat_hom)
    t_s = jnp.where(is_het, t_het, t_hom)
    weight = jnp.where(
        in_medium[..., None], jnp.where(is_het[..., None], w_het, w_hom), 1.0
    )
    emitted = jnp.where(
        in_medium[..., None], jnp.where(is_het[..., None], em_het, em_hom),
        0.0,
    )
    return MediumSample(
        is_medium=is_medium, t=t_s, weight=weight, emitted=emitted
    )


# --------------------------------------------------------------------------
# Transmittance (shadow rays) — analytic / ratio tracking
# --------------------------------------------------------------------------


def transmittance(table: MediumTable, mid, ray_o, ray_d, dist,
                  seed, lane, dim_base, ad_mode=False):
    """(..., 3) transmittance through medium `mid` over [0, dist].

    Vacuum lanes return 1. Homogeneous = exp(-sigma_t d); heterogeneous =
    ratio tracking (unbiased, same majorant discipline as delta tracking).
    """
    in_medium = mid >= 0
    if table.n_media == 0:
        return jnp.ones(ray_o.shape[:-1] + (3,))
    safe = jnp.maximum(mid, 0)
    is_het = table.m_type[safe] == HETEROGENEOUS
    sig = table.sigma_t[safe]
    d_fin = jnp.where(jnp.isfinite(dist), dist, 1e7)

    tr_hom = jnp.exp(-sig * d_fin[..., None])

    # ratio tracking: majorant (sampling density) detached, extinction in
    # the (1 - sigma/maj) factors attached -> unbiased transmittance grads
    maj = jax.lax.stop_gradient(jnp.maximum(table.majorant[safe], 1e-20))

    def rt_body(state):
        step, t, w, done = state
        u1 = _draw(seed, lane, dim_base + step)
        t_new = t - jnp.log1p(-jnp.clip(u1, 0.0, 1.0 - 1e-7)) / maj
        passed = t_new >= d_fin
        p = ray_o + t_new[..., None] * ray_d
        sig_p = sig * _density(table, safe, p)[..., None]
        upd = jnp.logical_not(done) & jnp.logical_not(passed)
        w = jnp.where(
            upd[..., None],
            w * jnp.clip(1.0 - sig_p / maj[..., None], 0.0, 1.0),
            w,
        )
        t = jnp.where(done, t, t_new)
        done = done | passed | (step >= MAX_TRACKING_STEPS)
        return step + _U32(1), t, w, done

    def rt_cond(state):
        _, _, _, done = state
        return jnp.logical_not(jnp.all(done))

    need_het = in_medium & is_het
    init = (
        _U32(0),
        d_fin * 0.0,
        (d_fin * 0.0)[..., None] + jnp.ones(3),
        jnp.logical_not(need_het),
    )
    _, _, tr_het, _ = _tracking_loop(rt_cond, rt_body, init, ad_mode)

    tr = jnp.where(is_het[..., None], tr_het, tr_hom)
    return jnp.where(in_medium[..., None], tr, 1.0)


# --------------------------------------------------------------------------
# Scene-build helper
# --------------------------------------------------------------------------


def recompute_majorant(table: MediumTable):
    """Majorant of the channel-mean extinction, recomputed from the current
    sigma_t / density leaves (jittable — runs inside the optimization step
    after a params.update, like the MERL CDF rebuild)."""
    mean_sig = jnp.mean(table.sigma_t, axis=-1)
    if table.grid.size > 1 or table.grid_slot.size:
        gmax = jnp.max(
            table.grid.reshape(table.grid.shape[0], -1), axis=-1
        )
        slot_max = gmax[table.grid_slot] if table.grid_slot.size else 1.0
        het = table.m_type == HETEROGENEOUS
        return jnp.where(het, mean_sig * slot_max, mean_sig)
    return mean_sig


def build_table(media_rows, shape_interior, n_shapes):
    """Compile medium descriptions into a MediumTable.

    media_rows: list of dicts with keys
      type ('homogeneous'|'heterogeneous'), sigma_t (3,), albedo (3,),
      phase_type, phase_g, density (D,H,W) or None, to_world (4,4) or None
      (world box of the density grid; its inverse maps world->unit cube).
    shape_interior: list of per-shape medium ids (-1 = vacuum).
    """
    k = len(media_rows)
    if k == 0:
        return empty_table(n_shapes)
    m_type = np.zeros(k, np.int32)
    sigma_t = np.zeros((k, 3), np.float32)
    albedo = np.zeros((k, 3), np.float32)
    phase_type = np.zeros(k, np.int32)
    phase_g = np.zeros(k, np.float32)
    grid_slot = np.zeros(k, np.int32)
    world_to_grid = np.zeros((k, 3, 4), np.float32)
    grid_dims = np.ones((k, 3), np.int32)
    majorant = np.zeros(k, np.float32)
    emission = np.zeros((k, 3), np.float32)
    phase_S = None
    grids = []
    max_shape = (1, 1, 1)
    for i, row in enumerate(media_rows):
        m_type[i] = (
            HETEROGENEOUS if row["type"] == "heterogeneous" else HOMOGENEOUS
        )
        sigma_t[i] = np.asarray(row["sigma_t"], np.float32)
        albedo[i] = np.asarray(row["albedo"], np.float32)
        phase_type[i] = row.get("phase_type", 0)
        phase_g[i] = row.get("phase_g", 0.0)
        if row.get("emission") is not None:
            emission[i] = np.asarray(row["emission"], np.float32)
        if row.get("phase_S") is not None:
            if phase_S is None:
                phase_S = np.tile(
                    np.asarray([1, 1, 1, 0, 0, 0], np.float32), (k, 1)
                )
            phase_S[i] = np.asarray(row["phase_S"], np.float32)
        if m_type[i] == HETEROGENEOUS:
            dens = np.asarray(row["density"], np.float32)
            grid_slot[i] = len(grids)
            grid_dims[i] = dens.shape
            grids.append(dens)
            max_shape = tuple(
                max(a, b) for a, b in zip(max_shape, dens.shape)
            )
            to_w = (
                np.asarray(row["to_world"], np.float64)
                if row.get("to_world") is not None
                else np.eye(4)
            )
            inv = np.linalg.inv(to_w)
            # world -> unit cube, then reorder (x,y,z) -> (z,y,x) fractions
            perm = np.asarray(
                [[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.float64
            )
            world_to_grid[i, :, :3] = (perm @ inv[:3, :3]).astype(np.float32)
            world_to_grid[i, :, 3] = (perm @ inv[:3, 3]).astype(np.float32)
            majorant[i] = float(np.mean(sigma_t[i]) * dens.max())
        else:
            majorant[i] = float(np.mean(sigma_t[i]))
    if not grids:
        grids = [np.ones((1, 1, 1), np.float32)]
        max_shape = (1, 1, 1)
    padded = np.zeros((len(grids),) + max_shape, np.float32)
    for gi, g in enumerate(grids):
        padded[gi, : g.shape[0], : g.shape[1], : g.shape[2]] = g
    si = np.full(max(n_shapes, 1), -1, np.int32)
    for s, mid_ in enumerate(shape_interior[: len(si)]):
        si[s] = mid_
    return MediumTable(
        m_type=jnp.asarray(m_type),
        sigma_t=jnp.asarray(sigma_t),
        albedo=jnp.asarray(albedo),
        phase_type=jnp.asarray(phase_type),
        phase_g=jnp.asarray(phase_g),
        grid=jnp.asarray(padded),
        grid_slot=jnp.asarray(grid_slot),
        world_to_grid=jnp.asarray(world_to_grid),
        grid_dims=jnp.asarray(grid_dims),
        majorant=jnp.asarray(majorant),
        shape_interior=jnp.asarray(si),
        emission=jnp.asarray(emission),
        phase_S=None if phase_S is None else jnp.asarray(phase_S),
    )
