"""Device-mesh sharded rendering and gradient all-reduce.

Counterpart of the reference's distributed execution layer
(SURVEY.md §2.6 K3 Scheduler/RemoteWorker/mtssrv, §2.8): the Mitsuba 0.6
scheduler serializes 32x32 tiles over TCP to remote workers; here the image
rows shard across a `jax.sharding.Mesh` via `shard_map` (SURVEY.md §2.7
P1/P3 mapping, BASELINE.json north_star: rays/pixels shard across the
devices), the scene/BRDF tensors replicate per device
(P7), and parameter gradients `psum` over the mesh — XLA's latency-hiding
scheduler overlaps the all-reduce with the backward sweep (P6).

Topology: either a flat 1-D mesh ('shards') or the explicit 2-level
('dcn', 'ici') mesh of SURVEY.md §2.8 — hosts on the outer (DCN) axis,
chips within a host on the inner (ICI) axis. Row slabs shard over the
*flattened* axes with hosts outermost, so contiguous rows land host-local
and DCN only carries the gradient/film reductions. All entry points accept
either topology (they reduce over every mesh axis).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from mitsuba_customization_tpu.render import film as film_mod
from mitsuba_customization_tpu.render import params as params_mod
from mitsuba_customization_tpu.render.integrator import render_lanes

AXIS = "shards"

# Halo rows exchanged between row-shard neighbors for splat filters: the
# 3x3 splat footprint (render/film.splat) reaches at most 2 rows past a
# sample's own row.
HALO = 2


def _halo_exchange(slab, axes, n_dev, rows_local):
    """Sum halo rows into the owning shards' cores.

    slab: (rows_local + 2*HALO, ...) local splat accumulator covering
    [r0 - HALO, r0 + rows_local + HALO). The top HALO rows belong to the
    previous shard, the bottom HALO rows to the next; one ppermute each
    way replaces the full-film psum (round-3 verdict item 7: the
    all-film all-reduce cost 26% sharding overhead).
    """
    if rows_local < HALO:
        # e.g. an 8-row film over 8 devices: the negative core slice below
        # would silently mismatch the halo shape (round-4 advisor finding)
        raise ValueError(
            f"sharded splat films need >= {HALO} rows per shard, got "
            f"{rows_local}; use fewer devices or a taller film"
        )
    top = slab[:HALO]
    bot = slab[rows_local + HALO:]
    core = slab[HALO:rows_local + HALO]
    # dest i receives the next shard's top halo (rows it owns at its end)
    from_next = jax.lax.ppermute(
        top, axes, [(i + 1, i) for i in range(n_dev - 1)]
    )
    # dest i receives the previous shard's bottom halo (its first rows)
    from_prev = jax.lax.ppermute(
        bot, axes, [(i, i + 1) for i in range(n_dev - 1)]
    )
    core = core.at[rows_local - HALO:].add(from_next)
    core = core.at[:HALO].add(from_prev)
    return core


def make_mesh(devices=None):
    """1-D mesh over all (local or distributed) devices.

    For a multi-host slice, jax.devices() is globally ordered host-major,
    so contiguous shards are host-local (DCN only sees the reductions).
    """
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def make_mesh_2level(devices=None, n_hosts=None):
    """Explicit ('dcn', 'ici') 2-level mesh (SURVEY.md §2.8).

    Outer axis = hosts (cross-host DCN traffic), inner axis = chips within
    a host (ICI). jax.devices() is host-major, so a plain reshape puts
    each row of the mesh on one host. n_hosts defaults to
    jax.process_count() (1 in single-process runs — the inner axis then
    carries everything, which is exactly the single-host topology).
    """
    devices = devices if devices is not None else jax.devices()
    devices = np.asarray(devices)
    n_hosts = n_hosts or jax.process_count()
    if devices.size % n_hosts != 0:
        raise ValueError(
            f"{devices.size} devices do not split over {n_hosts} hosts"
        )
    return Mesh(devices.reshape(n_hosts, -1), ("dcn", "ici"))


def _axes(mesh):
    """All mesh axis names, outermost first — the reduction spec."""
    return tuple(mesh.axis_names)


def _check_divisible(height, n_dev, need_halo=False):
    if height % n_dev != 0:
        raise ValueError(
            f"image height {height} must divide by the mesh size {n_dev}"
        )
    if need_halo and height // n_dev < HALO:
        # _halo_exchange slices core[rows_local - HALO:]; fewer than HALO
        # rows per shard would make that a negative slice (shape error
        # downstream). Splat filters need >= HALO rows per shard.
        raise ValueError(
            f"splat filters need >= {HALO} rows per shard; "
            f"{height} rows / {n_dev} devices leaves {height // n_dev}"
        )


def render_sharded(scene, mesh=None, spp=None, seed=0):
    """Render with image rows sharded over the mesh (1-D or ('dcn','ici')).

    Returns a fully-replicated (H, W, 3) image (gathered once at the end —
    the analogue of result tiles streaming back to the 0.6 master).

    Non-box reconstruction filters splat with a footprint that crosses
    row-shard boundaries (ImageBlock border handling in the reference,
    mitsuba3 src/render/imageblock.cpp): each shard splats its lanes into
    a full-size accumulator and the weighted sums psum over the mesh —
    bit-for-bit the same estimator as the single-device splat.
    """
    mesh = mesh or make_mesh()
    axes = _axes(mesh)
    cfg = scene.config
    spp = spp or cfg.spp
    n_dev = mesh.devices.size
    _check_divisible(cfg.height, n_dev, need_halo=cfg.rfilter != "box")
    rows_local = cfg.height // n_dev
    lanes_local = rows_local * cfg.width * spp

    if cfg.rfilter == "box":

        @partial(
            jax.shard_map, mesh=mesh, in_specs=(P(),), out_specs=P(axes),
            check_vma=False,
        )
        def body(scene_rep):
            idx = jax.lax.axis_index(axes)
            offset = idx.astype(jnp.uint32) * jnp.uint32(lanes_local)
            L, _, _ = render_lanes(
                scene_rep, spp, jnp.uint32(seed),
                lane_offset=offset, n_lanes=lanes_local,
            )
            return film_mod.develop_box(L, rows_local, cfg.width, spp)

        return body(scene)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(),), out_specs=P(axes),
             check_vma=False)
    def body_splat(scene_rep):
        idx = jax.lax.axis_index(axes)
        offset = idx.astype(jnp.uint32) * jnp.uint32(lanes_local)
        L, film_xy, _ = render_lanes(
            scene_rep, spp, jnp.uint32(seed),
            lane_offset=offset, n_lanes=lanes_local,
        )
        # shard-local slab + halo exchange instead of a full-film psum
        y0 = idx.astype(jnp.int32) * rows_local - HALO
        img, wsum = film_mod.splat_slab(
            L, film_xy, y0, rows_local + 2 * HALO, cfg.height, cfg.width,
            film_mod.FILTER_NAMES[cfg.rfilter],
        )
        both = jnp.concatenate([img, wsum[..., None]], axis=-1)
        both = _halo_exchange(both, axes, n_dev, rows_local)
        img, wsum = both[..., :3], both[..., 3]
        return img / jnp.maximum(wsum, 1e-12)[..., None]

    return body_splat(scene)


def render_sharded_jit(scene, mesh=None, spp=None, seed=0):
    mesh = mesh or make_mesh()
    spp = int(spp or scene.config.spp)
    return _render_sharded_jit(scene, mesh, spp, jnp.uint32(seed))


@partial(jax.jit, static_argnums=(1, 2))
def _render_sharded_jit(scene, mesh, spp, seed):
    return render_sharded(scene, mesh, spp, seed)


def loss_and_grad_sharded(scene, params, target, mesh=None, spp=None, seed=0):
    """Distributed MSE loss + parameter gradients (any rfilter).

    Each shard renders its rows in ad_mode (path replay), differentiates
    the loss, and the per-parameter gradients (including the full
    BRDF-table gradient tensor) all-reduce with `psum` over the mesh —
    inserted inside the backward computation so XLA overlaps it with the
    remaining backward sweep (BASELINE north_star P6).

    Box filter: each shard's rows are disjoint, so the local losses psum.
    Splat filters: the shard's lanes scatter into a local row slab whose
    halo rows ppermute to the neighboring shards inside the
    differentiated function (same slab strategy as the forward path —
    the AD transpose of a ppermute is the reverse ppermute, routing each
    shard its own cotangent halo); local losses then psum.
    """
    mesh = mesh or make_mesh()
    axes = _axes(mesh)
    cfg = scene.config
    box = cfg.rfilter == "box"
    spp = int(spp or cfg.spp)
    n_dev = mesh.devices.size
    _check_divisible(cfg.height, n_dev, need_halo=not box)
    rows_local = cfg.height // n_dev
    lanes_local = rows_local * cfg.width * spp
    inv_n = 1.0 / (cfg.height * cfg.width * 3)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axes)),
        out_specs=(P(), P()),
        # check_vma=False: the traversal kernel's FFI call takes no part
        # in vma tracking. Without vma checking shard_map does NOT insert
        # the implicit psum for the replicated-params gradient — it is
        # EXPLICIT below.
        check_vma=False,
    )
    def body(scene_rep, params_rep, target_in):
        idx = jax.lax.axis_index(axes)
        offset = idx.astype(jnp.uint32) * jnp.uint32(lanes_local)

        def local_loss(p):
            scene_p = params_mod.update(scene_rep, p)
            L, film_xy, _ = render_lanes(
                scene_p, spp, jnp.uint32(seed),
                lane_offset=offset, n_lanes=lanes_local, ad_mode=True,
            )
            if box:
                img = film_mod.develop_box(L, rows_local, cfg.width, spp)
                return jnp.sum((img - target_in) ** 2) * inv_n
            y0 = idx.astype(jnp.int32) * rows_local - HALO
            img, wsum = film_mod.splat_slab(
                L, film_xy, y0, rows_local + 2 * HALO, cfg.height,
                cfg.width, film_mod.FILTER_NAMES[cfg.rfilter],
            )
            both = jnp.concatenate([img, wsum[..., None]], axis=-1)
            both = _halo_exchange(both, axes, n_dev, rows_local)
            img = both[..., :3] / jnp.maximum(both[..., 3], 1e-12)[..., None]
            # rows are shard-local; the per-shard partial losses psum below
            return jnp.sum((img - target_in) ** 2) * inv_n

        loss, grads = jax.value_and_grad(local_loss)(params_rep)
        loss = jax.lax.psum(loss, axes)
        # With check_vma=False the AD transpose of the replicated-params
        # broadcast does NOT insert the reduction — each shard holds its
        # local partial gradient here. The explicit psum IS the gradient
        # all-reduce (P6); XLA's latency-hiding scheduler overlaps it
        # with the rest of the backward sweep.
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, axes), grads
        )
        return loss, grads

    return body(scene, params, target)


@partial(jax.jit, static_argnums=(3, 4))
def loss_and_grad_sharded_jit(scene, params, target, mesh, spp, seed):
    return loss_and_grad_sharded(scene, params, target, mesh, spp, seed)


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None):
    """Multi-host bring-up (jax.distributed) — replaces mtssrv's TCP
    handshake (SURVEY.md §2.8). No-op when running single-process.

    MUST run before any JAX computation initializes the backend — in
    particular before importing mitsuba_customization_tpu render modules
    (some build device constants at import). Tested by
    tests/test_distributed.py through a 2-process localhost loopback (the
    mtssrv-on-localhost pattern, SURVEY.md §4.2).
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
