"""BVH: host-side binned-SAH build + lock-step skip-link traversal.

Replacement for the reference's acceleration layer (SURVEY.md
§2.3 L3: Embree BVH / OptiX GAS / native kd-tree). Design (SURVEY.md §7.1,
§7.3 item 1):

* Build on host with numpy (binned SAH, leaf <= LEAF_SIZE prims), flatten
  to int32/float32 arrays in *depth-first* order with **skip links**: every
  node stores the index of the node to visit when its subtree is done or
  its box is missed. Traversal then needs no stack — each ray carries a
  single node cursor, and all rays advance in lock-step inside one
  `lax.while_loop` (no divergence beyond per-lane masking). The same
  arrays are walked one ray per thread by ops/traverse.py.
* Leaves hold LEAF_SIZE primitive slots (padded with -1) so the leaf test
  is a static unrolled masked loop — no dynamic shapes under jit.
* `native/` provides an optional C++ builder for big scenes (same array
  contract); the numpy builder is the reference implementation.
"""

from __future__ import annotations

from typing import NamedTuple

import sys

import jax
import jax.numpy as jnp
import numpy as np

from mitsuba_customization_tpu.render import geometry as geo
from mitsuba_customization_tpu.render.records import Ray

LEAF_SIZE = 4
N_BINS = 16


class BVH(NamedTuple):
    """Flattened BVH in depth-first order with skip links.

    bb_min/bb_max: (N, 3) node bounds
    skip:          (N,) node to jump to on miss / after a leaf
    leaf_prims:    (N, LEAF_SIZE) primitive ids, -1 padded; all -1 for
                   internal nodes (their 'prims' are the children that
                   follow in depth-first order)
    """

    bb_min: jnp.ndarray
    bb_max: jnp.ndarray
    skip: jnp.ndarray
    leaf_prims: jnp.ndarray

    @property
    def n_nodes(self):
        return self.skip.shape[0]


def build(geom: geo.Geometry) -> BVH:
    """Binned-SAH BVH over the primitive soup.

    Uses the native C++ builder (native/mct_native.cpp, same array
    contract) when available; the numpy builder below is the reference
    implementation and fallback."""
    bb_min, bb_max = geo.aabbs(geom)

    from mitsuba_customization_tpu import native

    if native.available():
        nodes_min, nodes_max, skip_arr, leaf = native.build_bvh(
            np.asarray(bb_min), np.asarray(bb_max), LEAF_SIZE, N_BINS
        )
        return BVH(
            bb_min=jnp.asarray(nodes_min),
            bb_max=jnp.asarray(nodes_max),
            skip=jnp.asarray(skip_arr),
            leaf_prims=jnp.asarray(leaf),
        )

    bb_min = np.asarray(bb_min, dtype=np.float64)
    bb_max = np.asarray(bb_max, dtype=np.float64)
    centroid = 0.5 * (bb_min + bb_max)
    n = bb_min.shape[0]

    nodes_min, nodes_max, nodes_skip, nodes_leaf = [], [], [], []

    def emit(prim_ids) -> int:
        """Emit subtree for prim_ids depth-first; returns its root index.
        Skip links are patched after the subtree is emitted."""
        idx = len(nodes_min)
        lo = bb_min[prim_ids].min(0)
        hi = bb_max[prim_ids].max(0)
        nodes_min.append(lo)
        nodes_max.append(hi)
        nodes_skip.append(-1)  # patched by caller
        if len(prim_ids) <= LEAF_SIZE:
            leaf = np.full(LEAF_SIZE, -1, dtype=np.int64)
            leaf[: len(prim_ids)] = prim_ids
            nodes_leaf.append(leaf)
            return idx
        nodes_leaf.append(np.full(LEAF_SIZE, -1, dtype=np.int64))

        # Binned SAH along the widest centroid axis.
        c = centroid[prim_ids]
        ext = c.max(0) - c.min(0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            half = len(prim_ids) // 2  # degenerate: median split
            left_ids, right_ids = prim_ids[:half], prim_ids[half:]
        else:
            rel = (c[:, axis] - c[:, axis].min()) / ext[axis]
            bins = np.minimum((rel * N_BINS).astype(np.int64), N_BINS - 1)
            best_cost, best_split = np.inf, None
            counts = np.bincount(bins, minlength=N_BINS)
            # prefix/suffix box areas
            areas_l = np.empty(N_BINS)
            areas_r = np.empty(N_BINS)
            cur_min = np.full(3, np.inf)
            cur_max = np.full(3, -np.inf)
            for b in range(N_BINS):
                sel = bins == b
                if sel.any():
                    cur_min = np.minimum(cur_min, bb_min[prim_ids][sel].min(0))
                    cur_max = np.maximum(cur_max, bb_max[prim_ids][sel].max(0))
                e = np.maximum(cur_max - cur_min, 0)
                areas_l[b] = (
                    2 * (e[0] * e[1] + e[1] * e[2] + e[0] * e[2])
                    if np.isfinite(e).all()
                    else np.inf
                )
            cur_min[:] = np.inf
            cur_max[:] = -np.inf
            for b in range(N_BINS - 1, -1, -1):
                sel = bins == b
                if sel.any():
                    cur_min = np.minimum(cur_min, bb_min[prim_ids][sel].min(0))
                    cur_max = np.maximum(cur_max, bb_max[prim_ids][sel].max(0))
                e = np.maximum(cur_max - cur_min, 0)
                areas_r[b] = (
                    2 * (e[0] * e[1] + e[1] * e[2] + e[0] * e[2])
                    if np.isfinite(e).all()
                    else np.inf
                )
            cum = np.cumsum(counts)
            for split in range(N_BINS - 1):
                nl, nr = cum[split], len(prim_ids) - cum[split]
                if nl == 0 or nr == 0:
                    continue
                cost = areas_l[split] * nl + areas_r[split + 1] * nr
                if cost < best_cost:
                    best_cost, best_split = cost, split
            if best_split is None:
                order = np.argsort(c[:, axis], kind="stable")
                half = len(prim_ids) // 2
                left_ids = prim_ids[order[:half]]
                right_ids = prim_ids[order[half:]]
            else:
                sel_l = bins <= best_split
                left_ids = prim_ids[sel_l]
                right_ids = prim_ids[~sel_l]

        emit(left_ids)
        emit(right_ids)
        return idx

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        if n > 0:
            emit(np.arange(n, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(nodes_min)
    bbmin = np.asarray(nodes_min, dtype=np.float32).reshape(n_nodes, 3)
    bbmax = np.asarray(nodes_max, dtype=np.float32).reshape(n_nodes, 3)
    leaf = np.asarray(nodes_leaf, dtype=np.int32).reshape(n_nodes, LEAF_SIZE)

    # Compute skip links from depth-first structure: skip[i] = index of the
    # first node that is not in i's subtree. Subtree extents are recovered
    # by walking with an explicit stack over the implicit DFS layout.
    skip = np.full(n_nodes, n_nodes, dtype=np.int32)
    # Recover subtree sizes: leaves occupy 1 node; internal nodes span
    # until their skip. Walk with a stack of "open" internal nodes.
    is_leaf = (leaf[:, 0] >= 0) if n_nodes else np.zeros(0, bool)
    # children counts: we know structure: internal node i has left child
    # i+1; right child = skip of left subtree. Reconstruct via recursion
    # mirror:
    sizes = np.ones(n_nodes, dtype=np.int64)

    def subtree_size(i):
        if is_leaf[i]:
            return 1
        ls = subtree_size(i + 1)
        rs = subtree_size(i + 1 + ls)
        sizes[i] = 1 + ls + rs
        return sizes[i]

    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        if n_nodes:
            subtree_size(0)
    finally:
        sys.setrecursionlimit(old_limit)

    def assign_skip(i, skip_to):
        skip[i] = skip_to
        if not is_leaf[i]:
            left = i + 1
            right = i + 1 + sizes[left]
            assign_skip(left, right)  # miss left subtree -> go right
            assign_skip(right, skip_to)

    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        if n_nodes:
            assign_skip(0, n_nodes)
    finally:
        sys.setrecursionlimit(old_limit)

    return BVH(
        bb_min=jnp.asarray(bbmin),
        bb_max=jnp.asarray(bbmax),
        skip=jnp.asarray(skip),
        leaf_prims=jnp.asarray(leaf),
    )


def _slab_test(bb_min, bb_max, o, inv_d, t_best):
    """Ray-AABB slab test; returns hit mask."""
    t0 = (bb_min - o) * inv_d
    t1 = (bb_max - o) * inv_d
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    near = jnp.max(tmin, axis=-1)
    far = jnp.min(tmax, axis=-1)
    return (near <= far) & (far > 0.0) & (near < t_best)


def intersect(bvh: BVH, geom: geo.Geometry, ray: Ray):
    """Nearest-hit traversal, lock-step over all rays.

    Returns (t, prim, u, v) like geometry.intersect_brute.
    """
    n_nodes = bvh.n_nodes
    inv_d = 1.0 / jnp.where(jnp.abs(ray.d) < 1e-12, 1e-12, ray.d)

    def cond(state):
        node, t, prim, u, v = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, t_best, prim_best, u_best, v_best = state
        nsafe = jnp.minimum(node, n_nodes - 1)
        active = node < n_nodes
        bbmin = bvh.bb_min[nsafe]
        bbmax = bvh.bb_max[nsafe]
        hit_box = _slab_test(bbmin, bbmax, ray.o, inv_d, t_best) & active
        leaf = bvh.leaf_prims[nsafe]  # (..., LEAF_SIZE)
        is_leaf = leaf[..., 0] >= 0

        # Test leaf primitives (static unroll, masked).
        for i in range(LEAF_SIZE):
            pid = leaf[..., i]
            pvalid = hit_box & is_leaf & (pid >= 0)
            psafe = jnp.maximum(pid, 0)
            t_i, u_i, v_i = geo._intersect_prims(geom, ray.o, ray.d, psafe)
            closer = pvalid & (t_i < t_best) & (t_i < ray.maxt)
            t_best = jnp.where(closer, t_i, t_best)
            prim_best = jnp.where(closer, psafe, prim_best)
            u_best = jnp.where(closer, u_i, u_best)
            v_best = jnp.where(closer, v_i, v_best)

        descend = hit_box & jnp.logical_not(is_leaf)
        nxt = jnp.where(descend, nsafe + 1, bvh.skip[nsafe])
        node = jnp.where(active, nxt, node)
        return node, t_best, prim_best, u_best, v_best

    n = ray.o.shape[:-1]
    state0 = (
        jnp.zeros(n, dtype=jnp.int32),
        jnp.broadcast_to(ray.maxt, n),
        jnp.full(n, -1, dtype=jnp.int32),
        jnp.zeros(n),
        jnp.zeros(n),
    )
    node, t, prim, u, v = jax.lax.while_loop(cond, body, state0)
    miss = prim < 0
    return jnp.where(miss, jnp.inf, t), prim, u, v


def occluded(bvh: BVH, geom: geo.Geometry, ray: Ray):
    """Shadow-ray any-hit traversal (rtcOccluded semantics, mitsuba3
    scene_embree.inl Scene::ray_test).

    Unlike `intersect`, a lane terminates the moment *any* primitive with
    t < maxt is found: its cursor jumps past the end, so the lock-step
    while_loop exits as soon as every lane has either a hit or an
    exhausted tree — roughly half the traversal work of a nearest-hit
    pass on NEE-heavy workloads.
    """
    n_nodes = bvh.n_nodes
    inv_d = 1.0 / jnp.where(jnp.abs(ray.d) < 1e-12, 1e-12, ray.d)
    maxt = jnp.broadcast_to(ray.maxt, ray.o.shape[:-1])

    def cond(state):
        node, hit = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, hit = state
        nsafe = jnp.minimum(node, n_nodes - 1)
        active = node < n_nodes
        hit_box = _slab_test(
            bvh.bb_min[nsafe], bvh.bb_max[nsafe], ray.o, inv_d, maxt
        ) & active
        leaf = bvh.leaf_prims[nsafe]
        is_leaf = leaf[..., 0] >= 0

        new_hit = hit
        for i in range(LEAF_SIZE):
            pid = leaf[..., i]
            pvalid = hit_box & is_leaf & (pid >= 0)
            psafe = jnp.maximum(pid, 0)
            t_i, _, _ = geo._intersect_prims(geom, ray.o, ray.d, psafe)
            new_hit = new_hit | (pvalid & (t_i < maxt))

        descend = hit_box & jnp.logical_not(is_leaf)
        nxt = jnp.where(descend, nsafe + 1, bvh.skip[nsafe])
        # early-out: a hit lane leaves the traversal entirely
        nxt = jnp.where(new_hit, n_nodes, nxt)
        node = jnp.where(active, nxt, node)
        return node, new_hit

    n = ray.o.shape[:-1]
    state0 = (jnp.zeros(n, dtype=jnp.int32), jnp.zeros(n, dtype=bool))
    _, hit = jax.lax.while_loop(cond, body, state0)
    return hit
