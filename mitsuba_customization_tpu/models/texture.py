"""Textures: bitmap (bilinear, wrap) + procedural checkerboard.

Counterpart of mitsuba3 src/textures/{bitmap,checkerboard}.cpp
(SURVEY.md §2.4 "Textures"). All bitmap textures of a scene stack into one
(T, H, W, 3) tensor (zero-padded to the max resolution, actual dims kept
per slot) gathered per lane at eval time — the same stacked-tensor pattern
as the MERL tables (models/tabulated.py), so lanes with different textures
stay in lock-step.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from mitsuba_customization_tpu.core import math as m

# texture types
CONSTANT = 0
BITMAP = 1
CHECKERBOARD = 2
MESH_ATTRIBUTE = 3  # barycentric vertex-attribute interpolation
VOLUME = 4          # 3-D grid sampled at the world hit position

# Texture-coordinate vector widths. Plain evaluation passes (..., 2) uv;
# mesh_attribute needs the hit's barycentrics + primitive id, volume
# textures the world position, so callers that may evaluate them pass the
# widened vector [u, v, bary_u, bary_v, float(prim), px, py, pz]
# (prim ids < 2^24 are exact in f32).
TC_FULL = 5
TC_VOL = 8


class TextureStack(NamedTuple):
    """Per-material texture bindings + the shared bitmap stack.

    tex_type: (M,) int32; value0/value1: (M, 3) (constant color / checker
    colors; mesh_attribute scale); uv_scale: (M, 2); slot: (M,) int32 into
    images; images: (T, H, W, 3); dims: (T, 2) int32 actual (H, W) per
    slot; attr: optional (P, 9) per-primitive corner attribute values
    [c0 | c1 | c2] shared by every mesh_attribute row (None when the
    scene declares no mesh attributes — a STATIC pytree fact callers
    branch on).
    """

    tex_type: jnp.ndarray
    value0: jnp.ndarray
    value1: jnp.ndarray
    uv_scale: jnp.ndarray
    slot: jnp.ndarray
    images: jnp.ndarray
    dims: jnp.ndarray
    attr: jnp.ndarray = None
    # volume-texture bindings (None when no VOLUME rows — structural gate):
    # vol_grid (Tv, D, H, W, 3) stacked rgb grids, vol_w2g (M, 3, 4) world
    # -> [0,1]^3 affine, vol_dims (M, 3) actual dims, vol_slot (M,)
    vol_grid: jnp.ndarray = None
    vol_w2g: jnp.ndarray = None
    vol_dims: jnp.ndarray = None
    vol_slot: jnp.ndarray = None


def build_stack(rows, attr=None):
    """rows: list of dicts {type, value0, value1, uv_scale, image|None,
    volume|None (D,H,W[,3]) + vol_to_world|None};
    attr: optional (P, 9) per-prim corner attribute table (mesh_attribute
    rows interpolate it barycentrically at eval)."""
    m_count = len(rows)
    tex_type = np.zeros(m_count, np.int32)
    value0 = np.zeros((m_count, 3), np.float32)
    value1 = np.zeros((m_count, 3), np.float32)
    uv_scale = np.ones((m_count, 2), np.float32)
    slot = np.zeros(m_count, np.int32)
    images = []
    max_h = max_w = 1
    volumes = []
    vol_w2g = np.zeros((m_count, 3, 4), np.float32)
    vol_dims = np.ones((m_count, 3), np.int32)
    vol_slot = np.zeros(m_count, np.int32)
    for i, row in enumerate(rows):
        tex_type[i] = row["type"]
        value0[i] = row.get("value0", (1, 1, 1))
        value1[i] = row.get("value1", (0, 0, 0))
        uv_scale[i] = row.get("uv_scale", (1, 1))
        img = row.get("image")
        if img is not None:
            slot[i] = len(images)
            img = np.asarray(img, np.float32)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            images.append(img[..., :3])
            max_h = max(max_h, img.shape[0])
            max_w = max(max_w, img.shape[1])
        vol = row.get("volume")
        if vol is not None:
            vol = np.asarray(vol, np.float32)
            if vol.ndim == 3:
                vol = np.repeat(vol[..., None], 3, axis=-1)
            vol_slot[i] = len(volumes)
            vol_dims[i] = vol.shape[:3]
            volumes.append(vol)
            to_w = (
                np.asarray(row["vol_to_world"], np.float64)
                if row.get("vol_to_world") is not None else np.eye(4)
            )
            inv = np.linalg.inv(to_w)
            vol_w2g[i, :, :3] = inv[:3, :3].astype(np.float32)
            vol_w2g[i, :, 3] = inv[:3, 3].astype(np.float32)
    if not images:
        images = [np.zeros((1, 1, 3), np.float32)]
    dims = np.asarray([im.shape[:2] for im in images], np.int32)
    padded = np.zeros((len(images), max_h, max_w, 3), np.float32)
    for t, im in enumerate(images):
        padded[t, : im.shape[0], : im.shape[1]] = im
    return TextureStack(
        tex_type=jnp.asarray(tex_type),
        value0=jnp.asarray(value0),
        value1=jnp.asarray(value1),
        uv_scale=jnp.asarray(uv_scale),
        slot=jnp.asarray(slot),
        images=jnp.asarray(padded),
        dims=jnp.asarray(dims),
        attr=None if attr is None else jnp.asarray(attr, jnp.float32),
        vol_grid=(
            None if not volumes else jnp.asarray(
                _pad_volumes(volumes), jnp.float32
            )
        ),
        vol_w2g=None if not volumes else jnp.asarray(vol_w2g),
        vol_dims=None if not volumes else jnp.asarray(vol_dims),
        vol_slot=None if not volumes else jnp.asarray(vol_slot),
    )


def _pad_volumes(volumes):
    md = max(v.shape[0] for v in volumes)
    mh = max(v.shape[1] for v in volumes)
    mw = max(v.shape[2] for v in volumes)
    out = np.zeros((len(volumes), md, mh, mw, 3), np.float32)
    for i, v in enumerate(volumes):
        out[i, : v.shape[0], : v.shape[1], : v.shape[2]] = v
    return out


def _bitmap_eval(stack: TextureStack, mat_slot, uv):
    """Bilinear, wrap addressing, v flipped (image row 0 = top, uv v=0 =
    bottom — mitsuba3 bitmap.cpp convention)."""
    s = stack.slot[mat_slot]
    hw = stack.dims[s]  # (..., 2)
    h = hw[..., 0].astype(jnp.float32)
    w = hw[..., 1].astype(jnp.float32)
    u = uv[..., 0] * stack.uv_scale[mat_slot, 0]
    v = uv[..., 1] * stack.uv_scale[mat_slot, 1]
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    fx = u * w - 0.5
    fy = (1.0 - v) * h - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = fx - x0
    ty = fy - y0
    hi = hw[..., 0]
    wi_ = hw[..., 1]

    def wrap(i, n):
        return jnp.mod(i, jnp.maximum(n, 1))

    def at(yi, xi):
        return stack.images[s, wrap(yi, hi), wrap(xi, wi_)]

    c00 = at(y0, x0)
    c01 = at(y0, x0 + 1)
    c10 = at(y0 + 1, x0)
    c11 = at(y0 + 1, x0 + 1)
    tx3 = tx[..., None]
    ty3 = ty[..., None]
    return (
        (1 - ty3) * ((1 - tx3) * c00 + tx3 * c01)
        + ty3 * ((1 - tx3) * c10 + tx3 * c11)
    )


def _checker_eval(stack: TextureStack, mat_slot, uv):
    su = uv[..., 0] * stack.uv_scale[mat_slot, 0] * 2.0
    sv = uv[..., 1] * stack.uv_scale[mat_slot, 1] * 2.0
    cell = (jnp.floor(su).astype(jnp.int32) + jnp.floor(sv).astype(jnp.int32))
    odd = (cell % 2) != 0
    return jnp.where(
        odd[..., None], stack.value1[mat_slot], stack.value0[mat_slot]
    )


def _mesh_attr_eval(stack: TextureStack, mat_slot, tc):
    """Barycentric interpolation of per-prim corner attributes — the
    mitsuba3 src/textures/mesh_attribute.cpp capability. tc carries
    [.., .., bary_u, bary_v, prim] (TC_FULL layout); vertex attributes
    are pre-gathered to per-prim corner rows at scene build, so eval is
    one (P, 9) gather + a barycentric blend."""
    prim = jnp.clip(
        tc[..., 4].astype(jnp.int32), 0, stack.attr.shape[0] - 1
    )
    c = stack.attr[prim]  # (..., 9)
    bu = tc[..., 2:3]
    bv = tc[..., 3:4]
    w = 1.0 - bu - bv
    val = w * c[..., 0:3] + bu * c[..., 3:6] + bv * c[..., 6:9]
    return val * stack.value0[mat_slot]


def eval(stack: TextureStack, mat_slot, uv):
    """Per-lane RGB texture value at uv for each lane's texture binding.

    uv: (..., 2) plain coordinates, or the widened (..., TC_FULL) vector
    when the caller can reach mesh_attribute rows (see TC_FULL)."""
    t = stack.tex_type[mat_slot]
    out = stack.value0[mat_slot]
    out = jnp.where(
        (t == BITMAP)[..., None], _bitmap_eval(stack, mat_slot, uv), out
    )
    out = jnp.where(
        (t == CHECKERBOARD)[..., None], _checker_eval(stack, mat_slot, uv), out
    )
    if stack.attr is not None and uv.shape[-1] >= TC_FULL:
        out = jnp.where(
            (t == MESH_ATTRIBUTE)[..., None],
            _mesh_attr_eval(stack, mat_slot, uv),
            out,
        )
    if stack.vol_grid is not None and uv.shape[-1] >= TC_VOL:
        out = jnp.where(
            (t == VOLUME)[..., None],
            _volume_eval(stack, mat_slot, uv[..., 5:8]),
            out,
        )
    return out


def _volume_eval(stack: TextureStack, mat_slot, p):
    """Trilinear 3-D grid lookup at world position p (mitsuba3
    src/textures/volume.cpp + volumes/gridvolume.cpp capability): the
    row's world->unit-cube affine maps p into its grid; outside [0,1]^3
    evaluates to value1 (a constant fill)."""
    w2g = stack.vol_w2g[mat_slot]  # (..., 3, 4)
    g = m.matvec(w2g[..., :3], p) + w2g[..., 3]
    dims = stack.vol_dims[mat_slot]
    slot = stack.vol_slot[mat_slot]
    d = dims[..., 0].astype(jnp.float32)
    h = dims[..., 1].astype(jnp.float32)
    w = dims[..., 2].astype(jnp.float32)
    fz = jnp.clip(g[..., 2], 0.0, 1.0) * (d - 1)
    fy = jnp.clip(g[..., 1], 0.0, 1.0) * (h - 1)
    fx = jnp.clip(g[..., 0], 0.0, 1.0) * (w - 1)
    z0 = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0,
                  jnp.maximum(dims[..., 0] - 2, 0))
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0,
                  jnp.maximum(dims[..., 1] - 2, 0))
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0,
                  jnp.maximum(dims[..., 2] - 2, 0))
    tz = (fz - z0)[..., None]
    ty = (fy - y0)[..., None]
    tx = (fx - x0)[..., None]
    z1 = jnp.minimum(z0 + 1, dims[..., 0] - 1)
    y1 = jnp.minimum(y0 + 1, dims[..., 1] - 1)
    x1 = jnp.minimum(x0 + 1, dims[..., 2] - 1)

    def at(zi, yi, xi):
        return stack.vol_grid[slot, zi, yi, xi]

    c0 = (at(z0, y0, x0) * (1 - tx) + at(z0, y0, x1) * tx) * (1 - ty) + (
        at(z0, y1, x0) * (1 - tx) + at(z0, y1, x1) * tx
    ) * ty
    c1 = (at(z1, y0, x0) * (1 - tx) + at(z1, y0, x1) * tx) * (1 - ty) + (
        at(z1, y1, x0) * (1 - tx) + at(z1, y1, x1) * tx
    ) * ty
    val = (c0 * (1 - tz) + c1 * tz) * stack.value0[mat_slot]
    inside = jnp.all((g >= 0.0) & (g <= 1.0), axis=-1)
    return jnp.where(inside[..., None], val, stack.value1[mat_slot])
