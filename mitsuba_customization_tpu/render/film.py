"""Film + reconstruction filters: sample accumulation into the image.

Counterpart of mitsuba3 src/render/{imageblock,film}.cpp +
src/films/hdrfilm.cpp + src/rfilters/ (SURVEY.md §2.3/§2.4). The reference
scatters weighted splats atomically (ImageBlock::put via scatter_reduce);
here rays are pixel-major so box filtering is a reshape-mean, and wider
filters (gaussian/tent/mitchell/lanczos) splat into the 3x3 pixel
neighborhood with jnp scatter-adds (the only cross-lane op, as in
SURVEY.md §3.1).
"""

from __future__ import annotations

import jax.numpy as jnp

BOX = 0
GAUSSIAN = 1
TENT = 2
MITCHELL = 3
CATMULLROM = 4
LANCZOS = 5

FILTER_NAMES = {
    "box": BOX,
    "gaussian": GAUSSIAN,
    "tent": TENT,
    "mitchell": MITCHELL,
    "catmullrom": CATMULLROM,
    "lanczos": LANCZOS,
}


def _filter_weight(filter_type, dx, dy):
    """Evaluate the reconstruction filter at offset (dx, dy) pixels."""
    if filter_type == BOX:
        return ((jnp.abs(dx) <= 0.5) & (jnp.abs(dy) <= 0.5)).astype(dx.dtype)
    if filter_type == GAUSSIAN:
        # std = 0.5, radius 2 (hdrfilm default gaussian)
        s2 = 2.0 * 0.5 * 0.5
        return jnp.exp(-(dx * dx + dy * dy) / s2)
    if filter_type == TENT:
        return jnp.maximum(0.0, 1.0 - jnp.abs(dx)) * jnp.maximum(
            0.0, 1.0 - jnp.abs(dy)
        )

    def mitchell_1d(x, b, c):
        x = jnp.abs(x)
        x2, x3 = x * x, x * x * x
        p1 = (12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)
        p2 = (
            (-b - 6 * c) * x3
            + (6 * b + 30 * c) * x2
            + (-12 * b - 48 * c) * x
            + (8 * b + 24 * c)
        )
        return jnp.where(x < 1.0, p1, jnp.where(x < 2.0, p2, 0.0)) / 6.0

    if filter_type == MITCHELL:
        return mitchell_1d(dx, 1 / 3, 1 / 3) * mitchell_1d(dy, 1 / 3, 1 / 3)
    if filter_type == CATMULLROM:
        return mitchell_1d(dx, 0.0, 0.5) * mitchell_1d(dy, 0.0, 0.5)
    if filter_type == LANCZOS:

        def lanczos_1d(x, a=2.0):
            x = jnp.abs(x)
            pix = jnp.pi * jnp.maximum(x, 1e-6)
            val = a * jnp.sin(pix) * jnp.sin(pix / a) / (pix * pix)
            return jnp.where(x < 1e-6, 1.0, jnp.where(x < a, val, 0.0))

        return lanczos_1d(dx) * lanczos_1d(dy)
    raise ValueError(f"unknown filter {filter_type}")


def develop(
    values, pixel_xy, height, width, filter_type=BOX, spp=None
):
    """Accumulate per-lane radiance into an (H, W, 3) image.

    values:   (N, 3) radiance samples
    pixel_xy: (N, 2) continuous film positions in pixels (x, y)
    filter_type: static int (see FILTER_NAMES)

    Box filter with pixel-major lanes is handled by the caller via reshape;
    this general path splats into the 3x3 neighborhood (radius-1.5 support
    covers gaussian(0.5)/tent; mitchell/lanczos tails are truncated — same
    tradeoff mitsuba3 makes with its default radii).
    """
    img, wsum = splat(values, pixel_xy, height, width, filter_type)
    return img / jnp.maximum(wsum, 1e-12)[..., None]


def splat(values, pixel_xy, height, width, filter_type):
    """Raw weighted splat sums (img, wsum) — accumulate across passes,
    normalize at develop time (ImageBlock::put semantics)."""
    img = jnp.zeros((height, width, 3), dtype=values.dtype)
    wsum = jnp.zeros((height, width), dtype=values.dtype)
    px = pixel_xy[..., 0]
    py = pixel_xy[..., 1]
    ix = jnp.floor(px - 0.5).astype(jnp.int32)
    iy = jnp.floor(py - 0.5).astype(jnp.int32)
    for oy in range(-1, 2):
        for ox in range(-1, 2):
            tx = ix + ox
            ty = iy + oy
            dx = (tx.astype(px.dtype) + 0.5) - px
            dy = (ty.astype(py.dtype) + 0.5) - py
            w = _filter_weight(filter_type, dx, dy)
            inside = (tx >= 0) & (tx < width) & (ty >= 0) & (ty < height)
            w = jnp.where(inside, w, 0.0)
            txs = jnp.clip(tx, 0, width - 1)
            tys = jnp.clip(ty, 0, height - 1)
            img = img.at[tys, txs].add(values * w[..., None])
            wsum = wsum.at[tys, txs].add(w)
    return img, wsum


def splat_slab(values, pixel_xy, y0, rows, height, width, filter_type):
    """`splat` into a local row slab [y0, y0 + rows) of the full film.

    The sharded splat path (parallel/mesh.py) gives each device a slab
    covering its own rows plus a halo; y0 may be a traced per-shard
    value. Rows outside [0, height) (or outside the slab) are dropped —
    identical estimator to the full-film splat once halos are summed.
    """
    img = jnp.zeros((rows, width, 3), dtype=values.dtype)
    wsum = jnp.zeros((rows, width), dtype=values.dtype)
    px = pixel_xy[..., 0]
    py = pixel_xy[..., 1]
    ix = jnp.floor(px - 0.5).astype(jnp.int32)
    iy = jnp.floor(py - 0.5).astype(jnp.int32)
    for oy in range(-1, 2):
        for ox in range(-1, 2):
            tx = ix + ox
            ty = iy + oy
            dx = (tx.astype(px.dtype) + 0.5) - px
            dy = (ty.astype(py.dtype) + 0.5) - py
            w = _filter_weight(filter_type, dx, dy)
            tyl = ty - y0
            inside = (
                (tx >= 0) & (tx < width)
                & (ty >= 0) & (ty < height)
                & (tyl >= 0) & (tyl < rows)
            )
            w = jnp.where(inside, w, 0.0)
            txs = jnp.clip(tx, 0, width - 1)
            tys = jnp.clip(tyl, 0, rows - 1)
            img = img.at[tys, txs].add(values * w[..., None])
            wsum = wsum.at[tys, txs].add(w)
    return img, wsum


def develop_box(values, height, width, spp):
    """Fast path: lanes are pixel-major (H*W*spp ordering), box filter =
    mean over the spp axis. The default for every baseline config.
    Channel count is free (3 for radiance; 6 for the moment integrator)."""
    c = values.shape[-1]
    return values.reshape(height, width, spp, c).mean(axis=2)


def develop_box_blocked(values, height, width, spp, block):
    """develop_box for block-ordered lanes (render/integrator._BLOCK):
    lane layout (by, bx, y_in_block, x_in_block, spp, c) -> (H, W, c).
    Pure reshape+transpose."""
    c = values.shape[-1]
    v = values.reshape(
        height // block, width // block, block, block, spp, c
    ).mean(axis=4)
    return v.transpose(0, 2, 1, 3, 4).reshape(height, width, c)
