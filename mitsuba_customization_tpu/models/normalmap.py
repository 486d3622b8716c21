"""Normal/bump mapping: per-material shading-frame perturbation.

Counterpart of mitsuba3 src/bsdfs/{normalmap,bumpmap}.cpp
(SURVEY.md §2.4). In the reference these are wrapper BSDFs that rotate the
shading frame before delegating; here the perturbation applies once per
interaction in the integrator (apply_normal_maps) using a per-material
binding in the BSDFTable — the wrapped child keeps its own kernel id, so
the static dispatch table is untouched.

Bump maps compile to normal maps at scene build (finite-difference height
gradient), which is exactly how the reference's bumpmap evaluates its
height texture derivatives.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.frame import Frame
from mitsuba_customization_tpu.models import texture as tex_mod


def bump_to_normal(height, scale=1.0):
    """(H, W) height bitmap -> (H, W, 3) tangent-space normal map in the
    usual [0,1]-encoded convention (0.5, 0.5, 1) = unperturbed."""
    h = np.asarray(height, np.float32)
    if h.ndim == 3:
        h = h.mean(-1)
    gy, gx = np.gradient(h)
    n = np.stack(
        [-gx * scale * h.shape[1], -gy * scale * h.shape[0],
         np.ones_like(h)],
        axis=-1,
    )
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)


def apply_normal_maps(bsdfs, si):
    """Perturb si's shading frame for lanes whose material binds a normal
    map. Returns the updated SurfaceInteraction (wi re-localized).

    bsdfs.normal_tex: TextureStack of normal maps; bsdfs.nm_slot: (M,)
    int32 binding (-1 = none).
    """
    if bsdfs.normal_tex is None:
        return si
    slot = bsdfs.nm_slot[si.mat_id]
    has = (slot >= 0) & si.valid
    enc = tex_mod.eval(bsdfs.normal_tex, jnp.maximum(slot, 0), si.uv)
    n_local = m.normalize(enc * 2.0 - 1.0)
    n_world = m.normalize(si.frame.to_world(n_local))
    n_new = jnp.where(has[..., None], n_world, si.frame.n)
    frame = Frame.from_normal(n_new)
    wi_world = si.frame.to_world(si.wi)
    wi_new = frame.to_local(wi_world)
    return si._replace(frame=frame, wi=wi_new)
