"""Differentiable scene parameters: traverse / update.

Counterpart of mitsuba3's mi.traverse + SceneParameters
(SURVEY.md §2.5): a flat dict of the scene's differentiable leaves, plus an
`update` that writes modified leaves back and re-propagates derived state —
most importantly rebuilding the MERL luminance-sampling CDFs after a table
change (parameters_changed in the reference, SURVEY.md §3.5).

Keys follow the reference's dotted style:
    bsdf.<kernel>.<field>       e.g. bsdf.roughconductor.alpha_u
    bsdf.tabulated.table        the stacked (n_mat, n_th, n_td, n_pd, 3)
                                measured-BRDF tensor (MERL + custom)
    emitter.radiance            (K, 3) emitter radiances/intensities
    emitter.env_image           envmap bitmap
All update paths are jittable so the optimization step stays fused.
"""

from __future__ import annotations

import dataclasses

from mitsuba_customization_tpu.models import bsdf as bsdf_mod
from mitsuba_customization_tpu.models.tabulated import TabulatedBRDF


def traverse(scene):
    """Collect the differentiable parameter dict from a Scene."""
    params = {}
    for kid, stack in scene.bsdfs.stacks.items():
        kname = bsdf_mod.KERNEL_NAMES[kid]
        if kid == bsdf_mod.TABULATED:
            params[f"bsdf.{kname}.table"] = stack.table
        else:
            for field, value in zip(stack._fields, stack):
                # only float leaves are parameters (texture slot/dims
                # bindings and other int fields are structural)
                if hasattr(value, "dtype") and value.dtype.kind == "f":
                    params[f"bsdf.{kname}.{field}"] = value
    params["emitter.radiance"] = scene.emitters.radiance
    if int(scene.emitters.env_index) >= 0:
        params["emitter.env_image"] = scene.emitters.env_image
    if scene.media.n_media:
        # medium leaves (prbvolpath-class inverse rendering — round-2
        # verdict item 6): extinction, albedo, phase anisotropy, density
        params["medium.sigma_t"] = scene.media.sigma_t
        params["medium.albedo"] = scene.media.albedo
        params["medium.phase_g"] = scene.media.phase_g
        params["medium.density"] = scene.media.grid
    return params


def update(scene, params):
    """Write (possibly modified) params back into a new Scene.

    Rebuilds derived sampling state: tabulated-BRDF CDFs (from the new
    table) and the envmap distribution (from the new bitmap). Jittable.
    """
    stacks = dict(scene.bsdfs.stacks)
    for kid in list(stacks):
        kname = bsdf_mod.KERNEL_NAMES[kid]
        if kid == bsdf_mod.TABULATED:
            key = f"bsdf.{kname}.table"
            if key in params:
                stacks[kid] = TabulatedBRDF.build_stack(params[key])
        else:
            fields = {}
            changed = False
            for field, value in zip(stacks[kid]._fields, stacks[kid]):
                key = f"bsdf.{kname}.{field}"
                if key in params:
                    fields[field] = params[key]
                    changed = True
                else:
                    fields[field] = value
            if changed:
                stacks[kid] = type(stacks[kid])(**fields)
    bsdfs = scene.bsdfs._replace(stacks=stacks)

    emitters = scene.emitters
    if "emitter.radiance" in params:
        emitters = emitters._replace(radiance=params["emitter.radiance"])
    if "emitter.env_image" in params:
        from mitsuba_customization_tpu.render.emitters import (
            build_env_distribution,
        )

        img = params["emitter.env_image"]
        emitters = emitters._replace(
            env_image=img, env_dist=build_env_distribution(img)
        )

    media = scene.media
    med_changed = False
    for key, field in (
        ("medium.sigma_t", "sigma_t"),
        ("medium.albedo", "albedo"),
        ("medium.phase_g", "phase_g"),
        ("medium.density", "grid"),
    ):
        if key in params:
            media = media._replace(**{field: params[key]})
            med_changed = True
    if med_changed:
        from mitsuba_customization_tpu.render.medium import (
            recompute_majorant,
        )

        media = media._replace(majorant=recompute_majorant(media))

    return dataclasses.replace(
        scene, bsdfs=bsdfs, emitters=emitters, media=media
    )
