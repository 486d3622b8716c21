"""Static BSDF dispatch table — the replacement for Dr.Jit vcalls.

The reference dispatches BSDF::eval/sample/pdf through Dr.Jit vcalls over
instance arrays (SURVEY.md §2.2 "vcalls"); BASELINE.json north_star pins
the design: "Dr.Jit vcall -> static kernel table". This module is that
table: a fixed enum of BSDF kernels, per-lane material ids, and masked
run-all dispatch (few kernel types => every present kernel runs under a
lane mask in one fused program instead of lax.switch's serialization,
SURVEY.md §7.1).

Scene construction (render/scene.py) compiles material declarations into a
`BSDFTable`:
  * `mat_type[M]`, `mat_slot[M]` — per material instance, its kernel id and
    index into that kernel's parameter stack;
  * parameter stacks per kernel present in the scene (a dict pytree — keys
    static under jit);
  * tabulated BRDFs share one stacked (n_mat, n_th, n_td, n_pd, 3) tensor
    per resolution so lanes gather (slot, i, j, k) from device memory.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import jax
import jax.numpy as jnp

from mitsuba_customization_tpu.models import (
    conductor,
    dielectric,
    diffuse,
    passthrough,
    plastic,
    principled,
    roughconductor,
    roughdielectric,
    roughplastic,
    tabulated,
    textured_diffuse,
    thindielectric,
)

# Kernel enum — stable ids (cited in render/integrator.py dispatch).
DIFFUSE = 0
CONDUCTOR = 1
ROUGHCONDUCTOR = 2
DIELECTRIC = 3
TABULATED = 4  # MERL + customized_measurement (shared kernel)
NULL = 5  # pass-through (mitsuba3 src/bsdfs/null.cpp)
ROUGHCONDUCTOR_BECKMANN = 6  # same params, Beckmann NDF (static choice)
PLASTIC = 7
ROUGHPLASTIC = 8
TEXTURED_DIFFUSE = 9  # diffuse with bitmap/checkerboard reflectance
ROUGHDIELECTRIC = 10  # Walter 2007 microfacet transmission
THINDIELECTRIC = 11  # thin slab delta
PASSTHROUGH = 12  # delta transparency (mask's transparent component)
BLEND = 13  # two-child mixture (blendbsdf/mask) — resolved pre-dispatch
PRINCIPLED = 14  # Disney principled, opaque lobes (mitsuba3 principled.cpp)

KERNEL_NAMES = {
    DIFFUSE: "diffuse",
    CONDUCTOR: "conductor",
    ROUGHCONDUCTOR: "roughconductor",
    DIELECTRIC: "dielectric",
    TABULATED: "tabulated",
    NULL: "null",
    ROUGHCONDUCTOR_BECKMANN: "roughconductor_beckmann",
    PLASTIC: "plastic",
    ROUGHPLASTIC: "roughplastic",
    TEXTURED_DIFFUSE: "textured_diffuse",
    ROUGHDIELECTRIC: "roughdielectric",
    THINDIELECTRIC: "thindielectric",
    PASSTHROUGH: "passthrough",
    BLEND: "blend",
    PRINCIPLED: "principled",
}


class _BeckmannKernel:
    """roughconductor with the Beckmann NDF (static kernel variant)."""

    @staticmethod
    def eval(params, wi, wo):
        from mitsuba_customization_tpu.models import microfacet as mf

        return roughconductor.eval(params, wi, wo, dist_type=mf.BECKMANN)

    @staticmethod
    def pdf(params, wi, wo):
        from mitsuba_customization_tpu.models import microfacet as mf

        return roughconductor.pdf(params, wi, wo, dist_type=mf.BECKMANN)

    @staticmethod
    def sample(params, wi, sample2, sample1=None):
        from mitsuba_customization_tpu.models import microfacet as mf

        return roughconductor.sample(
            params, wi, sample2, sample1, dist_type=mf.BECKMANN
        )


_MODULES = {
    DIFFUSE: diffuse,
    CONDUCTOR: conductor,
    ROUGHCONDUCTOR: roughconductor,
    DIELECTRIC: dielectric,
    TABULATED: tabulated,
    ROUGHCONDUCTOR_BECKMANN: _BeckmannKernel,
    PLASTIC: plastic,
    ROUGHPLASTIC: roughplastic,
    TEXTURED_DIFFUSE: textured_diffuse,
    ROUGHDIELECTRIC: roughdielectric,
    THINDIELECTRIC: thindielectric,
    PASSTHROUGH: passthrough,
    PRINCIPLED: principled,
}

# Kernels whose sample() is a Dirac delta (NEE skips them; no MIS weight).
DELTA_KERNELS = frozenset(
    [CONDUCTOR, DIELECTRIC, NULL, THINDIELECTRIC, PASSTHROUGH]
)
# Kernels that can transmit (two-sided transport).
TRANSMISSIVE_KERNELS = frozenset(
    [DIELECTRIC, NULL, ROUGHDIELECTRIC, THINDIELECTRIC, PASSTHROUGH]
)


class BSDFTable(NamedTuple):
    """All materials of a scene, compiled for masked static dispatch.

    Blend materials (blendbsdf/mask — mitsuba3 src/bsdfs/{blendbsdf,mask}
    .cpp) carry kernel id BLEND plus two child material ids and a mixture
    weight; the public eval/pdf/sample resolve them to a one-sample
    balance-heuristic mixture over the children (children may not
    themselves be blends — enforced at scene compile). blend_* are None
    when the scene has no blends (static fast path).
    """

    mat_type: jnp.ndarray  # (M,) int32 kernel ids
    mat_slot: jnp.ndarray  # (M,) int32 index into the kernel's stack
    stacks: Dict[int, Any]  # kernel id -> stacked params pytree
    blend_a: Any = None  # (M,) int32 child id (self for non-blends)
    blend_b: Any = None  # (M,) int32
    blend_w: Any = None  # (M,) weight of child b
    normal_tex: Any = None  # TextureStack of normal maps (models/normalmap)
    nm_slot: Any = None  # (M,) int32 binding into normal_tex (-1 = none)

    @property
    def present_kernels(self):
        return sorted(self.stacks.keys())

    def is_delta(self, mat_id):
        """Per-lane: does this material sample a delta lobe?

        Blends count as delta only if both children are delta."""
        t = self.mat_type[mat_id]

        def kernel_delta(types):
            out = jnp.zeros(types.shape, dtype=bool)
            for k in DELTA_KERNELS:
                out = jnp.logical_or(out, types == k)
            return out

        out = kernel_delta(t)
        if self.blend_a is not None:
            is_b = t == BLEND
            da = kernel_delta(self.mat_type[self.blend_a[mat_id]])
            db = kernel_delta(self.mat_type[self.blend_b[mat_id]])
            out = jnp.where(is_b, da & db, out)
        return out

    def resolve_children(self, mat_id):
        """(child_a, child_b, w, is_blend): identity for non-blends."""
        t = self.mat_type[mat_id]
        is_b = t == BLEND
        a = jnp.where(is_b, self.blend_a[mat_id], mat_id)
        b = jnp.where(is_b, self.blend_b[mat_id], mat_id)
        w = jnp.where(is_b, self.blend_w[mat_id], 0.0)
        return a, b, w, is_b


def _gather_params(stack, slot):
    """Gather per-lane parameters from a stacked pytree (small params only)."""
    return jax.tree_util.tree_map(lambda a: a[slot], stack)


def _dispatch(table: BSDFTable, mat_id, fn_name, wi, *args, uv=None,
              **kwargs):
    """Masked run-all dispatch over the kernels present in the scene."""
    t = table.mat_type[mat_id]
    slot = table.mat_slot[mat_id]
    out = None
    for kid in table.present_kernels:
        if kid in (NULL, BLEND):
            continue
        mod = _MODULES[kid]
        mask = t == kid
        slot_safe = jnp.where(mask, slot, 0)
        if getattr(mod, "NEEDS_SLOT", kid == TABULATED):
            # Big stacked tensors (MERL tables, texture atlases): slot-aware
            # gather inside the kernel, never materialized per lane. The
            # lane mask lets the kernel clamp masked-out lanes to slot 0
            # and zero their output (run-all-mask dispatch evaluates every
            # lane).
            extra = dict(kwargs)
            if getattr(mod, "NEEDS_UV", False):
                extra["uv"] = uv
            if getattr(mod, "NEEDS_MASK", False):
                extra["mask"] = mask
            res = getattr(mod, fn_name)(
                table.stacks[kid], wi, *args, slot=slot_safe, **extra
            )
        else:
            params = _gather_params(table.stacks[kid], slot_safe)
            res = getattr(mod, fn_name)(params, wi, *args, **kwargs)
        if out is None:
            out = jax.tree_util.tree_map(jnp.zeros_like, res)
        out = jax.tree_util.tree_map(
            lambda o, r: jnp.where(
                mask.reshape(mask.shape + (1,) * (o.ndim - mask.ndim)), r, o
            ),
            out,
            res,
        )
    if out is None:  # scene with only null materials (media boundaries)
        shape = wi.shape[:-1]
        if fn_name == "eval":
            return jnp.zeros(shape + (3,))
        if fn_name == "pdf":
            return jnp.zeros(shape)
        if fn_name == "sample":
            return (
                jnp.zeros_like(wi),
                jnp.zeros(shape),
                jnp.zeros(shape + (3,)),
                jnp.zeros(shape, bool),
            )
        raise ValueError(f"unknown BSDF dispatch '{fn_name}'")
    return out


def eval(table: BSDFTable, mat_id, wi, wo, uv=None):
    """f(wi, wo) * cos(theta_o) for each lane's material."""
    if table.blend_a is None:
        return _dispatch(table, mat_id, "eval", wi, wo, uv=uv)
    a, b, w, _ = table.resolve_children(mat_id)
    f_a = _dispatch(table, a, "eval", wi, wo, uv=uv)
    f_b = _dispatch(table, b, "eval", wi, wo, uv=uv)
    return (1.0 - w)[..., None] * f_a + w[..., None] * f_b


def pdf(table: BSDFTable, mat_id, wi, wo, uv=None):
    if table.blend_a is None:
        return _dispatch(table, mat_id, "pdf", wi, wo, uv=uv)
    a, b, w, _ = table.resolve_children(mat_id)
    p_a = _dispatch(table, a, "pdf", wi, wo, uv=uv)
    p_b = _dispatch(table, b, "pdf", wi, wo, uv=uv)
    return (1.0 - w) * p_a + w * p_b


def sample(table: BSDFTable, mat_id, wi, sample2, sample1=None, uv=None):
    """Per-lane BSDF sampling -> (wo, pdf, weight, sampled_delta).

    sampled_delta is per *sample*, not per material: hybrid BSDFs (plastic)
    emit delta or smooth lobes lane by lane (BSDFSample3f.sampled_type in
    the reference).

    Blends: one-sample mixture — pick a child with probability equal to
    its mixture weight; smooth samples are re-weighted with the balance
    heuristic f_mix/p_mix, delta samples keep the child's analytic weight
    (selection probability cancels the mixture coefficient, as in
    mitsuba3 blendbsdf.cpp).
    """
    if table.blend_a is None:
        return _dispatch(table, mat_id, "sample", wi, sample2, sample1, uv=uv)
    a, b, w, is_blend = table.resolve_children(mat_id)
    if sample1 is None:
        sample1 = sample2[..., 0]
    pick_b = is_blend & (sample1 < w)
    child = jnp.where(pick_b, b, a)
    # rescale the lobe sample for the child's own lobe selection
    denom_a = jnp.maximum(1.0 - w, 1e-8)
    u1 = jnp.where(
        pick_b,
        sample1 / jnp.maximum(w, 1e-8),
        jnp.where(is_blend, (sample1 - w) / denom_a, sample1),
    )
    u1 = jnp.clip(u1, 0.0, 1.0 - 1e-7)
    wo, p_c, w_c, delta_c = _dispatch(
        table, child, "sample", wi, sample2, u1, uv=uv
    )
    # balance-heuristic reweighting for smooth samples on blend lanes
    f_mix = eval(table, mat_id, wi, wo, uv=uv)
    p_mix = pdf(table, mat_id, wi, wo, uv=uv)
    import mitsuba_customization_tpu.core.math as _m

    w_bal = _m.safe_div(f_mix, p_mix[..., None])
    sel = jnp.where(pick_b, w, jnp.where(is_blend, 1.0 - w, 1.0))
    use_bal = is_blend & jnp.logical_not(delta_c)
    weight = jnp.where(use_bal[..., None], w_bal, w_c)
    p_out = jnp.where(
        use_bal, p_mix, jnp.where(is_blend, p_c * sel, p_c)
    )
    ok = p_out > 0.0
    return (
        wo,
        jnp.where(ok, p_out, 0.0),
        jnp.where(ok[..., None], weight, 0.0),
        delta_c,
    )


def eval_pdf(table: BSDFTable, mat_id, wi, wo, uv=None):
    """Fused eval+pdf (BSDF::eval_pdf) — one dispatch pass for NEE."""
    f = eval(table, mat_id, wi, wo, uv=uv)
    p = pdf(table, mat_id, wi, wo, uv=uv)
    return f, p


def bounce_shade(table: BSDFTable, mat_id, wi, wo_nee, sample2, sample1=None,
                 uv=None, need_attached=False, has_nee=True, active=None,
                 nee_mask=None):
    """All BSDF work of one path-tracer bounce in one dispatch pass.

    Fuses {eval_pdf(wi, wo_nee), sample(wi, u), eval(wi, wo_sampled)} —
    the three per-bounce BSDF dispatches of the round-2 integrator — into
    one masked run-all pass so each kernel runs exactly once per bounce.
    The tabulated kernel shares work across the three
    (models/tabulated.bounce_shade: shared CDF row fetches + ONE combined
    2N-lane trilinear eval); analytic kernels compose the same three calls
    they always ran.

    Returns (f_nee, pdf_nee, wo, pdf_s, weight, is_delta, f_att) where
    f_att is the attached eval at the sampled wo (for the ad_mode detached
    estimator; None when need_attached=False). Scenes with blend materials
    fall back to the public eval/pdf/sample composition.

    nee_mask: lanes whose NEE sample is live AND unoccluded — the
    integrator traces the shadow ray BEFORE shading so occluded lanes
    never enter the (expensive, sorted) tabulated NEE eval; their f_nee /
    pdf_nee come back 0, which the contribution gate zeroes anyway.
    Analytic kernels evaluate regardless (no per-lane cost to save).
    """
    if table.blend_a is not None:
        # blends resolve through the public API (mixture bookkeeping)
        wo, p_s, weight, is_delta = sample(
            table, mat_id, wi, sample2, sample1, uv=uv
        )
        if has_nee:
            f_nee, p_nee = eval_pdf(table, mat_id, wi, wo_nee, uv=uv)
        else:
            f_nee = jnp.zeros_like(weight)
            p_nee = jnp.zeros_like(p_s)
        f_att = (
            eval(table, mat_id, wi, jax.lax.stop_gradient(wo), uv=uv)
            if need_attached else None
        )
        return f_nee, p_nee, wo, p_s, weight, is_delta, f_att

    t = table.mat_type[mat_id]
    slot = table.mat_slot[mat_id]
    shape = wi.shape[:-1]
    out = None
    for kid in table.present_kernels:
        if kid in (NULL, BLEND):
            continue
        mod = _MODULES[kid]
        mask = t == kid
        if active is not None:
            # dead lanes cost no sorted-kernel segments (their keys go to
            # the sentinel tail); their outputs are garbage but every
            # integrator consumer is gated on `active`
            mask = mask & active
        slot_safe = jnp.where(mask, slot, 0)
        if getattr(mod, "NEEDS_SLOT", kid == TABULATED) and hasattr(
            mod, "bounce_shade"
        ):
            m_nee = mask if has_nee else jnp.zeros_like(mask)
            if has_nee and nee_mask is not None:
                m_nee = m_nee & nee_mask
            f_nee, p_nee, wo, p_s, weight, is_delta = mod.bounce_shade(
                table.stacks[kid], wi, wo_nee, sample2, sample1,
                slot=slot_safe, mask=mask, mask_nee=m_nee,
                need_attached=need_attached,
            )
            # weight = f_attached / sg(pdf) exactly, so the attached eval
            # at wo is recovered without a second pass.
            f_att = weight * p_s[..., None] if need_attached else None
            res = (f_nee, p_nee, wo, p_s, weight, is_delta, f_att)
        else:
            if getattr(mod, "NEEDS_SLOT", False):
                extra = {"slot": slot_safe}
                if getattr(mod, "NEEDS_UV", False):
                    extra["uv"] = uv
                if getattr(mod, "NEEDS_MASK", False):
                    extra["mask"] = mask
                call = lambda fn, *a, _e=extra: getattr(mod, fn)(
                    table.stacks[kid], *a, **_e
                )
            else:
                params = _gather_params(table.stacks[kid], slot_safe)
                kw = {"uv": uv} if getattr(mod, "NEEDS_UV", False) else {}
                call = lambda fn, *a, _p=params, _k=kw: getattr(mod, fn)(
                    _p, *a, **_k
                )
            wo, p_s, weight, is_delta = call("sample", wi, sample2, sample1)
            if has_nee:
                f_nee = call("eval", wi, wo_nee)
                p_nee = call("pdf", wi, wo_nee)
            else:
                f_nee = jnp.zeros(shape + (3,))
                p_nee = jnp.zeros(shape)
            f_att = (
                call("eval", wi, jax.lax.stop_gradient(wo))
                if need_attached else None
            )
            res = (f_nee, p_nee, wo, p_s, weight, is_delta, f_att)
        if out is None:
            out = tuple(
                None if r is None else jnp.zeros_like(r) for r in res
            )
        out = tuple(
            o if r is None else jnp.where(
                mask.reshape(mask.shape + (1,) * (o.ndim - mask.ndim)), r, o
            )
            for o, r in zip(out, res)
        )
    if out is None:  # only-null scenes (media boundaries)
        return (
            jnp.zeros(shape + (3,)), jnp.zeros(shape), jnp.zeros_like(wi),
            jnp.zeros(shape), jnp.zeros(shape + (3,)),
            jnp.zeros(shape, bool),
            jnp.zeros(shape + (3,)) if need_attached else None,
        )
    return out
