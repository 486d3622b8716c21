"""BSDF models — the plugin families of mitsuba3 src/bsdfs (SURVEY.md §2.4)
plus the reference customization's measured-BRDF plugins (SURVEY.md §2.1).

Each model is a pure-function module over a params pytree:
    eval(params, wi, wo)   -> f(wi, wo) * cos(theta_o)   (RGB, (..., 3))
    pdf(params, wi, wo)    -> solid-angle sampling density
    sample(params, wi, u)  -> (wo, pdf, weight = f*cos/pdf)
Directions live in the local shading frame (+z = surface normal).
Dispatch over material types is static (a fixed kernel table evaluated
under lane masks) — the replacement for Dr.Jit vcalls (SURVEY.md §2.2).
"""
