"""Top-level user API: load_dict / render / traverse.

Counterpart of mitsuba3's Python layer (SURVEY.md §2.5):
mi.load_dict -> load_dict, mi.render -> render, mi.traverse -> traverse.
Fleshed out as the render layers land (SURVEY.md §7.2 steps 4-9).
"""

from __future__ import annotations


def load_dict(d):
    """Build a Scene from a nested dict description (mi.load_dict schema)."""
    from mitsuba_customization_tpu.render.scene import load_dict as _load

    return _load(d)


def render(scene, spp=None, seed=0, **kwargs):
    """Render a scene; returns an (H, W, 3) image array (mi.render).

    spp=None uses the scene sampler's sample_count (mi.render semantics)."""
    from mitsuba_customization_tpu.render.integrator import render as _render

    return _render(scene, spp=spp, seed=seed, **kwargs)


def traverse(scene):
    """Return the dict of differentiable scene parameters (mi.traverse)."""
    from mitsuba_customization_tpu.render.params import traverse as _traverse

    return _traverse(scene)
