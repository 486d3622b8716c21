"""Rendering layer: scene, shapes, BVH, emitters, sensors, film, integrators.

Counterpart of mitsuba3 src/render (librender) + the plugin
families (SURVEY.md §2.3/§2.4), restructured as pure-jnp wavefront stages.
"""

# `import mitsuba_customization_tpu.render.x` rebinds the package attribute
# `render` from api.render (the function) to this module; making the module
# callable keeps the mi.render-style entry `mct.render(scene, ...)` working
# either way.
import sys as _sys
import types as _types


class _CallableRenderModule(_types.ModuleType):
    def __call__(self, scene, spp=None, seed=0, **kwargs):
        from mitsuba_customization_tpu.api import render as _render

        return _render(scene, spp=spp, seed=seed, **kwargs)


_sys.modules[__name__].__class__ = _CallableRenderModule
