"""mitsuba_customization_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/XLA implementation of the capabilities of
``WenCao1101/mitsuba_customization`` (Mitsuba 0.6 / Mitsuba 3 forks carrying
MERL and custom measured-BRDF plugins; see /root/repo/SURVEY.md):

* MERL 90x90x180 measured BRDF tables — Rusinkiewicz half/diff
  parameterization, trilinear interpolation, luminance-weighted tabulated
  importance sampling (reference: mitsuba3/src/bsdfs merl plugin,
  SURVEY.md §2.1).
* Analytic microfacet BSDFs (GGX/Beckmann), smooth conductors/dielectrics,
  diffuse, plastic — the plugin families of mitsuba3/src/bsdfs (SURVEY.md §2.4).
* A wavefront path tracer with NEE + MIS (mitsuba3/src/integrators/path.cpp)
  built on lax.scan/fori_loop instead of Dr.Jit recorded loops.
* Path-replay-style differentiability (mitsuba3 python/ad/integrators/prb.py)
  via jax.custom_vjp — O(1) memory in path length.
* Multi-chip scaling via jax.sharding.Mesh + shard_map in place of the
  Mitsuba 0.6 TCP scheduler (mitsuba/src/libcore/sched_remote.cpp).

Layer map (mirrors SURVEY.md §7.2):
  core/     — frames, warps, distributions, Rusinkiewicz transform, QMC, color
  models/   — BSDF models (merl, measured_custom, microfacet/GGX, diffuse, ...)
  render/   — scene, shapes, BVH, emitters, sensors, film, integrators, AD
  ops/      — hand-written kernels for the hot paths (BVH traversal, CUDA)
  parallel/ — device-mesh sharding of rays/pixels, gradient all-reduce
  utils/    — image IO, logging, checkpointing
"""

__version__ = "0.1.0"

from mitsuba_customization_tpu.api import (  # noqa: F401
    load_dict,
    render,
    traverse,
)
