"""Skip-link BVH traversal as a compiled kernel (native/bvh_traverse.cu).

Same contract as render/bvh.py `intersect` / `occluded`, over the same
node arrays, but one ray per thread: each ray keeps its cursor and best
hit in registers and finishes on its own, where the plain JAX traversal
steps every lane of the wavefront in lock-step until the slowest is done.

The source is compiled at first use into native/build/ for the default
backend: with nvcc for the GPU (`sm_90a`), with g++ for the CPU, whose
build lets tests check the kernel's arithmetic against the JAX reference.
Inputs are detached: intersections carry no gradient (render/integrator.py
contract).
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil

import jax
import jax.numpy as jnp

from mitsuba_customization_tpu import native
from mitsuba_customization_tpu.render.records import Ray

_SRC = native.NATIVE_DIR / "bvh_traverse.cu"
_TARGETS = ("MctBvhClosest", "MctBvhOccluded")
_registered = set()


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else shutil.which("nvcc")


def _compiler(platform):
    inc = f"-I{jax.ffi.include_dir()}"
    if platform == "gpu":
        nvcc = _nvcc()
        if nvcc is None:
            raise RuntimeError("nvcc not found (set CUDA_HOME)")
        # -fmad=false: without it nvcc contracts the Moller-Trumbore
        # products into FMAs, which moves t at grazing hits by up to
        # 8e-5 relative against render/bvh.py; with it the two agree to
        # 2.3e-7 on every lane, at the same speed within 8%.
        return [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC", inc,
        ]
    return ["g++", "-x", "c++", "-std=c++17", "-O2", "-fPIC", "-shared", inc]


def _register(platform):
    if platform in _registered:
        return
    path = native.build_library(_SRC, _compiler(platform), platform)
    lib = ctypes.cdll.LoadLibrary(str(path))
    for sym in _TARGETS:
        jax.ffi.register_ffi_target(
            sym, jax.ffi.pycapsule(getattr(lib, sym)),
            platform="CUDA" if platform == "gpu" else "cpu",
        )
    _registered.add(platform)


def ensure_built():
    """Build and register the kernel for the default backend."""
    _register(jax.default_backend())


def _flat_args(bvh, geom, ray):
    lead = ray.o.shape[:-1]
    n = math.prod(lead)
    f32, i32 = jnp.float32, jnp.int32
    args = (
        ray.o.reshape(n, 3).astype(f32),
        ray.d.reshape(n, 3).astype(f32),
        jnp.broadcast_to(ray.maxt, lead).reshape(n).astype(f32),
        geom.prim_type.astype(i32),
        geom.p0.astype(f32),
        geom.e1.astype(f32),
        geom.e2.astype(f32),
        bvh.bb_min.astype(f32),
        bvh.bb_max.astype(f32),
        bvh.skip.astype(i32),
        bvh.leaf_prims.astype(i32),
    )
    return lead, n, [jax.lax.stop_gradient(a) for a in args]


def intersect(bvh, geom, ray: Ray):
    """Nearest hit -> (t, prim, u, v), as render/bvh.intersect."""
    ensure_built()
    lead, n, args = _flat_args(bvh, geom, ray)
    out = (
        jax.ShapeDtypeStruct((n,), jnp.float32),
        jax.ShapeDtypeStruct((n,), jnp.int32),
        jax.ShapeDtypeStruct((n,), jnp.float32),
        jax.ShapeDtypeStruct((n,), jnp.float32),
    )
    res = jax.ffi.ffi_call("MctBvhClosest", out, vmap_method="sequential")(
        *args
    )
    return tuple(r.reshape(lead) for r in res)


def occluded(bvh, geom, ray: Ray):
    """Any hit with t < maxt -> bool, as render/bvh.occluded."""
    ensure_built()
    lead, n, args = _flat_args(bvh, geom, ray)
    out = jax.ShapeDtypeStruct((n,), jnp.bool_)
    hit = jax.ffi.ffi_call("MctBvhOccluded", out, vmap_method="sequential")(
        *args
    )
    return hit.reshape(lead)
