"""ctypes bindings to the native runtime library (native/mct_native.cpp).

Counterpart of the reference's C++ host runtime (SURVEY.md §2.3): fast
MERL IO, BVH build, OBJ parsing. Every entry point has a pure-Python
fallback (models/merl.py, render/bvh.py, utils/obj.py), so the framework
works without the library; `available()` reports whether the fast path is
loaded. The library is compiled from source with g++ at first use into
native/build/ (see `build_library`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = NATIVE_DIR / "build"

_LIB = None


def build_library(src: Path, argv: list, tag: str) -> Path:
    """Compile `src` with compiler command `argv` into a shared library.

    The output name carries a hash of the source and the command, so an
    edit rebuilds and an unchanged tree reuses the library. The compiler
    writes a private temporary file that is renamed into place, so
    concurrent processes never load a half-written library.
    """
    key = hashlib.sha256(
        src.read_bytes() + " ".join(argv).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{tag}-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [*argv, "-o", str(tmp), str(src)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {src.name} failed:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    _LIB = False
    if shutil.which("g++") is None:
        return _LIB
    path = build_library(
        NATIVE_DIR / "mct_native.cpp",
        ["g++", "-O3", "-fPIC", "-shared", "-std=c++17"],
        "host",
    )
    lib = ctypes.CDLL(str(path))
    lib.mct_read_merl.restype = ctypes.c_int
    lib.mct_build_bvh.restype = ctypes.c_int
    lib.mct_parse_obj.restype = ctypes.c_int
    _LIB = lib
    return lib


def available():
    return bool(_load())


def read_merl(path, dims=(90, 90, 180)):
    """Native MERL reader -> (n_th, n_td, n_pd, 3) float32, or None if the
    library is unavailable. Raises ValueError on malformed files."""
    lib = _load()
    if not lib:
        return None
    out = np.empty((*dims, 3), dtype=np.float32)
    rc = lib.mct_read_merl(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dims[0], dims[1], dims[2],
    )
    if rc == -3:
        raise ValueError(f"{path}: MERL dims != {dims}")
    if rc != 0:
        raise ValueError(f"{path}: MERL read failed (code {rc})")
    return out


def build_bvh(bb_min, bb_max, leaf_size=4, n_bins=16):
    """Native binned-SAH build -> (nodes_min, nodes_max, skip, leaf_prims)
    numpy arrays in the render/bvh.py layout, or None if unavailable."""
    lib = _load()
    if not lib:
        return None
    bb_min = np.ascontiguousarray(bb_min, dtype=np.float32)
    bb_max = np.ascontiguousarray(bb_max, dtype=np.float32)
    n = bb_min.shape[0]
    max_nodes = max(2 * n, 1)
    nodes_min = np.empty((max_nodes, 3), np.float32)
    nodes_max = np.empty((max_nodes, 3), np.float32)
    skip = np.empty(max_nodes, np.int32)
    leaf = np.empty((max_nodes, leaf_size), np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n_nodes = lib.mct_build_bvh(
        bb_min.ctypes.data_as(f32p), bb_max.ctypes.data_as(f32p),
        n, leaf_size, n_bins,
        nodes_min.ctypes.data_as(f32p), nodes_max.ctypes.data_as(f32p),
        skip.ctypes.data_as(i32p), leaf.ctypes.data_as(i32p), max_nodes,
    )
    if n_nodes < 0:
        raise RuntimeError(f"native BVH build failed (code {n_nodes})")
    return (
        nodes_min[:n_nodes].copy(),
        nodes_max[:n_nodes].copy(),
        skip[:n_nodes].copy(),
        leaf[:n_nodes].copy(),
    )


def parse_obj(path):
    """Native OBJ triangle parse -> (verts (V,3) f32, faces (F,3) i32), or
    None if unavailable. Positions-only fast path (normals/uvs fall back
    to the Python parser in utils/obj.py)."""
    lib = _load()
    if not lib:
        return None
    nv = ctypes.c_int32(0)
    nf = ctypes.c_int32(0)
    rc = lib.mct_parse_obj(
        str(path).encode(), None, None, ctypes.byref(nv), ctypes.byref(nf)
    )
    if rc != 0:
        raise ValueError(f"{path}: OBJ parse failed (code {rc})")
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    rc = lib.mct_parse_obj(
        str(path).encode(),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(nv), ctypes.byref(nf),
    )
    if rc != 0:
        raise ValueError(f"{path}: OBJ parse failed (code {rc})")
    return verts, faces
