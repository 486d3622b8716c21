"""Native C++ runtime vs Python reference implementations
(native/mct_native.cpp <-> models/merl.py, render/bvh.py, utils/obj.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_customization_tpu import native

from fixtures import synthetic_table_file_units



@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Builds the library from native/mct_native.cpp (g++) on first use."""
    if not native.available():
        pytest.skip("native library unavailable (no g++)")


def test_native_merl_matches_python(tmp_path):
    import struct

    from mitsuba_customization_tpu.models.merl import MERL_DIMS, MERL_SCALE

    table_file = synthetic_table_file_units()
    path = tmp_path / "m.binary"
    planes = np.moveaxis(table_file, -1, 0)
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", *MERL_DIMS))
        planes.astype("<f8").tofile(f)

    nat = native.read_merl(path)
    # python reference path (bypass the native fast path)
    data = np.fromfile(path, dtype="<f8", offset=12).reshape(3, *MERL_DIMS)
    ref = np.maximum(np.moveaxis(data, 0, -1) * MERL_SCALE, 0).astype(
        np.float32
    )
    assert np.allclose(nat, ref, rtol=1e-6)


def test_native_merl_dims_error(tmp_path):
    import struct

    path = tmp_path / "bad.binary"
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", 45, 45, 90))
        f.write(b"\0" * 64)
    with pytest.raises(ValueError):
        native.read_merl(path)


def test_native_bvh_traversal_matches_brute(rng):
    from mitsuba_customization_tpu.render import bvh as bvh_mod
    from mitsuba_customization_tpu.render import geometry as geo
    from mitsuba_customization_tpu.render.records import Ray
    from test_geometry import _random_scene

    g = _random_scene(rng, 300, 30)
    tree = bvh_mod.build(g)  # takes the native path when available
    assert tree.n_nodes > 1
    n_rays = 400
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = Ray.make(jnp.asarray(o), jnp.asarray(d))
    t_b, p_b, _, _ = geo.intersect_brute(g, ray)
    t_t, p_t, _, _ = bvh_mod.intersect(tree, g, ray)
    np.testing.assert_allclose(np.asarray(t_t), np.asarray(t_b), rtol=1e-4)
    assert (np.asarray(p_t) == np.asarray(p_b)).mean() > 0.995


def test_native_obj_matches_python(tmp_path):
    from mitsuba_customization_tpu.utils.obj import read_obj

    path = tmp_path / "mesh.obj"
    path.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "f 1 2 3 4\n"  # quad -> 2 tris
        "f -4 -3 -2\n"  # negative indices
    )
    verts, faces = native.parse_obj(path)
    v_py, f_py, _, _ = read_obj(path)
    assert verts.shape == (4, 3)
    assert faces.shape == (3, 3)
    # same triangles (python re-indexes corners but geometry agrees)
    tri_nat = verts[faces]
    tri_py = v_py[f_py]
    assert np.allclose(np.sort(tri_nat.reshape(3, -1), axis=-1),
                       np.sort(tri_py.reshape(3, -1), axis=-1))
