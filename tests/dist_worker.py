"""Worker process for tests/test_distributed.py (NOT collected by pytest).

2-process jax.distributed loopback — the Analogue of running
mtssrv on localhost and pointing the 0.6 scheduler at it (SURVEY.md §4.2).
Must initialize the distributed runtime BEFORE importing the package (see
parallel/mesh.initialize_distributed docstring).

Usage: python dist_worker.py <process_id> <num_processes> <port>
Prints one line: DIST <pid> procs=<n> ndev=<n> mean=<image mean>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
jax.distributed.initialize(f"localhost:{port}", nproc, pid)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, "/root/repo")

import numpy as np  # noqa: E402

from mitsuba_customization_tpu.parallel import mesh as pmesh  # noqa: E402


def main():
    from fixtures import synthetic_table
    import mitsuba_customization_tpu as mct
    from mitsuba_customization_tpu.render.sensors import look_at

    scene = mct.load_dict(
        {
            "type": "scene",
            "integrator": {"type": "path", "max_depth": 2},
            "sensor": {
                "type": "perspective",
                "fov": 40,
                "to_world": look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]),
                "film": {"width": 16, "height": 16, "rfilter": "gaussian"},
                "sampler": {"type": "independent", "sample_count": 2},
            },
            "sphere": {
                "type": "sphere",
                "bsdf": {"type": "merl", "table": synthetic_table()},
            },
            "light": {"type": "constant", "radiance": [1.0, 1.0, 1.0]},
        }
    )
    # 2-level mesh: 2 hosts (processes) x 2 local CPU devices
    mesh = pmesh.make_mesh_2level(n_hosts=nproc)
    img = pmesh.render_sharded_jit(scene, mesh, spp=2, seed=0)
    # replicated output -> every process can fetch the full image
    local = np.asarray(jax.device_get(img.addressable_shards[0].data))
    print(
        f"DIST {pid} procs={jax.process_count()} ndev={jax.device_count()} "
        f"mean={local.mean():.6f}",
        flush=True,
    )


main()
