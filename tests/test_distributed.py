"""Multi-process jax.distributed loopback test (SURVEY.md §4.2).

The reference exercises its TCP scheduler without a cluster by running
mtssrv on localhost ([S0] mitsuba/src/mitsuba/mtssrv.cpp); the
equivalent spawns two local processes, initializes jax.distributed against
a localhost coordinator, builds the global ('dcn','ici') mesh (2 processes
x 2 virtual CPU devices) and renders a sharded image whose replicated
result must match a single-process render.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_loopback():
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    port = _free_port()
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    lines = {}
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith("DIST "):
                parts = ln.split()
                lines[int(parts[1])] = ln
    assert len(lines) == 2, f"worker output missing:\n{outs[0]}\n{outs[1]}"
    for pid, ln in lines.items():
        assert "procs=2" in ln and "ndev=4" in ln, ln

    means = [float(ln.split("mean=")[1]) for ln in lines.values()]
    assert abs(means[0] - means[1]) < 1e-6

    # single-process reference (this process: 8 virtual devices, 1 host)
    sys.path.insert(0, os.path.dirname(__file__))
    from fixtures import synthetic_table
    import mitsuba_customization_tpu as mct
    from mitsuba_customization_tpu.render.integrator import render_jit
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
    ref = np.asarray(render_jit(scene, spp=2, seed=0))
    assert abs(means[0] - ref.mean()) < 1e-4
