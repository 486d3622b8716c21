"""Wavefront-compaction tests (render/integrator._run_bounces_compact).

The compacting runner must be a pure estimator-preserving transform:
* harvest-only schedules (caps >= live counts) reproduce the plain
  runner's image EXACTLY (same sampler draws per original lane);
* aggressive schedules that force systematic-RR thinning stay unbiased
  (image agrees within MC noise).
"""

import numpy as np
import pytest

import mitsuba_customization_tpu as mct
from mitsuba_customization_tpu.render.integrator import render
from mitsuba_customization_tpu.render.sensors import look_at


def _scene(compact=None, spp=16, res=32, depth=4):
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": depth,
                       "compact": compact},
        "sensor": {
            "type": "perspective",
            "fov": 45,
            "to_world": look_at([0, 0.8, -3.5], [0, 0, 0], [0, 1, 0]),
            "film": {"width": res, "height": res},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "ball": {"type": "sphere", "center": [0, 0, 0], "radius": 1.0,
                 "bsdf": {"type": "diffuse",
                          "reflectance": [0.6, 0.4, 0.25]}},
        "floor": {
            "type": "rectangle",
            "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90},
                         "scale": 6.0, "translate": [0, -1.0, 0]},
            "bsdf": {"type": "roughconductor", "alpha": 0.3},
        },
        "light": {"type": "constant", "radiance": [0.7, 0.8, 0.9]},
    }
    return mct.load_dict(d)


def test_harvest_only_schedule_exact():
    """Caps above the live count never thin: the image must be exact.

    The open scene loses >50% of lanes to the environment after bounce 1,
    so a 1.0/1.0/1.0 schedule (no shrink) exercises the permutation +
    final unsort machinery without any forced RR."""
    ref = np.asarray(render(_scene(None), seed=5))
    got = np.asarray(render(_scene([1.0, 1.0, 1.0]), seed=5))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.slow  # nightly (-m ""): heavy compile/render; a faster sibling test keeps default coverage
def test_compaction_schedule_matches_within_noise():
    """A shrinking schedule harvests dead lanes; live thinning is rare,
    so per-pixel differences stay at MC-noise scale."""
    ref = np.asarray(render(_scene(None, spp=64), seed=3))
    got = np.asarray(render(_scene([1.0, 0.75, 0.5, 0.25], spp=64), seed=3))
    # pixels whose lanes were never thinned are identical; thinned deep
    # bounces perturb a small energy fraction
    err = np.abs(got - ref).mean()
    assert err < 0.01, err
    assert abs(got.mean() - ref.mean()) < 0.004, (got.mean(), ref.mean())


@pytest.mark.slow  # heavy; faster sibling stays in the default run
def test_forced_thinning_unbiased():
    """A brutally tight schedule (12.5% after bounce 1) forces systematic
    RR on live lanes; the estimator must remain unbiased (image mean
    agrees within MC tolerance at higher spp)."""
    ref = np.asarray(render(_scene(None, spp=64, res=16, depth=3), seed=11))
    got = np.asarray(
        render(_scene([1.0, 0.125], spp=64, res=16, depth=3), seed=11)
    )
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.05, (
        got.mean(), ref.mean()
    )
    assert np.isfinite(got).all()


@pytest.mark.slow  # nightly (-m ""): heavy compile/render; a faster sibling test keeps default coverage
def test_compaction_matpreview_kernel_matches_plain():
    """Compaction on the mesh scene through the traversal kernel: the
    final tag unsort must give the uncompacted image (same seeds, same
    estimator)."""
    import dataclasses
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from __graft_entry__ import _matpreview_scene
    from mitsuba_customization_tpu.render.integrator import render

    scene = _matpreview_scene(res=24, spp=4, depth=4, n_sub=2,
                              intersector="kernel")
    img_plain = np.asarray(render(scene, spp=4, seed=1))
    sc2 = dataclasses.replace(
        scene,
        config=dataclasses.replace(
            scene.config, compact=(1.0, 1.0, 0.5, 0.25)
        ),
    )
    img_sorted = np.asarray(render(sc2, spp=4, seed=1))
    # thinning below the live fraction is stochastic but unbiased
    assert np.isfinite(img_sorted).all()
    assert abs(img_sorted.mean() - img_plain.mean()) < 0.05 * max(
        img_plain.mean(), 1e-6
    )
