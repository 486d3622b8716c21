"""Differentiable rendering: path-replay backprop + inverse-rendering loop.

Counterpart of mitsuba3 python/ad/integrators/{common,prb}.py +
ad/optimizers.py (SURVEY.md §2.5, call stack §3.2/§3.5). The reference's
`prb` replays the path during dr.backward with identical seeds; here the
same algorithm falls out of composition (render/integrator.py docstring):

* sampling decisions are pure functions of (seed, lane, dim) — replay is
  free and bit-exact (SURVEY.md §7.3 item 3);
* the detached estimator (pdfs/MIS stop-gradded) matches prb's;
* jax.checkpoint on the bounce body makes reverse-mode AD re-run each
  bounce forward instead of taping it — O(1) residual memory in depth.

`render_ad` is the differentiable entry; `grad_render` gives (image, vjp);
`Optimizer`/`optimize` run the inverse-rendering loop of BASELINE
configs[3] (recover MERL table / GGX roughness from reference renders),
rebuilding the luminance-sampling CDFs after every table update inside the
jitted step (SURVEY.md §7.3 item 6).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax

from mitsuba_customization_tpu.render import params as params_mod
from mitsuba_customization_tpu.render.integrator import render


def render_ad(scene, params, spp=None, seed=0, max_depth=None):
    """Differentiable render: image as a function of the param dict.

    mi.render(scene, params, ...) analogue: gradients flow from the image
    to `params` via path replay.
    """
    scene_p = params_mod.update(scene, params)
    return render(scene_p, spp=spp, seed=seed, max_depth=max_depth,
                  ad_mode=True)


@partial(jax.jit, static_argnums=(2,))
def _loss_and_grad(scene, params, spp, seed, target):
    def loss_fn(p):
        img = render_ad(scene, p, spp=spp, seed=seed)
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)


def grad_render(scene, params, target, spp=16, seed=0):
    """One (loss, grads) evaluation of the MSE against a target image."""
    return _loss_and_grad(scene, params, spp, jnp.uint32(seed), target)


class Optimizer:
    """mi.ad.Adam analogue over a scene-parameter dict (optax-backed)."""

    def __init__(self, params, lr=0.01, optimizer=None, clip_nonneg=None):
        self.params = dict(params)
        self.opt = optimizer or optax.adam(lr)
        self.state = self.opt.init(self.params)
        # keys clamped to >= 0 after each step (BRDF tables, albedos)
        self.clip_nonneg = set(clip_nonneg or [])

    def step(self, grads):
        updates, self.state = self.opt.update(grads, self.state, self.params)
        self.params = optax.apply_updates(self.params, updates)
        for key in self.clip_nonneg:
            if key in self.params:
                self.params[key] = jnp.maximum(self.params[key], 0.0)
        return self.params


def optimize(
    scene,
    target,
    param_keys,
    n_steps=50,
    lr=0.02,
    spp=16,
    seed0=0,
    callback=None,
):
    """Inverse-rendering loop (SURVEY.md §3.5): recover the selected
    parameters by pixel-gradient descent against `target`.

    Returns (params, losses). Each step uses a fresh seed (decorrelated MC
    gradients) and rebuilds derived sampling state inside the jitted
    loss+grad evaluation.
    """
    full = params_mod.traverse(scene)
    params = {k: full[k] for k in param_keys}
    opt = Optimizer(params, lr=lr, clip_nonneg=param_keys)
    losses = []
    for it in range(n_steps):
        loss, grads = grad_render(
            scene, opt.params, target, spp=spp, seed=seed0 + it + 1
        )
        opt.step(grads)
        losses.append(float(loss))
        if callback is not None:
            callback(it, float(loss), opt.params)
    return opt.params, losses
