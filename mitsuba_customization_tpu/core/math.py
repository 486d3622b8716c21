"""Vector math and numeric helpers.

Counterpart of mitsuba3 include/mitsuba/core/{math,vector}.h
(SURVEY.md §2.3 "Math / warp / distributions"). All functions are pure jnp,
batched over leading axes; 3-vectors are arrays of shape (..., 3).
"""

from __future__ import annotations

import jax.numpy as jnp

# Match Mitsuba's epsilons (include/mitsuba/core/math.h).
EPSILON = 1e-7
RAY_EPSILON = 1e-4  # min-t offset used to avoid self-intersection
# numpy, not jnp: a jnp call here would initialize the JAX backend at
# import time for a compile-time constant.
import numpy as _np  # noqa: E402

ONE_MINUS_EPSILON = float(_np.nextafter(_np.float32(1.0), _np.float32(0.0)))
INF = float("inf")


def safe_sqrt(x):
    """sqrt clamped to zero below — dr::safe_sqrt."""
    return jnp.sqrt(jnp.maximum(x, 0.0))


def safe_acos(x):
    """acos with clamped argument — dr::safe_acos."""
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


def safe_asin(x):
    return jnp.arcsin(jnp.clip(x, -1.0, 1.0))


def safe_div(a, b, default=0.0):
    """a/b with 0-denominator guarded (returns `default` there).

    Guards both the value and its gradient: the denominator is replaced by 1
    where it is zero, so no inf/nan enters the AD graph.
    """
    zero = b == 0.0
    b_safe = jnp.where(zero, 1.0, b)
    return jnp.where(zero, default, a / b_safe)


def safe_rsqrt(x):
    x_safe = jnp.maximum(x, EPSILON * EPSILON)
    return 1.0 / jnp.sqrt(x_safe)


def dot(a, b):
    """Batched dot product over the last axis, keeps dims reduced."""
    return jnp.sum(a * b, axis=-1)


def dot_keep(a, b):
    return jnp.sum(a * b, axis=-1, keepdims=True)


def matvec(mat, v):
    """mat @ v over the last axes, batched: (..., m, n) x (..., n).

    Written elementwise so small transforms stay exact f32 on every
    backend (a GPU may run an f32 matrix product in TF32)."""
    return jnp.sum(mat * v[..., None, :], axis=-1)


def vecmat(v, mat):
    """v @ mat, batched: (..., m) x (..., m, n), elementwise like matvec."""
    return jnp.sum(v[..., :, None] * mat, axis=-2)


def abs_dot(a, b):
    return jnp.abs(dot(a, b))


def cross(a, b):
    return jnp.cross(a, b)


def squared_norm(v):
    return jnp.sum(v * v, axis=-1)


def norm(v):
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def normalize(v):
    """Normalize over the last axis; zero vectors map to zero (grad-safe)."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    n2_safe = jnp.maximum(n2, EPSILON * EPSILON)
    return v * (1.0 / jnp.sqrt(n2_safe))


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def sign(x):
    """Sign that maps 0 -> +1 (dr::sign / copysign semantics)."""
    return jnp.where(x >= 0.0, 1.0, -1.0)


def mulsign(value, s):
    """value * sign(s) without a multiply on the magnitude — dr::mulsign."""
    return jnp.where(s >= 0.0, value, -value)


def sph_to_dir(theta, phi):
    """Spherical (theta from +z, phi from +x) to unit vector (..., 3)."""
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    return jnp.stack([st * cp, st * sp, ct], axis=-1)


def dir_to_sph(d):
    """Unit vector to (theta, phi); phi in (-pi, pi]."""
    theta = safe_acos(d[..., 2])
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    return theta, phi


def coordinate_system(n):
    """Build an orthonormal basis (s, t) around unit normal n.

    Duff et al. 2017 branchless construction — same algorithm as
    mitsuba3 include/mitsuba/core/vector.h coordinate_system().
    Returns (s, t) with s x t = n.
    """
    z = n[..., 2]
    s = sign(z)
    a = -1.0 / (s + z)
    b = n[..., 0] * n[..., 1] * a
    x = jnp.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], axis=-1
    )
    y = jnp.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return x, y


def reflect(w, n=None):
    """Reflect direction w.

    With n=None, reflects about the local +z axis (shading frame), matching
    mitsuba3's reflect(wi). Otherwise reflects about unit normal n.
    Convention: w points *away* from the surface (toward the viewer).
    """
    if n is None:
        return jnp.stack([-w[..., 0], -w[..., 1], w[..., 2]], axis=-1)
    return 2.0 * dot_keep(w, n) * n - w


def refract(wi, cos_theta_t, eta_ti):
    """Refract wi about local +z given precomputed cos_theta_t and 1/eta.

    Mirrors mitsuba3 include/mitsuba/render/fresnel.h refract(): the
    transmitted direction in the shading frame.
    """
    scale = -eta_ti
    return jnp.stack(
        [
            scale * wi[..., 0],
            scale * wi[..., 1],
            cos_theta_t,
        ],
        axis=-1,
    )


# --- Shading-frame trigonometry (mitsuba3 Frame3f helpers) ------------------


def cos_theta(w):
    return w[..., 2]


def cos_theta2(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def sin_theta2(w):
    return jnp.maximum(0.0, 1.0 - cos_theta2(w))


def sin_theta(w):
    return jnp.sqrt(sin_theta2(w))


def tan_theta(w):
    return safe_div(sin_theta(w), cos_theta(w))


def tan_theta2(w):
    return safe_div(sin_theta2(w), cos_theta2(w))


def sin_phi(w):
    s = sin_theta(w)
    return jnp.where(s == 0.0, 0.0, jnp.clip(safe_div(w[..., 1], s), -1.0, 1.0))


def cos_phi(w):
    s = sin_theta(w)
    return jnp.where(s == 0.0, 1.0, jnp.clip(safe_div(w[..., 0], s), -1.0, 1.0))
