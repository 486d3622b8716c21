"""Sensors: perspective, thinlens, orthographic, radiancemeter,
irradiancemeter, distant, batch.

Counterpart of mitsuba3 src/sensors/ (SURVEY.md §2.4, starred:
`perspective`). A sensor maps film positions (+ aperture samples) to
primary rays — Sensor::sample_ray_differential in SURVEY.md §3.1.
Measurement sensors follow mitsuba3 semantics: `radiancemeter` shoots one
ray (+z in sensor space) per sample — the point-wise integrator
validation tool; `irradiancemeter` cosine-samples the +z hemisphere (the
film mean times pi is the irradiance; render() applies the pi through
SceneConfig.sensor_scale); `distant` records radiance arriving from the
sensor direction onto a target-plane film.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from mitsuba_customization_tpu.core import math as m
from mitsuba_customization_tpu.core.warp import (
    square_to_uniform_disk_concentric,
)
from mitsuba_customization_tpu.render.records import Ray

PERSPECTIVE = 0
THINLENS = 1
ORTHOGRAPHIC = 2
RADIANCEMETER = 3
IRRADIANCEMETER = 4
DISTANT = 5
# batch (mitsuba3 src/sensors/batch.cpp) is not an enum member: it is a
# Sensor whose fields carry a leading child axis + child_types set — the
# film splits into vertical strips, one per child (see sample_ray).


class Sensor(NamedTuple):
    """Camera parameters.

    to_world: (4, 4) camera-to-world transform. Camera space: +z = view
    direction, +x right, +y up (Mitsuba convention: looks along +z).
    fov_x: horizontal field of view in degrees (perspective/thinlens).
    """

    sensor_type: jnp.ndarray  # () int32 — or (B,) for a batch sensor
    to_world: jnp.ndarray  # (4, 4) — (B, 4, 4) for batch
    fov_x: jnp.ndarray  # ()
    aperture_radius: jnp.ndarray  # () thinlens
    focus_distance: jnp.ndarray  # () thinlens
    near_clip: jnp.ndarray  # ()
    ortho_scale: jnp.ndarray  # () half-width of the ortho view volume
    child_types: jnp.ndarray = None  # (B,) int32 marks a batch sensor


def look_at(origin, target, up):
    """Build a camera-to-world matrix (mitsuba3 Transform4f::look_at)."""
    origin = np.asarray(origin, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    new_up = np.cross(fwd, right)
    mat = np.eye(4)
    mat[:3, 0] = right
    mat[:3, 1] = new_up
    mat[:3, 2] = fwd
    mat[:3, 3] = origin
    return mat.astype(np.float32)


def make_sensor(
    sensor_type=PERSPECTIVE,
    to_world=None,
    fov_x=45.0,
    aperture_radius=0.0,
    focus_distance=1.0,
    near_clip=1e-3,
    ortho_scale=1.0,
):
    if to_world is None:
        to_world = np.eye(4, dtype=np.float32)
    return Sensor(
        sensor_type=jnp.asarray(
            {
                "perspective": PERSPECTIVE,
                "thinlens": THINLENS,
                "orthographic": ORTHOGRAPHIC,
                "radiancemeter": RADIANCEMETER,
                "irradiancemeter": IRRADIANCEMETER,
                "distant": DISTANT,
            }.get(sensor_type, sensor_type)
            if isinstance(sensor_type, str)
            else sensor_type,
            dtype=jnp.int32,
        ),
        to_world=jnp.asarray(to_world, dtype=jnp.float32),
        fov_x=jnp.asarray(fov_x, dtype=jnp.float32),
        aperture_radius=jnp.asarray(aperture_radius, dtype=jnp.float32),
        focus_distance=jnp.asarray(focus_distance, dtype=jnp.float32),
        near_clip=jnp.asarray(near_clip, dtype=jnp.float32),
        ortho_scale=jnp.asarray(ortho_scale, dtype=jnp.float32),
    )


def sample_ray(sensor: Sensor, film_uv, aperture_uv, aspect):
    """Generate camera rays.

    film_uv: (..., 2) in [0,1)^2, (0,0) = top-left (Mitsuba film convention,
    y down); aperture_uv: (..., 2) for thinlens; aspect = width/height.
    Returns a world-space Ray.

    Batch sensors (child_types set): the film splits into B vertical
    strips; each lane selects its child by strip, gathers that child's
    parameters, and the masked per-type math below runs once with
    per-lane parameter arrays (every formula broadcasts).
    """
    if sensor.child_types is not None:
        b = sensor.child_types.shape[0]
        xi = jnp.clip(
            (film_uv[..., 0] * b).astype(jnp.int32), 0, b - 1
        )
        local_x = film_uv[..., 0] * b - xi
        fields = Sensor(
            sensor_type=sensor.child_types,
            to_world=sensor.to_world,
            fov_x=sensor.fov_x,
            aperture_radius=sensor.aperture_radius,
            focus_distance=sensor.focus_distance,
            near_clip=sensor.near_clip,
            ortho_scale=sensor.ortho_scale,
            child_types=None,
        )
        # gather each lane's child parameters (child_types=None excluded
        # from the tree so the result is a plain single-sensor pytree)
        gathered = [f[xi] for f in fields if f is not None]
        per_lane = Sensor(*gathered, child_types=None)
        uv2 = jnp.stack([local_x, film_uv[..., 1]], axis=-1)
        return sample_ray(per_lane, uv2, aperture_uv, aspect / b)

    tan_half = jnp.tan(jnp.deg2rad(sensor.fov_x) * 0.5)
    # Camera-space film plane at z=1: x right, y up.
    x = (2.0 * film_uv[..., 0] - 1.0) * tan_half
    y = (1.0 - 2.0 * film_uv[..., 1]) * tan_half / aspect
    d_persp = m.normalize(
        jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    )
    o_persp = jnp.zeros_like(d_persp)

    # Thinlens: offset origin on the aperture disk, aim at the focus plane.
    ap = (
        square_to_uniform_disk_concentric(aperture_uv)
        * jnp.asarray(sensor.aperture_radius)[..., None]
    )
    o_lens = jnp.stack([ap[..., 0], ap[..., 1], jnp.zeros_like(x)], axis=-1)
    focus_p = d_persp * m.safe_div(
        sensor.focus_distance, d_persp[..., 2]
    )[..., None]
    d_lens = m.normalize(focus_p - o_lens)

    # Orthographic: parallel rays.
    o_ortho = jnp.stack(
        [
            x / tan_half * sensor.ortho_scale,
            y / tan_half * sensor.ortho_scale,
            jnp.zeros_like(x),
        ],
        axis=-1,
    )
    d_ortho = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], dtype=x.dtype), o_ortho.shape
    )

    # Radiancemeter: one fixed ray (+z) regardless of film position.
    o_meter = jnp.zeros_like(o_persp)
    d_meter = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], dtype=x.dtype), o_persp.shape
    )
    # Irradiancemeter: cosine-weighted hemisphere over +z, warped from the
    # film sample (pixel mean * pi = irradiance; SceneConfig.sensor_scale).
    from mitsuba_customization_tpu.core.warp import (
        square_to_cosine_hemisphere,
    )

    d_irr = square_to_cosine_hemisphere(film_uv)
    # Distant: orthographic target plane pushed back far outside the scene.
    o_dist = o_ortho - 1.0e4 * d_ortho

    st = jnp.asarray(sensor.sensor_type)
    if st.ndim > 0:  # per-lane types (batch sensor): pad for (..., 3) where
        st = st[..., None]
    o_cam = jnp.where(
        st == THINLENS, o_lens,
        jnp.where(
            st == ORTHOGRAPHIC, o_ortho,
            jnp.where(
                (st == RADIANCEMETER) | (st == IRRADIANCEMETER), o_meter,
                jnp.where(st == DISTANT, o_dist, o_persp),
            ),
        ),
    )
    d_cam = jnp.where(
        st == THINLENS, d_lens,
        jnp.where(
            (st == ORTHOGRAPHIC) | (st == DISTANT), d_ortho,
            jnp.where(
                st == RADIANCEMETER, d_meter,
                jnp.where(st == IRRADIANCEMETER, d_irr, d_persp),
            ),
        ),
    )

    rot = sensor.to_world[..., :3, :3]
    trans = sensor.to_world[..., :3, 3]
    # rot @ v written elementwise (exact f32, no matrix unit) for both a
    # shared (3, 3) rotation and a per-lane (..., 3, 3) one (batch sensors)
    o_w = jnp.sum(rot * o_cam[..., None, :], axis=-1) + trans
    d_w = m.normalize(jnp.sum(rot * d_cam[..., None, :], axis=-1))
    o_w = o_w + d_w * jnp.asarray(sensor.near_clip)[..., None]
    return Ray.make(o_w, d_w)
