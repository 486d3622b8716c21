"""MERL binary BRDF reader + BSDF model — the reference's headline plugin.

Counterpart of the MERL plugins the reference adds to both
Mitsuba stacks (README.md:1 "Add Merl, customized_measurment brdf pluggin";
SURVEY.md §2.1). File format (standard MERL reader semantics, required by
BASELINE.json north_star):

    int32 dims[3] = {90, 90, 180}          (theta_h, theta_d, phi_d)
    float64 data[3 * 90 * 90 * 180]        channel-major (R plane, G, B)
    storage index within a plane:
        idx = phi_d_ind + theta_d_ind * 180 + theta_h_ind * 180 * 90
    channel scales on read: R * 1.0/1500, G * 1.15/1500, B * 1.66/1500

Negative entries mark unmeasured configurations and clamp to zero.
Evaluation/sampling delegate to models.tabulated (trilinear interpolation
over the sqrt-warped theta_h grid + luminance-weighted importance
sampling).
"""

from __future__ import annotations

import struct

import numpy as np

from mitsuba_customization_tpu.models import tabulated
from mitsuba_customization_tpu.models.tabulated import TabulatedBRDF

MERL_DIMS = (90, 90, 180)
# MERL channel scale factors (SURVEY.md §2.1).
MERL_SCALE = np.array([1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0])


def read_merl(path):
    """Read a MERL .binary file -> (90, 90, 180, 3) float32 table (sr^-1).

    Channel scales applied; negatives (unmeasured) clamped to zero.
    Uses the native C++ reader when available (same semantics).
    """
    from mitsuba_customization_tpu import native

    if native.available():
        try:
            table = native.read_merl(path, MERL_DIMS)
            if table is not None:
                return table
        except ValueError as e:
            # re-map native error codes onto the Python reader's messages
            if "dims" in str(e):
                raise ValueError(
                    f"{path}: MERL dims mismatch — use "
                    "measured_custom.read_custom for other resolutions"
                ) from e
            raise
    with open(path, "rb") as f:
        dims = struct.unpack("<3i", f.read(12))
        if tuple(dims) != MERL_DIMS:
            raise ValueError(
                f"{path}: MERL dims {dims} != {MERL_DIMS} — "
                "use measured_custom.read_custom for other resolutions"
            )
        n = dims[0] * dims[1] * dims[2]
        data = np.fromfile(f, dtype="<f8", count=3 * n)
    if data.size != 3 * n:
        raise ValueError(f"{path}: truncated MERL file")
    planes = data.reshape(3, *MERL_DIMS)  # (3, th, td, pd), channel-major
    table = np.moveaxis(planes, 0, -1) * MERL_SCALE
    return np.maximum(table, 0.0).astype(np.float32)


def write_merl(path, table):
    """Write a (90, 90, 180, 3) scaled table back to MERL .binary format.

    Inverse of read_merl (divides the channel scales out); used to produce
    synthetic fixtures and to export optimized tables.
    """
    table = np.asarray(table, dtype=np.float64)
    if table.shape != (*MERL_DIMS, 3):
        raise ValueError(f"table shape {table.shape} != {(*MERL_DIMS, 3)}")
    planes = np.moveaxis(table / MERL_SCALE, -1, 0)
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", *MERL_DIMS))
        planes.astype("<f8").tofile(f)


def load(path) -> TabulatedBRDF:
    """Load a MERL file into a ready-to-render BSDF (sampling CDFs built)."""
    return TabulatedBRDF.build(np.asarray(read_merl(path)))


# BSDF interface — delegates to the shared tabulated core.
eval = tabulated.eval
eval_raw = tabulated.eval_raw
pdf = tabulated.pdf
sample = tabulated.sample
