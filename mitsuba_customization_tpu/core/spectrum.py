"""Color handling: RGB spectra, luminance, sRGB transfer functions.

Counterpart of mitsuba3 src/core/spectrum.cpp + src/render/srgb.cpp
(SURVEY.md §2.3). The build targets the *_rgb variants of the reference
(scalar_rgb / cuda_ad_rgb), so Spectrum == linear-Rec709 RGB (..., 3).
"""

from __future__ import annotations

import jax.numpy as jnp

# Rec. 709 / CIE-Y luminance weights — mitsuba3 luminance(Color3f).
_LUM = jnp.array([0.212671, 0.715160, 0.072169], dtype=jnp.float32)


def luminance(rgb):
    """CIE Y of a linear-RGB color (..., 3) -> (...)."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169


def srgb_to_linear(c):
    """sRGB gamma -> linear (IEC 61966-2-1), elementwise."""
    return jnp.where(
        c <= 0.04045,
        c / 12.92,
        jnp.power(jnp.maximum((c + 0.055) / 1.055, 1e-8), 2.4),
    )


def linear_to_srgb(c):
    """Linear -> sRGB gamma, elementwise."""
    c = jnp.maximum(c, 0.0)
    return jnp.where(
        c <= 0.0031308,
        c * 12.92,
        1.055 * jnp.power(jnp.maximum(c, 1e-8), 1.0 / 2.4) - 0.055,
    )


# --------------------------------------------------------------------------
# Spectra plugins (mitsuba3 src/spectra/ — SURVEY.md §2.4): in the *_rgb
# variants every spectrum resolves to a linear-RGB color at scene-build
# time; these helpers reproduce that resolution path for the spectrum
# types scene descriptions use (blackbody, d65, uniform, regular grids).
# --------------------------------------------------------------------------

import numpy as _np

# CIE 1931 color matching functions, coarsely sampled 380-780 nm (5 nm would
# be overkill for RGB resolution targets; 20 nm matches mitsuba's RGB
# round-trip tolerance). Columns: wavelength, xbar, ybar, zbar.
_CIE = _np.array([
    [380, 0.0014, 0.0000, 0.0065], [400, 0.0143, 0.0004, 0.0679],
    [420, 0.1344, 0.0040, 0.6456], [440, 0.3483, 0.0230, 1.7471],
    [460, 0.2908, 0.0600, 1.6692], [480, 0.0956, 0.1390, 0.8130],
    [500, 0.0049, 0.3230, 0.2720], [520, 0.0633, 0.7100, 0.0782],
    [540, 0.2904, 0.9540, 0.0203], [560, 0.5945, 0.9950, 0.0039],
    [580, 0.9163, 0.8700, 0.0017], [600, 1.0622, 0.6310, 0.0008],
    [620, 0.8544, 0.3810, 0.0002], [640, 0.4479, 0.1750, 0.0000],
    [660, 0.1649, 0.0610, 0.0000], [680, 0.0468, 0.0170, 0.0000],
    [700, 0.0114, 0.0041, 0.0000], [720, 0.0029, 0.0010, 0.0000],
    [740, 0.0007, 0.0002, 0.0000], [760, 0.0002, 0.0001, 0.0000],
], dtype=_np.float64)

# XYZ -> linear Rec.709
_XYZ_TO_RGB = _np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
])


def spectrum_to_rgb(wavelengths, values, normalize=False):
    """Integrate a sampled spectrum against the CIE CMFs -> linear RGB.

    The build-time resolution mitsuba3's *_rgb variants apply to
    `regular`/`irregular` spectrum plugins. normalize=True scales so the
    result's luminance is 1 (emitter convention)."""
    wl = _np.asarray(wavelengths, _np.float64)
    sv = _np.interp(_CIE[:, 0], wl, _np.asarray(values, _np.float64),
                    left=0.0, right=0.0)
    xyz = (_CIE[:, 1:] * sv[:, None]).sum(0)
    norm = (_CIE[:, 2] ).sum()
    xyz = xyz / norm
    rgb = _XYZ_TO_RGB @ xyz
    rgb = _np.maximum(rgb, 0.0)
    if normalize and rgb.max() > 0:
        y = 0.212671 * rgb[0] + 0.715160 * rgb[1] + 0.072169 * rgb[2]
        rgb = rgb / max(y, 1e-12)
    return rgb.astype(_np.float32)


def blackbody_rgb(temperature, normalize=True):
    """Planck emitter color at `temperature` K -> linear RGB
    (mitsuba3 src/spectra/blackbody.cpp resolved to RGB)."""
    wl_m = _CIE[:, 0] * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    radiance = (2 * h * c * c) / (
        wl_m ** 5 * (_np.exp(h * c / (wl_m * kb * float(temperature))) - 1.0)
    )
    return spectrum_to_rgb(_CIE[:, 0], radiance, normalize=normalize)


# CIE D65 relative SPD, 380-760/20nm (standard illuminant table)
_D65 = _np.array([
    49.98, 82.75, 93.43, 104.86, 117.81, 115.92, 109.35, 104.79, 104.41,
    100.00, 95.79, 90.01, 87.70, 83.70, 80.21, 78.27, 71.61, 61.60, 75.09,
    63.38,
])


def d65_rgb(scale=1.0):
    """D65 illuminant color (mitsuba3 src/spectra/d65.cpp), luminance 1."""
    return spectrum_to_rgb(_CIE[:, 0], _D65, normalize=True) * _np.float32(
        scale
    )
