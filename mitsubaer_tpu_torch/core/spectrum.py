"""RGB spectrum representation and spectral->RGB conversion (port of
mitsubaer_tpu/core/spectrum.py).

The reference builds with SPECTRUM_SAMPLES=3 (config_release.py), i.e. RGB
rendering; scene XML may still specify wavelength:value pairs which Mitsuba
converts to RGB at load time (libcore/spectrum.cpp Spectrum::fromContinuousSpectrum
-> toLinearRGB). We mirror that: spectra are (..., 3) float32 arrays and XML
spectral data is integrated against CIE curves then mapped XYZ->linear sRGB.
The conversion runs in numpy, as the scene loader needs it; the spectrum
helpers at the end take tensors.

CIE 1931 matching functions use the multi-lobe Gaussian fits of
Wyman, Sloan & Shirley, "Simple Analytic Approximations to the CIE XYZ Color
Matching Functions", JCGT 2013 (public domain formulas), accurate to ~1%.
"""
from __future__ import annotations

import numpy as np
import torch

N_CHANNELS = 3  # SPECTRUM_SAMPLES


def _g(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * np.exp(-0.5 * t * t)


def cie_xyz_fit(wavelength_nm):
    """Analytic CIE 1931 2-deg observer fit (Wyman et al. 2013)."""
    w = np.asarray(wavelength_nm, dtype=np.float64)
    x = (
        _g(w, 1.056, 599.8, 37.9, 31.0)
        + _g(w, 0.362, 442.0, 16.0, 26.7)
        + _g(w, -0.065, 501.1, 20.4, 26.2)
    )
    y = _g(w, 0.821, 568.8, 46.9, 40.5) + _g(w, 0.286, 530.9, 16.3, 31.1)
    z = _g(w, 1.217, 437.0, 11.8, 36.0) + _g(w, 0.681, 459.0, 26.0, 13.8)
    return np.stack([x, y, z], axis=-1)


# XYZ (D65 white) -> linear sRGB, same matrix as reference spectrum.cpp
XYZ_TO_SRGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)

# CIE standard illuminant D65 sampled by the same analytic fit normalization.
_WL_GRID = np.arange(360.0, 831.0, 1.0)
_XYZ_GRID = cie_xyz_fit(_WL_GRID)
_Y_NORM = np.trapezoid(_XYZ_GRID[:, 1], _WL_GRID)


def spd_to_rgb(wavelengths, values):
    """Convert a linearly-interpolated SPD (reflectance or radiance given as
    wavelength:value pairs, as in scene XML) to linear RGB.

    Mirrors InterpolatedSpectrum -> Spectrum::fromContinuousSpectrum ->
    toLinearRGB in the reference (libcore/spectrum.cpp).
    """
    wavelengths = np.asarray(wavelengths, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if wavelengths.size == 1:
        return np.repeat(values, 3).astype(np.float32)
    vals = np.interp(_WL_GRID, wavelengths, values, left=0.0, right=0.0)
    xyz = np.trapezoid(vals[:, None] * _XYZ_GRID, _WL_GRID, axis=0) / _Y_NORM
    rgb = XYZ_TO_SRGB @ xyz
    return np.maximum(rgb, 0.0).astype(np.float32)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Relative luminance of linear-sRGB spectra (reference spectrum.h getLuminance)."""
    return (
        rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169
    )


def is_black(rgb: torch.Tensor) -> torch.Tensor:
    return torch.all(rgb == 0.0, dim=-1)


def average(rgb: torch.Tensor) -> torch.Tensor:
    return torch.mean(rgb, dim=-1)


def max_component(rgb: torch.Tensor) -> torch.Tensor:
    return torch.amax(rgb, dim=-1)
