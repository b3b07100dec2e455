"""Radiometry: the host-side spectral utilities the PBRT loader calls.
Mirrors pbrs_tpu/radiometry.py (``XYZ_TO_RGB``, ``temperature_to_rgb``,
``sampled_spectrum_to_rgb``), in NumPy.

Spectral -> RGB uses the 471-sample CIE 1931 standard observer tables
(``data/cie1931.npz``, a copy of the JAX package's asset) with
natural-cubic-spline SPD resampling; it runs once at scene-load time.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# sRGB (D65) <-> CIE XYZ.
RGB_TO_XYZ = np.array(
    [
        [0.41245330, 0.35757984, 0.18042262],
        [0.21267127, 0.71515972, 0.07216883],
        [0.01933384, 0.11919363, 0.95022693],
    ],
    dtype=np.float32,
)
XYZ_TO_RGB = np.linalg.inv(RGB_TO_XYZ.astype(np.float64)).astype(np.float32)


def _load_cie():
    path = Path(__file__).resolve().parent / "data" / "cie1931.npz"
    with np.load(path) as z:
        return {k: z[k].astype(np.float64) for k in z.files}


_CIE = _load_cie()
_CIE_LAMBDA = _CIE["cie_lambda"]
_CIE_X_TAB, _CIE_Y_TAB, _CIE_Z_TAB = (_CIE["cie_x"], _CIE["cie_y"],
                                      _CIE["cie_z"])

# Normalization: the plain sum over the 1 nm table.
CIE_Y_INTEGRAL = float(_CIE_Y_TAB.sum())


def blackbody(wavelength_nm, temperature_k):
    """Planck spectral radiance (W sr^-1 m^-3)."""
    lam = np.asarray(wavelength_nm, dtype=np.float64) * 1e-9
    h = 6.62606957e-34
    c = 299792458.0
    kb = 1.3806488e-23
    return (2.0 * h * c * c) / (
        lam**5 * (np.expm1(h * c / (lam * kb * float(temperature_k))))
    )


def blackbody_normalized(wavelength_nm, temperature_k):
    """Planck's law scaled so the Wien-peak wavelength has value 1."""
    lambda_max_nm = 2.8977721e-3 / float(temperature_k) * 1e9
    peak = blackbody(lambda_max_nm, temperature_k)
    return blackbody(wavelength_nm, temperature_k) / peak


def sampled_spectrum_to_rgb(wavelengths_nm, values):
    """Integrate an SPD against the CIE observer and convert to linear RGB:
    sort the samples, evaluate a natural cubic spline through them at every
    CIE table wavelength, dot with the X/Y/Z tables, scale by 1/sum(CIE_Y)."""
    from .core.spline import CubicSpline

    lam = np.asarray(wavelengths_nm, dtype=np.float64)
    val = np.asarray(values, dtype=np.float64)
    order = np.argsort(lam)
    lam, val = lam[order], val[order]
    if lam.size == 1:
        dense = np.full_like(_CIE_LAMBDA, val[0])
    else:
        dense = np.asarray(
            CubicSpline(lam.astype(np.float32), val.astype(np.float32))
            .evaluate(_CIE_LAMBDA.astype(np.float32)),
            dtype=np.float64,
        )
    x = float(np.sum(dense * _CIE_X_TAB)) / CIE_Y_INTEGRAL
    y = float(np.sum(dense * _CIE_Y_TAB)) / CIE_Y_INTEGRAL
    z = float(np.sum(dense * _CIE_Z_TAB)) / CIE_Y_INTEGRAL
    rgb = XYZ_TO_RGB @ np.array([x, y, z])
    return np.maximum(rgb, 0.0).astype(np.float32)


def temperature_to_rgb(temperature_k):
    """Blackbody temperature -> normalized linear RGB."""
    lam = _CIE_LAMBDA
    spd = blackbody_normalized(lam, temperature_k)
    return sampled_spectrum_to_rgb(lam, spd)
