"""Pixel reconstruction filters, applied by filter importance sampling.
Mirrors pbrs_tpu/core/filters.py (its Gaussian with the reference's
missing `.exp()` restored).

The per-sample pixel jitter is drawn from the normalized filter
distribution instead of uniformly, through an inverse-CDF table built on
the host with NumPy and looked up on the device. A non-negative filter
(box, triangle, Gaussian) then carries weight 1; a filter with negative
lobes (Mitchell, Lanczos) draws from |f| and carries the signed weight
sign(f) * integral|f| / integral f a sample.
"""

from __future__ import annotations

import numpy as np
import torch

BOX = 0
TRIANGLE = 1
GAUSSIAN = 2
MITCHELL = 3
LANCZOS = 4
# The CLI's and render_image's filter names.
KINDS = {"box": BOX, "triangle": TRIANGLE, "gaussian": GAUSSIAN,
         "mitchell": MITCHELL, "sinc": LANCZOS, "lanczos": LANCZOS}

_CDF_RES = 1024
# NumPy 2 renamed trapz to trapezoid.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def eval_filter_1d(kind: int, radius: float, x, alpha=2.0, b=1.0 / 3.0,
                   c=1.0 / 3.0, tau=3.0):
    """1-D filter profile (the 2-D filters are separable products),
    host-side NumPy in float64."""
    x = np.asarray(x, np.float64)
    ax = np.abs(x)
    if kind == BOX:
        return (ax <= radius).astype(np.float64)
    if kind == TRIANGLE:
        return np.maximum(radius - ax, 0.0)
    if kind == GAUSSIAN:
        return np.maximum(
            np.exp(-alpha * x * x) - np.exp(-alpha * radius * radius), 0.0
        )
    if kind == MITCHELL:
        t = np.clip(ax / radius, 0, 1) * 2.0
        f1 = (
            (12.0 - 9.0 * b - 6.0 * c) * t**3
            + (-18.0 + 12.0 * b + 6.0 * c) * t**2
            + (6.0 - 2.0 * b)
        )
        f2 = (
            (-b - 6.0 * c) * t**3 + (6.0 * b + 30.0 * c) * t**2
            + (-12.0 * b - 48.0 * c) * t + (8.0 * b + 24.0 * c)
        )
        val = np.where(t > 1.0, f2, f1) * (1.0 / 6.0)
        return np.where(ax <= radius, val, 0.0)
    if kind == LANCZOS:
        def sinc(v):
            v = np.abs(v)
            return np.where(v < 1e-5, 1.0, np.sin(np.pi * v) / (np.pi * v))
        window = sinc(x / radius * tau)
        return np.where(ax <= radius, sinc(x) * window, 0.0)
    raise ValueError(f"unknown filter kind {kind}")


class FilterTable:
    """Inverse-CDF table [_CDF_RES + 1] and per-bin signed weights.
    `weighted` is False for a non-negative filter, whose weights are all
    exactly 1 (the film then skips the multiply)."""

    def __init__(self, inv_cdf, weights, weighted: bool):
        self.inv_cdf = inv_cdf
        self.weights = weights
        self.weighted = weighted


def make_filter_cdf(kind: int, radius: float, device=None,
                    **params) -> FilterTable:
    """The weighted filter-importance-sampling table of a filter kind and
    radius: samples from |f| / integral|f|, each with the signed weight of
    its bin's midpoint."""
    xs = np.linspace(-radius, radius, 4096)
    f = eval_filter_1d(kind, radius, xs, **params)
    af = np.abs(f)
    ratio = float(_trapezoid(af, xs) / _trapezoid(f, xs))
    cdf = np.cumsum(af)
    cdf = cdf / cdf[-1]
    u = np.linspace(0.0, 1.0, _CDF_RES + 1)
    inv = np.interp(u, cdf, xs)
    mid = 0.5 * (inv[:-1] + inv[1:])
    sgn = np.sign(eval_filter_1d(kind, radius, mid, **params))
    sgn = np.where(sgn == 0.0, 1.0, sgn)
    wgt = np.concatenate([sgn * ratio, [sgn[-1] * ratio]])
    weighted = bool(np.any(wgt != 1.0))
    return FilterTable(
        torch.from_numpy(inv.astype(np.float32)).to(device),
        torch.from_numpy(wgt.astype(np.float32)).to(device),
        weighted,
    )


def filter_table(pixel_filter, device=None):
    """The table of a (kind name, radius) pair, e.g. ("gaussian", 1.5)."""
    kind, radius = pixel_filter
    if kind not in KINDS:
        raise ValueError(f"filter kind must be one of {sorted(KINDS)}, got "
                         f"{kind!r}")
    return make_filter_cdf(KINDS[kind], float(radius), device=device)


def sample_filter_offset(table: FilterTable, u):
    """Map uniform u [N] -> (filter-distributed offset, signed weight or
    None for an unweighted filter)."""
    pos = u * _CDF_RES
    i0 = torch.clamp(pos.to(torch.int32), 0, _CDF_RES - 1).to(torch.int64)
    frac = pos - i0.to(torch.float32)
    a = table.inv_cdf[i0]
    b = table.inv_cdf[i0 + 1]
    off = a + frac * (b - a)
    if not table.weighted:
        return off, None
    return off, table.weights[i0]
