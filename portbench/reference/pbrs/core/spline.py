"""Splines. Mirrors pbrs_tpu/core/spline.py: the host's natural cubic
spline (``tridiagonal_solve``, ``CubicSpline``, NumPy), which spectral
resampling in ``radiometry.py`` uses, and the tensor-side Catmull-Rom
weights (``find_interval``, ``catmull_rom_weights``, ``catmull_rom_taps``)
that the Fourier BSDF interpolates its zenith grids with.
"""

from __future__ import annotations

import numpy as np
import torch


def tridiagonal_solve(a, b, c, d):
    """Thomas algorithm: a=sub, b=diag, c=super, d=rhs."""
    n = len(d)
    b = np.array(b, np.float64)
    d = np.array(d, np.float64)
    for i in range(1, n):
        w = a[i - 1] / b[i - 1]
        b[i] -= w * c[i - 1]
        d[i] -= w * d[i - 1]
    x = np.zeros(n)
    x[-1] = d[-1] / b[-1]
    for i in range(n - 2, -1, -1):
        x[i] = (d[i] - c[i] * x[i + 1]) / b[i]
    return x


class CubicSpline:
    """Natural cubic interpolating spline."""

    def __init__(self, xs, ys):
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        n = len(xs)
        assert n >= 2 and np.all(np.diff(xs) > 0)
        h = np.diff(xs)
        if n == 2:
            m = np.zeros(2)
        else:
            # Natural boundary: second derivative 0 at both ends.
            a = h[:-1].copy()
            b = 2.0 * (h[:-1] + h[1:])
            c = h[1:].copy()
            d = 6.0 * (np.diff(ys[1:]) / h[1:] - np.diff(ys[:-1]) / h[:-1])
            m_inner = tridiagonal_solve(a, b, c, d)
            m = np.concatenate([[0.0], m_inner, [0.0]])
        self.xs, self.ys, self.h, self.m = xs, ys, h, m

    def evaluate(self, x):
        x = np.asarray(x, np.float64)
        i = np.clip(np.searchsorted(self.xs, x) - 1, 0, len(self.xs) - 2)
        x0, x1 = self.xs[i], self.xs[i + 1]
        y0, y1 = self.ys[i], self.ys[i + 1]
        m0, m1 = self.m[i], self.m[i + 1]
        h = x1 - x0
        t = (x - x0)
        y = (
            m0 * (x1 - x) ** 3 / (6 * h)
            + m1 * t**3 / (6 * h)
            + (y0 / h - m0 * h / 6) * (x1 - x)
            + (y1 / h - m1 * h / 6) * t
        )
        # Out-of-domain clamps to the endpoint values.
        y = np.where(x <= self.xs[0], self.ys[0], y)
        return np.where(x >= self.xs[-1], self.ys[-1], y)


# ------------------------- device (Catmull-Rom) ----------------------------

def find_interval(grid, x):
    """Largest i with grid[i] <= x, clamped to [0, len-2]."""
    i = torch.searchsorted(grid, x.contiguous(), right=True) - 1
    return torch.clamp(i, 0, grid.shape[0] - 2)


def catmull_rom_weights(grid, x):
    """Four interpolation weights over grid nodes [i-1, i, i+1, i+2] with
    one-sided boundary derivatives. Returns (offset = i-1, [..., 4]
    weights); the weights sum to 1."""
    n = grid.shape[0]
    i = find_interval(grid, x)
    x0 = grid[i]
    x1 = grid[i + 1]
    dx = torch.where(x1 == x0, 1.0, x1 - x0)
    t = (x - x0) / dx
    t2 = t * t
    t3 = t2 * t

    w1 = 2.0 * t3 - 3.0 * t2 + 1.0
    w2 = -2.0 * t3 + 3.0 * t2

    has_prev = i > 0
    im1 = torch.clamp_min(i - 1, 0)
    span_p = grid[i + 1] - grid[im1]
    d0t = (t3 - 2.0 * t2 + t)
    d0 = d0t * dx / torch.where(span_p == 0.0, 1.0, span_p)
    w0 = torch.where(has_prev, -d0, 0.0)
    w2 = w2 + torch.where(has_prev, d0, 0.0)
    w1 = w1 + torch.where(has_prev, 0.0, -d0t)
    w2 = w2 + torch.where(has_prev, 0.0, d0t)

    has_next = (i + 2) < n
    ip2 = torch.clamp_max(i + 2, n - 1)
    span_n = grid[ip2] - grid[i]
    d1t = (t3 - t2)
    d1 = d1t * dx / torch.where(span_n == 0.0, 1.0, span_n)
    w3 = torch.where(has_next, d1, 0.0)
    w1 = w1 - torch.where(has_next, d1, 0.0)
    w2 = w2 + torch.where(has_next, 0.0, d1t)
    w1 = w1 - torch.where(has_next, 0.0, d1t)

    # Tap k addresses node clip(i-1+k, 0, n-1); out-of-range taps carry
    # zero weight.
    return i - 1, torch.stack([w0, w1, w2, w3], dim=-1)


def catmull_rom_taps(grid, offset):
    """Clamped node indices for the four weights: [..., 4]."""
    k = torch.arange(4, dtype=offset.dtype, device=offset.device)
    return torch.clamp(offset[..., None] + k, 0, grid.shape[0] - 1)
