"""Natural cubic splines (host, NumPy). Mirrors the host part of
pbrs_tpu/core/spline.py: ``tridiagonal_solve`` and ``CubicSpline``, which
spectral resampling in ``radiometry.py`` uses. The device Catmull-Rom
machinery serves the Fourier BSDF and lands with it.
"""

from __future__ import annotations

import numpy as np


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
