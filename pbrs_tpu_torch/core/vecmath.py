"""Vector math over ``[..., 3]`` tensors. Mirrors pbrs_tpu/core/vecmath.py
(plus ``radiometry.luminance``).

Component arithmetic in the JAX package's order: a dot product is
``ax*bx + ay*by + az*bz`` evaluated left to right, never a reduction, so
the results do not depend on a backend's reduction order.
"""

from __future__ import annotations

import torch

EPS = 1e-8

# CIE Y row of sRGB (D65) -> XYZ. [pbrs_tpu/radiometry.py:18-25]
LUMINANCE_RGB = (0.21267127, 0.71515972, 0.07216883)


def vec3(x, y, z):
    return torch.stack([x, y, z], dim=-1)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a, eps: float = EPS):
    """Unit vector; 0 for (near-)zero input instead of NaN."""
    n2 = dot(a, a)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp_min(n2, eps)),
                      torch.zeros_like(n2))
    return a * inv[..., None]


def weak_recip(x):
    """1/x with 0 -> 0."""
    nz = x != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp_min(x, 0.0))


def face_forward(v, ref):
    s = torch.where(dot(v, ref) < 0.0, -1.0, 1.0)
    return v * s[..., None]


def reflect(normal, wi):
    """Mirror wi about the (not necessarily unit) normal; the result lies
    on wi's side of the normal."""
    n2 = torch.clamp_min(dot(normal, normal), EPS)
    perp = (dot(wi, normal) / n2)[..., None] * normal
    parallel = wi - perp
    return wi - 2.0 * parallel


def refract(normal, wi, ni_over_no):
    """Refract unit wi (acute with unit normal) across the interface:
    (direction, total-internal-reflection mask); the mirror direction
    where TIR occurs."""
    cos_i = dot(wi, normal)
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    sin2_o = sin2_i * ni_over_no * ni_over_no
    full = sin2_o >= 1.0
    cos_o = safe_sqrt(1.0 - sin2_o)
    transmitted = -ni_over_no[..., None] * wi + (
        ni_over_no * cos_i - cos_o)[..., None] * normal
    return (torch.where(full[..., None], reflect(normal, wi), transmitted),
            full)


def spherical_direction(sin_theta, cos_theta, phi):
    """Unit vector at polar angle theta from +z, azimuth phi from +x."""
    return vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                cos_theta)


def make_coord_system(v):
    """Branchless orthonormal basis (Duff et al. 2017); v1 x v2 = v."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    s = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + z)
    b = x * y * a
    v1 = vec3(1.0 + s * x * x * a, s * b, -s * x)
    v2 = vec3(b, s + y * y * a, -y)
    return v1, v2


def orthonormal_frame(normal, tangent_hint):
    """(tangent, bitangent, normal) from a normal and a tangent hint, with
    an automatic basis where the hint is degenerate."""
    n = normalize(normal)
    b = cross(n, tangent_hint)
    good = dot(b, b) > 1e-12
    auto_t, _ = make_coord_system(n)
    b = torch.where(good[..., None], b, cross(n, auto_t))
    b = normalize(b)
    t = cross(b, n)
    return t, b, n


def to_local(t, b, n, w):
    return vec3(dot(w, t), dot(w, b), dot(w, n))


def to_world(t, b, n, w):
    return w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n


def luminance(c):
    """CIE Y of a linear-RGB color (pbrs_tpu/radiometry.py:29)."""
    wr, wg, wb = LUMINANCE_RGB
    return c[..., 0] * wr + c[..., 1] * wg + c[..., 2] * wb
