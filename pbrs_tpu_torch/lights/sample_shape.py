"""Sampling points on light shapes + solid-angle pdfs. Mirrors the quad
branches of pbrs_tpu/lights/sample_shape.py; sphere, disk and triangle
lights raise NotImplementedError until their slice is ported.

Vectorized over per-ray gathered shape parameters ([N]-aligned).
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..geometry import ray as ray_mod

QUAD = 0
SPHERE = 1
DISK = 2
TRIANGLE = 3


def check_ported(present):
    missing = set(present) - {QUAD}
    if missing:
        raise NotImplementedError(
            f"pbrs_tpu.lights.sample_shape shapes {sorted(missing)} "
            "(sample_towards/pdf_at/intersect_shape) are not ported to "
            "pbrs_tpu_torch yet")


def _aligned_quad_hit(o, d, t_lo, t_hi, origin, eu, ev):
    n = vm.cross(eu, ev)
    denom = vm.dot(d, n)
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    t = vm.dot(origin - o, n) / denom_safe
    p = o + t[..., None] * d
    dv = p - origin
    n2 = torch.clamp_min(vm.dot(n, n), 1e-30)
    u = vm.dot(vm.cross(dv, ev), n) / n2
    v = vm.dot(vm.cross(eu, dv), n) / n2
    ok = ((denom != 0.0) & (t >= t_lo) & (t < t_hi)
          & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0))
    return ok, t, vm.normalize(n)


def intersect_shape(kind, params, origin, direction, t_lo=ray_mod.T_MIN,
                    t_hi=float("inf"), present=(QUAD,)):
    """Per-ray rays vs their per-ray light shape -> (hit, t, light normal)."""
    check_ported(present)
    ok, t, n = _aligned_quad_hit(origin, direction, t_lo, t_hi,
                                 params["p0"], params["p1"], params["p2"])
    is_quad = kind == QUAD
    return (ok & is_quad, torch.where(is_quad, t, 0.0),
            torch.where(is_quad[..., None], n, 0.0))


def shape_area(kind, params, present=(QUAD,)):
    check_ported(present)
    a = vm.length(vm.cross(params["p1"], params["p2"]))
    return torch.where(kind == QUAD, a, 0.0)


def sample_towards(kind, params, target_pos, u2, present=(QUAD,)):
    """Uniform point on the shape -> (point, light normal)."""
    check_ported(present)
    p0, p1, p2 = params["p0"], params["p1"], params["p2"]
    u, v = u2[..., 0], u2[..., 1]
    k3 = (kind == QUAD)[..., None]
    pt = p0 + u[..., None] * p1 + v[..., None] * p2
    n = vm.normalize(vm.cross(p1, p2))
    return torch.where(k3, pt, 0.0), torch.where(k3, n, 0.0)


def pdf_at(kind, params, target_pos, wi, present=(QUAD,)):
    """Solid-angle pdf that direction wi from target_pos hits the shape:
    distance^2 / (|cos| * area)."""
    area = shape_area(kind, params, present)
    wi_n = vm.normalize(wi)
    ok, t, n = intersect_shape(kind, params, target_pos, wi_n,
                               present=present)
    d2 = t * t
    cos_l = torch.abs(vm.dot(n, -wi_n))
    pdf = torch.where(ok, d2 / torch.clamp_min(cos_l * area, 1e-30), 0.0)
    return torch.where(kind != SPHERE, pdf, 0.0)
