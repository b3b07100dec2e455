"""Sampling points on light shapes + solid-angle pdfs. Mirrors
pbrs_tpu/lights/sample_shape.py: quads, spheres (visible-cone sampling),
disks and triangles.

Vectorized over per-ray gathered shape parameters ([N]-aligned): quad
origin/edge_u/edge_v, sphere center + radius (scalar), disk
center/normal/radial, triangle vertices. `present` statically prunes the
shape kinds the scene's lights cannot have.
"""

from __future__ import annotations

import math

import torch

from ..bxdf.lobes import concentric_sample_disk
from ..core import vecmath as vm
from ..geometry import ray as ray_mod

QUAD = 0
SPHERE = 1
DISK = 2
TRIANGLE = 3
ALL = (QUAD, SPHERE, DISK, TRIANGLE)


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


def _aligned_sphere_hit(o, d, t_lo, t_hi, center, radius):
    f = o - center
    a = vm.dot(d, d)
    b_prime = -vm.dot(f, d)
    mid = f + (b_prime / torch.clamp_min(a, 1e-30))[..., None] * d
    r2 = radius * radius
    delta = r2 - vm.dot(mid, mid)
    has = delta >= 0.0
    c = vm.dot(f, f) - r2
    q = b_prime + torch.where(b_prime >= 0, 1.0, -1.0) * vm.safe_sqrt(
        delta * a)
    q_safe = torch.where(q == 0.0, 1.0, q)
    t0 = c / q_safe
    t1 = q / torch.clamp_min(a, 1e-30)
    t_low = torch.minimum(t0, t1)
    t_high = torch.maximum(t0, t1)
    ok_lo = (t_low >= t_lo) & (t_low < t_hi)
    ok_hi = (t_high >= t_lo) & (t_high < t_hi)
    t = torch.where(ok_lo, t_low, t_high)
    ok = has & (q != 0.0) & (ok_lo | ok_hi)
    p = o + t[..., None] * d
    return ok, t, vm.normalize(p - center)


def _aligned_disk_hit(o, d, t_lo, t_hi, center, normal, radial):
    denom = vm.dot(d, normal)
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    t = vm.dot(center - o, normal) / denom_safe
    p = o + t[..., None] * d
    inside = vm.dot(p - center, p - center) <= vm.dot(radial, radial)
    ok = (denom != 0.0) & (t >= t_lo) & (t < t_hi) & inside
    return ok, t, normal


def _aligned_tri_hit(o, d, t_lo, t_hi, p0, p1, p2):
    n = vm.normalize(vm.cross(p0 - p1, p2 - p1))
    denom = vm.dot(d, n)
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    t = vm.dot(p0 - o, n) / denom_safe
    p = o + t[..., None] * d
    b2 = vm.dot(vm.cross(p - p0, p - p1), n)
    b0 = vm.dot(vm.cross(p - p1, p - p2), n)
    b1 = vm.dot(vm.cross(p - p2, p - p0), n)
    inside = (((b0 > 0) & (b1 > 0) & (b2 > 0))
              | ((b0 < 0) & (b1 < 0) & (b2 < 0)))
    ok = (denom != 0.0) & (t >= t_lo) & (t < t_hi) & inside
    return ok, t, n


def intersect_shape(kind, params, origin, direction, t_lo=ray_mod.T_MIN,
                    t_hi=float("inf"), present=ALL):
    """Per-ray rays vs their per-ray light shape -> (hit, t, light
    normal)."""
    p0, p1, p2, scalar = (params["p0"], params["p1"], params["p2"],
                          params["scalar"])
    t_hi = torch.full(origin.shape[:-1], float(t_hi), dtype=torch.float32,
                      device=origin.device)
    hits = {}
    if QUAD in present:
        hits[QUAD] = _aligned_quad_hit(origin, direction, t_lo, t_hi, p0, p1,
                                       p2)
    if SPHERE in present:
        hits[SPHERE] = _aligned_sphere_hit(origin, direction, t_lo, t_hi, p0,
                                           scalar)
    if DISK in present:
        hits[DISK] = _aligned_disk_hit(origin, direction, t_lo, t_hi, p0, p1,
                                       p2)
    if TRIANGLE in present:
        hits[TRIANGLE] = _aligned_tri_hit(origin, direction, t_lo, t_hi, p0,
                                          p1, p2)
    ok = torch.zeros(origin.shape[:-1], dtype=torch.bool, device=origin.device)
    t = torch.zeros(origin.shape[:-1], dtype=torch.float32,
                    device=origin.device)
    n = torch.zeros_like(origin)
    for kk, (okk, tk, nk) in hits.items():
        sel = kind == kk
        ok = torch.where(sel, okk, ok)
        t = torch.where(sel, tk, t)
        n = torch.where(sel[..., None], nk, n)
    return ok, t, n


def shape_area(kind, params, present=ALL):
    p0, p1, p2, scalar = (params["p0"], params["p1"], params["p2"],
                          params["scalar"])
    a = torch.zeros(kind.shape, dtype=torch.float32, device=kind.device)
    if QUAD in present:
        a = torch.where(kind == QUAD, vm.length(vm.cross(p1, p2)), a)
    if SPHERE in present:
        a = torch.where(kind == SPHERE, 4.0 * math.pi * (scalar * scalar), a)
    if DISK in present:
        a = torch.where(kind == DISK, math.pi * vm.dot(p2, p2), a)
    if TRIANGLE in present:
        a = torch.where(kind == TRIANGLE,
                        0.5 * vm.length(vm.cross(p0 - p1, p2 - p1)), a)
    return a


def sample_towards(kind, params, target_pos, u2, present=ALL):
    """A point on the shape (visible-cone sampling for spheres seen from
    outside) -> (point [N,3], light normal [N,3])."""
    p0, p1, p2, scalar = (params["p0"], params["p1"], params["p2"],
                          params["scalar"])
    u, v = u2[..., 0], u2[..., 1]
    k3 = kind[..., None]
    pt = torch.zeros_like(target_pos)
    n = torch.zeros_like(target_pos)

    if QUAD in present:
        pt_quad = p0 + u[..., None] * p1 + v[..., None] * p2
        n_quad = vm.normalize(vm.cross(p1, p2))
        pt = torch.where(k3 == QUAD, pt_quad, pt)
        n = torch.where(k3 == QUAD, n_quad, n)

    if TRIANGLE in present:
        over = (u + v) > 1.0
        tu = torch.where(over, 1.0 - v, u)
        tv = torch.where(over, 1.0 - u, v)
        pt_tri = p0 + tu[..., None] * (p1 - p0) + tv[..., None] * (p2 - p0)
        n_tri = vm.normalize(vm.cross(p0 - p1, p2 - p1))
        pt = torch.where(k3 == TRIANGLE, pt_tri, pt)
        n = torch.where(k3 == TRIANGLE, n_tri, n)

    if DISK in present:
        dx, dy = concentric_sample_disk(u2)
        radial2 = vm.cross(p1, p2)
        pt_disk = p0 + dx[..., None] * p2 + dy[..., None] * radial2
        pt = torch.where(k3 == DISK, pt_disk, pt)
        n = torch.where(k3 == DISK, p1, n)

    if SPHERE in present:
        wc = p0 - target_pos
        dc2 = vm.dot(wc, wc)
        r2 = scalar * scalar
        inside = dc2 < r2
        theta_u = 2.0 * math.pi * u
        phi_u = torch.arccos(torch.clamp(2.0 * v - 1.0, -1.0, 1.0))
        dir_u = vm.vec3(torch.sin(phi_u) * torch.cos(theta_u),
                        torch.sin(phi_u) * torch.sin(theta_u), 2.0 * v - 1.0)
        pt_inside = p0 + scalar[..., None] * dir_u
        sin2_t_max = r2 / torch.clamp_min(dc2, 1e-30)
        cos_t_max = vm.safe_sqrt(1.0 - sin2_t_max)
        cos_t = (1.0 - u) + u * cos_t_max
        sin2_t = torch.clamp_min(1.0 - cos_t * cos_t, 0.0)
        phi = v * 2.0 * math.pi
        dc = torch.sqrt(torch.clamp_min(dc2, 1e-30))
        ds = dc * cos_t - vm.safe_sqrt(r2 - dc2 * sin2_t)
        cos_alpha = (dc2 + r2 - ds * ds) / torch.clamp_min(2.0 * dc * scalar,
                                                           1e-30)
        sin_alpha = vm.safe_sqrt(1.0 - cos_alpha * cos_alpha)
        n_obj = vm.spherical_direction(sin_alpha, cos_alpha, phi)
        to_target = vm.normalize(-wc)
        bx, by = vm.make_coord_system(to_target)
        n_world = (n_obj[..., 0:1] * bx + n_obj[..., 1:2] * by
                   + n_obj[..., 2:3] * to_target)
        pt_outside = p0 + n_world * scalar[..., None]
        i3 = inside[..., None]
        pt = torch.where(k3 == SPHERE, torch.where(i3, pt_inside, pt_outside),
                         pt)
        n = torch.where(k3 == SPHERE, torch.where(i3, dir_u, n_world), n)

    return pt, n


def pdf_at(kind, params, target_pos, wi, present=ALL):
    """Solid-angle pdf that direction wi from target_pos hits the shape:
    the uniform-cone pdf for spheres, distance^2 / (|cos| area) after a
    re-intersection for the other shapes."""
    p0, scalar = params["p0"], params["scalar"]
    area = shape_area(kind, params, present)
    pdf = torch.zeros(kind.shape, dtype=torch.float32, device=kind.device)
    if SPHERE in present:
        wc = p0 - target_pos
        dc2 = vm.dot(wc, wc)
        r2 = scalar * scalar
        inside = dc2 < r2
        sin2_t_max = r2 / torch.clamp_min(dc2, 1e-30)
        cos_t_max = vm.safe_sqrt(1.0 - sin2_t_max)
        cos_t = vm.dot(wc, wi) / torch.clamp_min(
            torch.sqrt(dc2) * vm.length(wi), 1e-30)
        cone = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - cos_t_max), 1e-30)
        pdf_sphere = torch.where(
            inside, 1.0 / torch.clamp_min(area, 1e-30),
            torch.where(cos_t > cos_t_max, cone, 0.0))
        pdf = torch.where(kind == SPHERE, pdf_sphere, pdf)
    generic = tuple(k for k in present if k != SPHERE)
    if generic:
        wi_n = vm.normalize(wi)
        ok, t, n = intersect_shape(kind, params, target_pos, wi_n,
                                   present=generic)
        cos_l = torch.abs(vm.dot(n, -wi_n))
        pdf_generic = torch.where(
            ok, t * t / torch.clamp_min(cos_l * area, 1e-30), 0.0)
        pdf = torch.where(kind != SPHERE, pdf_generic, pdf)
    return pdf
