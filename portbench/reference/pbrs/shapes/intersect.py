"""Vectorized ray-primitive intersection over typed tables. Mirrors
pbrs_tpu/shapes/intersect.py.

Two-phase closest hit: a t-only [N, K] sweep of every ray against every
primitive, then a detail pass that rebuilds position/normal/uv/dpdu for
each ray's winning primitive. Normals face the incoming ray.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import vecmath as vm
from ..geometry import ray as ray_mod
from .tables import DISK, QUAD, SPHERE, TRIANGLE, GeometryTables

INF = float("inf")


@dataclass
class Hit:
    t: torch.Tensor  # [N]
    hit: torch.Tensor  # [N] bool
    pos: torch.Tensor  # [N,3]
    normal: torch.Tensor  # [N,3] facing wo
    uv: torch.Tensor  # [N,2]
    dpdu: torch.Tensor  # [N,3] tangent hint
    mat_id: torch.Tensor  # [N] int32
    wo: torch.Tensor  # [N,3] unit, towards the ray origin


# ----------------------------- t-only sweeps ------------------------------
# rays broadcast [N,1], prims [1,K] -> t [N,K], +inf on a miss.


def _sphere_roots(rays, center, radius):
    o = rays.origin[:, None, :]
    d = rays.dir[:, None, :]
    f = o - center[None, :, :]
    a = vm.dot(d, d)
    b_prime = -vm.dot(f, d)
    mid = f + (b_prime / a)[..., None] * d
    r2 = (radius * radius)[None, :]
    delta = r2 - vm.dot(mid, mid)
    has_root = delta >= 0.0
    c = vm.dot(f, f) - r2
    sign_b = torch.where(b_prime >= 0.0, 1.0, -1.0)
    q = b_prime + sign_b * vm.safe_sqrt(delta * a)
    q_safe = torch.where(q == 0.0, 1.0, q)
    t0 = c / q_safe
    t1 = q / a
    valid = has_root & (q != 0.0)
    t_low = torch.where(valid, torch.minimum(t0, t1), INF)
    t_high = torch.where(valid, torch.maximum(t0, t1), INF)
    return t_low, t_high


def sphere_t(rays, geom):
    t_low, t_high = _sphere_roots(rays, geom.sph_center, geom.sph_radius)
    t_max = rays.t_max[:, None]
    ok_low = (t_low >= ray_mod.T_MIN) & (t_low < t_max)
    ok_high = (t_high >= ray_mod.T_MIN) & (t_high < t_max)
    return torch.where(ok_low, t_low, torch.where(ok_high, t_high, INF))


def _quad_uv_t(rays, origin, edge_u, edge_v):
    o = rays.origin[:, None, :]
    d = rays.dir[:, None, :]
    n = vm.cross(edge_u, edge_v)[None, :, :]
    denom = vm.dot(d, n)
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    t = vm.dot(origin[None, :, :] - o, n) / denom_safe
    t = torch.where(denom != 0.0, t, INF)
    dvec = o + t[..., None] * d - origin[None, :, :]
    n2 = torch.clamp_min(vm.dot(n, n), 1e-30)
    u = vm.dot(vm.cross(dvec, edge_v[None, :, :]), n) / n2
    v = vm.dot(vm.cross(edge_u[None, :, :], dvec), n) / n2
    inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    return t, inside


def quad_t(rays, geom):
    t, inside = _quad_uv_t(rays, geom.quad_origin, geom.quad_u, geom.quad_v)
    valid = inside & (t >= ray_mod.T_MIN) & (t < rays.t_max[:, None])
    return torch.where(valid, t, INF)


def tri_t(rays, geom):
    p0, p1, p2 = geom.tri_p0, geom.tri_p1, geom.tri_p2
    o = rays.origin[:, None, :]
    d = rays.dir[:, None, :]
    n = vm.normalize(vm.cross(p0 - p1, p2 - p1)[None, :, :])
    denom = vm.dot(d, n)
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    t = vm.dot(p0[None, :, :] - o, n) / denom_safe
    t = torch.where(denom != 0.0, t, INF)
    p = o + t[..., None] * d
    b2 = vm.dot(vm.cross(p - p0[None], p - p1[None]), n)
    b0 = vm.dot(vm.cross(p - p1[None], p - p2[None]), n)
    b1 = vm.dot(vm.cross(p - p2[None], p - p0[None]), n)
    inside = (((b0 > 0) & (b1 > 0) & (b2 > 0))
              | ((b0 < 0) & (b1 < 0) & (b2 < 0)))
    valid = inside & (t >= ray_mod.T_MIN) & (t < rays.t_max[:, None])
    return torch.where(valid, t, INF)


def disk_t(rays, geom):
    center, normal = geom.disk_center, geom.disk_normal
    o = rays.origin[:, None, :]
    d = rays.dir[:, None, :]
    n = normal[None, :, :]
    denom = vm.dot(d, n)
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    t = vm.dot(center[None, :, :] - o, n) / denom_safe
    t = torch.where(denom != 0.0, t, INF)
    p = o + t[..., None] * d - center[None]
    r2 = vm.dot(geom.disk_radial, geom.disk_radial)[None, :]
    valid = ((vm.dot(p, p) <= r2) & (t >= ray_mod.T_MIN)
             & (t < rays.t_max[:, None]))
    return torch.where(valid, t, INF)


# ----------------------------- detail passes ------------------------------
# Per-lane winner parameters [N, ...] -> (pos, normal, uv, dpdu).


def _sphere_detail(rays, t, c, r):
    n = vm.normalize(ray_mod.position_at(rays, t) - c)
    # Push the hit point slightly outside the sphere surface.
    pos = c + n * (r * 1.00001)[..., None]
    theta = torch.arccos(torch.clamp(n[..., 1], -1.0, 1.0))
    phi = torch.atan2(n[..., 2], n[..., 0]) + math.pi
    uv = torch.stack([phi / (2.0 * math.pi), theta / math.pi], dim=-1)
    dpdu = vm.vec3(-n[..., 1], n[..., 0], torch.zeros_like(t))
    degenerate = vm.dot(dpdu, dpdu) < 1e-12
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=t.device)
    dpdu = torch.where(degenerate[..., None], x_axis, vm.normalize(dpdu))
    return pos, vm.face_forward(n, -rays.dir), uv, dpdu


def _quad_detail(rays, t, origin, eu, ev):
    n_raw = vm.cross(eu, ev)
    d = ray_mod.position_at(rays, t) - origin
    n2 = torch.clamp_min(vm.dot(n_raw, n_raw), 1e-30)
    u = vm.dot(vm.cross(d, ev), n_raw) / n2
    v = vm.dot(vm.cross(eu, d), n_raw) / n2
    pos = origin + u[..., None] * eu + v[..., None] * ev
    n = vm.face_forward(vm.normalize(n_raw), -rays.dir)
    return pos, n, torch.stack([u, v], dim=-1), eu


def _tri_detail(rays, t, p0, p1, p2, n0, n1, n2, uv0, uv1, uv2):
    n_geo = vm.normalize(vm.cross(p0 - p1, p2 - p1))
    p = ray_mod.position_at(rays, t)
    b2 = vm.dot(vm.cross(p - p0, p - p1), n_geo)
    b0 = vm.dot(vm.cross(p - p1, p - p2), n_geo)
    b1 = vm.dot(vm.cross(p - p2, p - p0), n_geo)
    total = b0 + b1 + b2
    total = torch.where(total == 0.0, 1.0, total)
    b0, b1, b2 = (b / total for b in (b0, b1, b2))
    pos = b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2
    ns = vm.normalize(b0[..., None] * n0 + b1[..., None] * n1
                      + b2[..., None] * n2)
    ns = torch.where((vm.dot(ns, ns) < 0.5)[..., None], n_geo, ns)
    uv = b0[..., None] * uv0 + b1[..., None] * uv1 + b2[..., None] * uv2
    return pos, vm.face_forward(ns, -rays.dir), uv, p1 - p0


def _disk_detail(rays, t, c, nd, radial):
    cp = ray_mod.position_at(rays, t) - c
    cp = cp - vm.dot(cp, nd)[..., None] * nd
    n = vm.face_forward(nd, -rays.dir)
    tangent = vm.normalize(vm.cross(n, cp))
    u_angle = torch.atan2(vm.dot(vm.cross(radial, cp), n), vm.dot(radial, cp))
    u = torch.remainder(u_angle / math.pi * 0.5 + 1.0, 1.0)
    v = vm.length(cp) / torch.clamp_min(vm.length(radial), 1e-20)
    return c + cp, n, torch.stack([u, v], dim=-1), tangent


# ------------------------------- dispatch ---------------------------------


def intersect(geom: GeometryTables, rays: ray_mod.RayBatch) -> Hit:
    """Closest hit over all typed tables (the broadcast sweep)."""
    t_all = torch.cat([sphere_t(rays, geom), quad_t(rays, geom),
                       tri_t(rays, geom), disk_t(rays, geom)], dim=1)
    t_best, win = torch.min(t_all, dim=1)  # first index among ties
    return hit_from_t_idx(geom, rays, t_best, win)


def hit_from_t_idx(geom: GeometryTables, rays, t_best, win) -> Hit:
    """Detail pass for winner prim indices (global over the sphere/quad/
    tri/disk concatenation; -1 or t=inf is a miss)."""
    n_s, n_q, n_t, n_d = geom.counts
    hit = torch.isfinite(t_best) & (win >= 0)
    t_safe = torch.where(hit, t_best, 1.0)
    win = torch.clamp_min(win, 0).to(torch.int64)
    q0, t0, d0 = n_s, n_s + n_q, n_s + n_q + n_t
    ptype = torch.where(win < q0, SPHERE, torch.where(
        win < t0, QUAD, torch.where(win < d0, TRIANGLE, DISK)))
    local = win - torch.where(win < q0, 0, torch.where(
        win < t0, q0, torch.where(win < d0, t0, d0)))

    def rows(kind, count):
        return torch.clamp(torch.where(ptype == kind, local, 0), 0, count - 1)

    i = rows(SPHERE, n_s)
    sph = _sphere_detail(rays, t_safe, geom.sph_center[i], geom.sph_radius[i])
    i = rows(QUAD, n_q)
    quad = _quad_detail(rays, t_safe, geom.quad_origin[i], geom.quad_u[i],
                        geom.quad_v[i])
    i = rows(TRIANGLE, n_t)
    tri = _tri_detail(rays, t_safe, *(getattr(geom, f)[i] for f in (
        "tri_p0", "tri_p1", "tri_p2", "tri_n0", "tri_n1", "tri_n2",
        "tri_uv0", "tri_uv1", "tri_uv2")))
    i = rows(DISK, n_d)
    disk = _disk_detail(rays, t_safe, geom.disk_center[i],
                        geom.disk_normal[i], geom.disk_radial[i])
    mats = [geom.sph_mat[rows(SPHERE, n_s)], geom.quad_mat[rows(QUAD, n_q)],
            geom.tri_mat[rows(TRIANGLE, n_t)], geom.disk_mat[rows(DISK, n_d)]]

    def select(vals):
        out = vals[0]
        for kind in (QUAD, TRIANGLE, DISK):
            sel = ptype == kind
            if vals[kind].ndim > sel.ndim:
                sel = sel[..., None]
            out = torch.where(sel, vals[kind], out)
        return out

    pos, normal, uv, dpdu = (select([d[f] for d in (sph, quad, tri, disk)])
                             for f in range(4))
    mat_id = select(mats)
    h3 = hit[:, None]
    zero = torch.zeros_like(pos)
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=pos.device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=pos.device)
    return Hit(
        t=torch.where(hit, t_best, INF),
        hit=hit,
        pos=torch.where(h3, pos, zero),
        normal=torch.where(h3, normal, z_axis),
        uv=torch.where(h3, uv, torch.zeros_like(uv)),
        dpdu=torch.where(h3, dpdu, x_axis),
        mat_id=torch.where(hit, mat_id, -1).to(torch.int32),
        wo=vm.normalize(-rays.dir),
    )


def occluded(geom: GeometryTables, rays: ray_mod.RayBatch):
    """Any hit within the ray extent."""
    blocked = torch.zeros(rays.origin.shape[0], dtype=torch.bool,
                          device=rays.origin.device)
    for t in (sphere_t(rays, geom), quad_t(rays, geom), tri_t(rays, geom),
              disk_t(rays, geom)):
        blocked = blocked | torch.isfinite(t).any(dim=1)
    return blocked
