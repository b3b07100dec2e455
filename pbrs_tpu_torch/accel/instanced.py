"""Trace-time instancing: master geometry stored once behind per-instance
affine transforms. Mirrors pbrs_tpu/accel/instanced.py.

An instance is intersected by moving the ray batch into object space with
the inverse transform (the direction is left unnormalized, so t is the same
in both spaces), tracing the master, and mapping the winner's position,
normal and tangent back with the forward / inverse-transpose matrices. An
instance whose world bounds no ray of the batch reaches is skipped. Groups
that are small and exact under their transforms (``flattenable``) are baked
into world-space tables instead (``flatten_groups``), before the tracer
builds its BVH families.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core import vecmath as vm
from ..geometry import ray as ray_mod
from ..shapes import intersect as isect_mod
from ..shapes.tables import GeometryTables


@dataclass
class InstanceGroup:
    """Master geometry + stacked instance transforms: fwd/inv [I, 3, 4]
    object->world / world->object, inv_t [I, 3, 3] the normal transform,
    bbox_lo/hi [I, 3] world bounds of each instance's master AABB."""

    geom: GeometryTables
    fwd: torch.Tensor
    inv: torch.Tensor
    inv_t: torch.Tensor
    bbox_lo: torch.Tensor
    bbox_hi: torch.Tensor

    def to(self, device) -> "InstanceGroup":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def make_group(master: GeometryTables, transforms,
               master_bound) -> InstanceGroup:
    """Host build. transforms: [I, 4, 4] object->world; master_bound:
    (lo, hi) object-space AABB of the master geometry."""
    tf = np.asarray(transforms, np.float64)
    assert tf.ndim == 3 and tf.shape[1:] == (4, 4), tf.shape
    fwd = tf[:, :3, :]
    inv = np.stack([np.linalg.inv(m)[:3, :] for m in tf])
    inv_t = np.stack([np.linalg.inv(m[:3, :3]).T for m in tf])
    lo, hi = (np.asarray(x, np.float64) for x in master_bound)
    corners = np.stack(
        [np.array([[lo, hi][ix][0], [lo, hi][iy][1], [lo, hi][iz][2]])
         for ix in (0, 1) for iy in (0, 1) for iz in (0, 1)])  # [8,3]
    wc = np.einsum("iab,cb->ica", fwd[:, :, :3], corners) + fwd[:, None, :, 3]

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return InstanceGroup(geom=master, fwd=f32(fwd), inv=f32(inv),
                         inv_t=f32(inv_t), bbox_lo=f32(wc.min(axis=1)),
                         bbox_hi=f32(wc.max(axis=1)))


def _np(a):
    return a.detach().cpu().numpy()


def _apply_affine(m34, p):
    return p @ m34[:, :3].T + m34[:, 3]


def _transform_rays(rays, inv34):
    """World rays -> object space, direction unnormalized."""
    return rays.replace(origin=_apply_affine(inv34, rays.origin),
                        dir=rays.dir @ inv34[:, :3].T)


def _batch_hits_bbox(rays, lo, hi):
    """True when any ray's slab test hits the [3] world AABB."""
    inv = 1.0 / torch.where(rays.dir == 0.0, 1e-30, rays.dir)
    t0 = (lo[None] - rays.origin) * inv
    t1 = (hi[None] - rays.origin) * inv
    t_in = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_out = torch.amin(torch.maximum(t0, t1), dim=-1)
    ok = (t_in <= t_out) & (t_out >= ray_mod.T_MIN) & (t_in < rays.t_max)
    return bool(ok.any())


def intersect_t_group(grp: InstanceGroup, rays, trace_t_fn):
    """Closest hit over all instances: (t [N], inst [N], win [N]), inf / -1
    on a miss. trace_t_fn(geom, rays) -> (t, win) is the master's t-only
    tracer."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    t_best = torch.full((n,), float("inf"), device=dev)
    inst_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    win_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for i in range(grp.inv.shape[0]):
        if not _batch_hits_bbox(rays, grp.bbox_lo[i], grp.bbox_hi[i]):
            continue
        t_i, win_i = trace_t_fn(grp.geom, _transform_rays(rays, grp.inv[i]))
        closer = t_i < t_best
        t_best = torch.where(closer, t_i, t_best)
        inst_best = torch.where(closer, i, inst_best)
        win_best = torch.where(closer, win_i.to(torch.int32), win_best)
    return t_best, inst_best, win_best


def occluded_group(grp: InstanceGroup, rays, occlude_fn):
    """Any hit over all instances. occlude_fn(geom, rays) -> bool [N]."""
    blocked = torch.zeros(rays.origin.shape[0], dtype=torch.bool,
                          device=rays.origin.device)
    for i in range(grp.inv.shape[0]):
        if _batch_hits_bbox(rays, grp.bbox_lo[i], grp.bbox_hi[i]):
            blocked = blocked | occlude_fn(
                grp.geom, _transform_rays(rays, grp.inv[i]))
    return blocked


def hit_from_group(grp: InstanceGroup, rays, t, inst, win) -> isect_mod.Hit:
    """Detail pass: the object-space interaction of each lane's winning
    (instance, prim), mapped back to world space."""
    safe = torch.clamp_min(inst, 0).to(torch.int64)
    inv34, fwd34, invt = grp.inv[safe], grp.fwd[safe], grp.inv_t[safe]
    r_obj = rays.replace(
        origin=torch.einsum("nab,nb->na", inv34[:, :, :3], rays.origin)
        + inv34[:, :, 3],
        dir=torch.einsum("nab,nb->na", inv34[:, :, :3], rays.dir))
    h = isect_mod.hit_from_t_idx(grp.geom, r_obj, t, win)
    pos_w = torch.einsum("nab,nb->na", fwd34[:, :, :3], h.pos) + fwd34[:, :, 3]
    n_w = vm.normalize(torch.einsum("nab,nb->na", invt, h.normal))
    dpdu_w = torch.einsum("nab,nb->na", fwd34[:, :, :3], h.dpdu)
    hit = h.hit & (inst >= 0)
    h3 = hit[:, None]
    return dataclasses.replace(
        h, hit=hit, pos=torch.where(h3, pos_w, h.pos),
        normal=torch.where(h3, n_w, h.normal),
        dpdu=torch.where(h3, dpdu_w, h.dpdu), wo=vm.normalize(-rays.dir),
        mat_id=torch.where(hit, h.mat_id, -1).to(torch.int32))


def merge_hits(a: isect_mod.Hit, b: isect_mod.Hit) -> isect_mod.Hit:
    """Per-lane closest of two Hit batches."""
    bw = b.hit & (b.t < a.t)

    def pick(x, y):
        return torch.where(bw[:, None] if x.dim() > 1 else bw, y, x)

    return isect_mod.Hit(
        t=pick(a.t, b.t), hit=a.hit | b.hit, pos=pick(a.pos, b.pos),
        normal=pick(a.normal, b.normal), uv=pick(a.uv, b.uv),
        dpdu=pick(a.dpdu, b.dpdu), mat_id=pick(a.mat_id, b.mat_id), wo=a.wo)


FLATTEN_MAX = 16384  # instances x prims below this bake into the tracer


def flattenable(grp: InstanceGroup) -> bool:
    """True when the tracer may bake this group into world-space tables:
    small enough, and every real primitive exact under the transforms
    (triangles/quads under any affine; spheres/disks only under
    similarities). Never-hit dummy rows of a master do not count."""
    g = grp.geom
    n_inst = int(grp.fwd.shape[0])
    if n_inst * sum(g.counts) > FLATTEN_MAX:
        return False
    sph_real = bool(np.any(
        (np.abs(_np(g.sph_center)).max(axis=1) < 1e30)
        & (_np(g.sph_radius) > 0.0)))
    disk_real = bool(np.any(np.abs(_np(g.disk_center)).max(axis=1) < 1e30))
    if sph_real or disk_real:
        for m in _np(grp.fwd):
            m3 = np.asarray(m[:, :3], np.float64)
            mtm = m3.T @ m3
            s2 = np.trace(mtm) / 3.0
            if not np.allclose(mtm, s2 * np.eye(3), atol=1e-4 * max(s2, 1.0)):
                return False
    return True


def flatten_groups(geom: GeometryTables, groups) -> GeometryTables:
    """`geom` with world-space copies of `groups` appended (host build, on
    the CPU). Dummy never-hit master rows are copied harmlessly."""
    from ..shapes.tables import GeometryBuilder

    b = GeometryBuilder()

    def copy_tables(g, tf=None):
        mat3 = None if tf is None else np.asarray(tf[:, :3], np.float64)
        off = None if tf is None else np.asarray(tf[:, 3], np.float64)
        it = None if tf is None else np.linalg.inv(mat3).T

        def pt(p):
            p = np.asarray(p, np.float64)
            return p if tf is None else p @ mat3.T + off

        def vec(v):
            v = np.asarray(v, np.float64)
            return v if tf is None else v @ mat3.T

        def nrm(nv):
            nv = np.asarray(nv, np.float64)
            if tf is not None:
                nv = nv @ it.T
                nv = nv / np.maximum(np.linalg.norm(nv, axis=-1,
                                                    keepdims=True), 1e-20)
            return nv

        scale = 1.0 if tf is None else float(np.cbrt(abs(np.linalg.det(mat3))))
        for c, r, m in zip(_np(g.sph_center), _np(g.sph_radius),
                           _np(g.sph_mat)):
            b.add_sphere(pt(c), float(r) * scale, int(m))
        for o, u, v, m in zip(_np(g.quad_origin), _np(g.quad_u),
                              _np(g.quad_v), _np(g.quad_mat)):
            b.add_quad(pt(o), vec(u), vec(v), int(m))
        tp = [pt(_np(getattr(g, f))) for f in ("tri_p0", "tri_p1", "tri_p2")]
        tn = [nrm(_np(getattr(g, f))) for f in ("tri_n0", "tri_n1", "tri_n2")]
        tuv = [_np(getattr(g, f)) for f in ("tri_uv0", "tri_uv1", "tri_uv2")]
        for i, m in enumerate(_np(g.tri_mat)):
            b.add_triangle(tp[0][i], tp[1][i], tp[2][i], int(m),
                           normals=(tn[0][i], tn[1][i], tn[2][i]),
                           uvs=(tuv[0][i], tuv[1][i], tuv[2][i]))
        for c, nv, r, m in zip(_np(g.disk_center), _np(g.disk_normal),
                               _np(g.disk_radial), _np(g.disk_mat)):
            b.add_disk(pt(c), nrm(nv[None])[0], vec(r), int(m))

    copy_tables(geom)
    for grp in groups:
        for m in _np(grp.fwd):
            copy_tables(grp.geom, m)
    return b.build()


def intersect_t(geom: GeometryTables, rays):
    """t-only closest-hit sweep (the first half of isect_mod.intersect)."""
    t_all = torch.cat([isect_mod.sphere_t(rays, geom),
                       isect_mod.quad_t(rays, geom),
                       isect_mod.tri_t(rays, geom),
                       isect_mod.disk_t(rays, geom)], dim=1)
    t, win = torch.min(t_all, dim=1)
    return t, win.to(torch.int32)
