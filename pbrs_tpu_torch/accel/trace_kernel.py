"""Flat-table closest-hit / occlusion trace (kernel K1) and the tracer
that joins it with the per-family BVH tracer (K5). Mirrors
pbrs_tpu/accel/trace_pallas.py: ``prim_scalars``, ``_partition_big`` and
``PallasTracer`` (here ``Tracer``), the ``trace/occluded`` contract of
``_trace_kernel``.

The CUDA kernel (``csrc/trace_flat.cu``) runs one thread per ray over SoA
planes with the [P,16] primitive bank staged in shared memory. Its plain
version, ``trace_reference``, is the same sweep as a broadcast [N, P]
tensor program with the kernel's arithmetic, op for op.

``Tracer`` hands every family above TREELET_THRESHOLD primitives (or
``bvh_threshold``) to a BVH family tracer (accel/treelet.py, kernel K5),
keeps the rest in the flat bank, and splits a mixed-scale family by area:
its few big primitives stay in the bank, the dense rest goes to K5. Ids
stay global on both sides (bank column 15, the family tracer's id map).
Its ``trace`` and ``occluded`` launch the kernels for CUDA tensors and
take their plain versions for CPU tensors; they never fall back from one
to the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from ..geometry import ray as ray_mod
from ..shapes.tables import GeometryTables
from . import treelet

TREELET_THRESHOLD = 1024
T_MIN = ray_mod.T_MIN
BIG = 3.0e38
INF = float("inf")
BANK_COLS = 16

# Kernel launches since the last reset (a plain count, read by callers
# that need to show which path ran).
LAUNCHES = 0


def _host(geom: GeometryTables):
    return {f.name: getattr(geom, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(geom)}


def prim_scalars(geom: GeometryTables, include=(True, True, True, True),
                 subsets=None):
    """The primitive bank [P, 16] float32 (on geom's device) and its row
    count per family (spheres, quads, tris, disks).

    Rows: sphere (center, r); quad (origin, u, v, n = u x v, |n|^2); tri
    (p0, p1, p2, unit normal, zero for degenerate); disk (center, normal,
    |radial|^2). Column 15 holds the global prim id, so the bank may hold
    any subset of a family: `include` leaves whole families out (those a
    BVH family tracer takes) and `subsets` gives per-family index arrays
    (the flat side of a big/small partition). An empty bank is one row with
    id -1 and counts of 0."""
    g = _host(geom)
    fam = geom.counts
    if sum(fam) >= 1 << 24:
        raise ValueError("the float32 id column holds ids below 2^24, got "
                         f"{sum(fam)} prims")
    base = np.cumsum((0,) + tuple(fam[:3]))
    subsets = subsets or (None,) * 4
    sel = [(np.arange(fam[i]) if subsets[i] is None
            else np.asarray(subsets[i], np.int64)) if include[i]
           else np.zeros(0, np.int64) for i in range(4)]
    rows = []
    for c, r, gid in zip(g["sph_center"][sel[0]], g["sph_radius"][sel[0]],
                         base[0] + sel[0]):
        rows.append([*c, r] + [0.0] * 11 + [float(gid)])
    for o, u, v, gid in zip(g["quad_origin"][sel[1]], g["quad_u"][sel[1]],
                            g["quad_v"][sel[1]], base[1] + sel[1]):
        n = np.cross(u, v)
        n2 = max(float((n * n).sum()), 1e-30)
        rows.append([*o, *u, *v, *n, n2] + [0.0] * 2 + [float(gid)])
    for p0, p1, p2, gid in zip(g["tri_p0"][sel[2]], g["tri_p1"][sel[2]],
                               g["tri_p2"][sel[2]], base[2] + sel[2]):
        n = np.cross(p0 - p1, p2 - p1)
        ln = np.linalg.norm(n)
        n = n / ln if ln > 0 else np.zeros(3)
        rows.append([*p0, *p1, *p2, *n] + [0.0] * 3 + [float(gid)])
    for c, n, r, gid in zip(g["disk_center"][sel[3]], g["disk_normal"][sel[3]],
                            g["disk_radial"][sel[3]], base[3] + sel[3]):
        rows.append([*c, *n, float((r * r).sum())] + [0.0] * 8 + [float(gid)])
    if not rows:
        rows.append([0.0] * 15 + [-1.0])
    bank = np.asarray(rows, np.float32)
    return (torch.from_numpy(bank).to(geom.quad_origin.device),
            tuple(len(s) for s in sel))


# ------------------------------ plain version -----------------------------


def sweep_reference(bank, counts, rox, roy, roz, rdx, rdy, rdz, t_max):
    """Closest hit of [N] rays over the bank: (t [N], bank row [N]), with
    BIG / -1 on a miss. Ties go to the lowest row, as in the kernel's
    sequential `t < t_best` sweep."""
    n_sph, n_quad, n_tri, n_disk = counts
    ray = [x[:, None] for x in (rox, roy, roz, rdx, rdy, rdz)]
    rox, roy, roz, rdx, rdy, rdz = ray
    tm = t_max[:, None]
    ts = []

    def consider(t, ok):
        return torch.where(ok & (t >= T_MIN) & (t < tm), t, BIG)

    def family(start, count):
        rows = bank[start:start + count]
        return lambda j: rows[:, j][None, :]

    if n_sph:
        p = family(0, n_sph)
        cx, cy, cz, r = p(0), p(1), p(2), p(3)
        fx, fy, fz = rox - cx, roy - cy, roz - cz
        a = rdx * rdx + rdy * rdy + rdz * rdz
        b_pr = -(fx * rdx + fy * rdy + fz * rdz)
        inv_a = 1.0 / torch.clamp_min(a, 1e-30)
        mx = fx + b_pr * inv_a * rdx
        my = fy + b_pr * inv_a * rdy
        mz = fz + b_pr * inv_a * rdz
        delta = r * r - (mx * mx + my * my + mz * mz)
        has = delta >= 0.0
        c = fx * fx + fy * fy + fz * fz - r * r
        q = b_pr + torch.where(b_pr >= 0.0, 1.0, -1.0) * torch.sqrt(
            torch.clamp_min(delta * a, 0.0))
        q_s = torch.where(q == 0.0, 1.0, q)
        t0 = c / q_s
        t1 = q * inv_a
        t_lo = torch.minimum(t0, t1)
        t_hi = torch.maximum(t0, t1)
        ok = has & (q != 0.0)
        lo_ok = ok & (t_lo >= T_MIN) & (t_lo < tm)
        ts.append(consider(torch.where(lo_ok, t_lo, t_hi), ok))
    if n_quad:
        p = family(n_sph, n_quad)
        ox_, oy_, oz_ = p(0), p(1), p(2)
        ux, uy, uz = p(3), p(4), p(5)
        vx, vy, vz = p(6), p(7), p(8)
        nx, ny, nz = p(9), p(10), p(11)
        inv_n2 = 1.0 / p(12)
        denom = rdx * nx + rdy * ny + rdz * nz
        denom_s = torch.where(denom == 0.0, 1.0, denom)
        t = ((ox_ - rox) * nx + (oy_ - roy) * ny + (oz_ - roz) * nz) / denom_s
        px = rox + t * rdx - ox_
        py = roy + t * rdy - oy_
        pz = roz + t * rdz - oz_
        cx = py * vz - pz * vy
        cy = pz * vx - px * vz
        cz = px * vy - py * vx
        uu = (cx * nx + cy * ny + cz * nz) * inv_n2
        cx = uy * pz - uz * py
        cy = uz * px - ux * pz
        cz = ux * py - uy * px
        vv = (cx * nx + cy * ny + cz * nz) * inv_n2
        ok = ((denom != 0.0) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
              & (vv <= 1.0))
        ts.append(consider(t, ok))
    if n_tri:
        p = family(n_sph + n_quad, n_tri)
        p0x, p0y, p0z = p(0), p(1), p(2)
        p1x, p1y, p1z = p(3), p(4), p(5)
        p2x, p2y, p2z = p(6), p(7), p(8)
        nx, ny, nz = p(9), p(10), p(11)
        denom = rdx * nx + rdy * ny + rdz * nz
        denom_s = torch.where(denom == 0.0, 1.0, denom)
        t = ((p0x - rox) * nx + (p0y - roy) * ny + (p0z - roz) * nz) / denom_s
        hx = rox + t * rdx
        hy = roy + t * rdy
        hz = roz + t * rdz

        def edge(ax, ay, az, bx, by, bz):
            ex, ey, ez = hx - ax, hy - ay, hz - az
            fx, fy, fz = hx - bx, hy - by, hz - bz
            return ((ey * fz - ez * fy) * nx + (ez * fx - ex * fz) * ny
                    + (ex * fy - ey * fx) * nz)

        b2 = edge(p0x, p0y, p0z, p1x, p1y, p1z)
        b0 = edge(p1x, p1y, p1z, p2x, p2y, p2z)
        b1 = edge(p2x, p2y, p2z, p0x, p0y, p0z)
        inside = (((b0 > 0) & (b1 > 0) & (b2 > 0))
                  | ((b0 < 0) & (b1 < 0) & (b2 < 0)))
        ts.append(consider(t, (denom != 0.0) & inside))
    if n_disk:
        p = family(n_sph + n_quad + n_tri, n_disk)
        cx_, cy_, cz_ = p(0), p(1), p(2)
        nx, ny, nz = p(3), p(4), p(5)
        r2 = p(6)
        denom = rdx * nx + rdy * ny + rdz * nz
        denom_s = torch.where(denom == 0.0, 1.0, denom)
        t = ((cx_ - rox) * nx + (cy_ - roy) * ny + (cz_ - roz) * nz) / denom_s
        px = rox + t * rdx - cx_
        py = roy + t * rdy - cy_
        pz = roz + t * rdz - cz_
        inside = px * px + py * py + pz * pz <= r2
        ts.append(consider(t, (denom != 0.0) & inside))
    n = rox.shape[0]
    if not ts:
        return (torch.full((n,), BIG, device=rox.device),
                torch.full((n,), -1, dtype=torch.int64, device=rox.device))
    t_best, row = torch.min(torch.cat(ts, dim=1), dim=1)
    return t_best, torch.where(t_best < BIG, row, -1)


def trace_reference(bank, counts, rays: ray_mod.RayBatch):
    """Plain version of K1: (t [N], global prim id [N] int32), inf / -1 on
    a miss."""
    o, d = rays.origin, rays.dir
    t_best, row = sweep_reference(bank, counts, o[:, 0], o[:, 1], o[:, 2],
                                  d[:, 0], d[:, 1], d[:, 2], rays.t_max)
    hit = row >= 0
    gid = bank[torch.clamp_min(row, 0), 15].to(torch.int32)
    return (torch.where(hit, t_best, INF),
            torch.where(hit, gid, -1).to(torch.int32))


# ------------------------------ CUDA kernel -------------------------------


def _check_bank(bank, counts):
    if not (bank.is_cuda and bank.dtype == torch.float32 and bank.dim() == 2
            and bank.shape[1] == BANK_COLS and bank.is_contiguous()):
        raise ValueError("bank must be a contiguous CUDA float32 [P, 16] "
                         f"tensor, got {bank.dtype} {tuple(bank.shape)} on "
                         f"{bank.device}")
    if len(counts) != 4 or sum(counts) != bank.shape[0]:
        raise ValueError(f"counts {counts} do not cover {bank.shape[0]} rows")
    max_rows = kernels.lib().pbrs_max_bank_rows()
    if bank.shape[0] > max_rows:
        raise ValueError(f"bank of {bank.shape[0]} rows exceeds the "
                         f"{max_rows} rows shared memory holds")


def trace_planes(bank, counts, planes, any_hit: bool = False):
    """Launch K1 on SoA ray planes [7, N] (ox, oy, oz, dx, dy, dz, t_max).
    Returns (t [N] float32, id [N] int32). any_hit stops a ray at its first
    hit: t is then finite exactly where the full sweep's t is."""
    global LAUNCHES
    _check_bank(bank, counts)
    if not (planes.device == bank.device and planes.dtype == torch.float32
            and planes.dim() == 2 and planes.shape[0] == 7
            and planes.is_contiguous()):
        raise ValueError("planes must be contiguous float32 [7, N] on the "
                         "bank's device")
    n = planes.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=planes.device)
    ids = torch.empty(n, dtype=torch.int32, device=planes.device)
    if n == 0:
        return t, ids
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = kernels.lib().pbrs_trace_flat(
        bank.data_ptr(), *counts, planes.data_ptr(), n, t.data_ptr(),
        ids.data_ptr(), int(any_hit), stream)
    kernels.check(rc, "trace_flat")
    LAUNCHES += 1
    return t, ids


def _device_kind(rays):
    kind = rays.origin.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no trace backend for device {rays.origin.device}")
    return kind


# ------------------------- flat bank + BVH families ------------------------

# Big/small partition bounds (trace_pallas.py:314-315): at most this many
# "big" prims stay in the flat bank, and a prim counts as big when its area
# exceeds this multiple of the family's median.
PARTITION_MAX_FLAT = 256
PARTITION_AREA_FACTOR = 32.0


def _partition_big(area, thresh):
    """Split a family by area into (big_ids, small_ids), or (None, None)
    when a partition would not pay: the big side must be small enough for
    the flat sweep and the small side big enough to want a BVH. When more
    prims clear the area factor than the flat bank takes, the largest
    PARTITION_MAX_FLAT stay flat."""
    n = area.shape[0]
    pos = area[area > 0]
    if pos.size == 0:
        return None, None
    med = float(np.median(pos))
    if med <= 0:
        return None, None
    big = area > PARTITION_AREA_FACTOR * med
    n_big = int(big.sum())
    if n_big > PARTITION_MAX_FLAT:
        order = np.argsort(area)[::-1][:PARTITION_MAX_FLAT]
        big = np.zeros(n, bool)
        big[order] = True
        n_big = PARTITION_MAX_FLAT
    if n_big == 0 or (n - n_big) <= thresh:
        return None, None
    return np.nonzero(big)[0], np.nonzero(~big)[0]


class Tracer:
    """Closest-hit / any-hit queries against a GeometryTables snapshot
    (trace_pallas.py:PallasTracer): families above the threshold go to BVH
    family tracers (K5), the rest to the flat bank (K1), and the two
    results merge by the closer t."""

    def __init__(self, geom: GeometryTables,
                 bvh_threshold: int | None = None):
        thresh = TREELET_THRESHOLD if bvh_threshold is None else bvh_threshold
        dev = geom.quad_origin.device
        g = _host(geom)
        n_sph, n_quad, n_tri, n_disk = geom.counts
        base_quad, base_tri = n_sph, n_sph + n_quad
        base_disk = base_tri + n_tri
        self.families = []
        include = [True, True, True, True]
        subsets = [None, None, None, None]
        if n_sph > thresh:
            self.families.append(treelet.sphere_tracer(
                g["sph_center"], g["sph_radius"], 0, device=dev))
            include[0] = False
        if n_quad > thresh:
            o, u, v = g["quad_origin"], g["quad_u"], g["quad_v"]
            big, small = _partition_big(
                np.linalg.norm(np.cross(u, v), axis=1), thresh)
            if big is None:
                self.families.append(treelet.quad_tracer(o, u, v, base_quad,
                                                         device=dev))
                include[1] = False
            else:
                self.families.append(treelet.quad_tracer(
                    o[small], u[small], v[small], base_quad + small,
                    device=dev))
                subsets[1] = big
        if n_tri > thresh:
            p0, p1, p2 = g["tri_p0"], g["tri_p1"], g["tri_p2"]
            big, small = _partition_big(
                0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1),
                thresh)
            if big is None:
                self.families.append(treelet.tri_tracer(p0, p1, p2, base_tri,
                                                        device=dev))
                include[2] = False
            else:
                self.families.append(treelet.tri_tracer(
                    p0[small], p1[small], p2[small], base_tri + small,
                    device=dev))
                subsets[2] = big
        if n_disk > thresh:
            self.families.append(treelet.disk_tracer(
                g["disk_center"], g["disk_normal"], g["disk_radial"],
                base_disk, device=dev))
            include[3] = False
        self.bank, self.counts = prim_scalars(geom, include=tuple(include),
                                              subsets=tuple(subsets))
        self.flat_rows = sum(self.counts)

    def trace(self, rays: ray_mod.RayBatch, any_hit: bool = False):
        """(t [N], global prim id [N] int32), inf / -1 on a miss: K1 and K5
        on CUDA tensors, their plain versions on CPU tensors."""
        cpu = _device_kind(rays) == "cpu"
        planes = None if cpu else ray_mod.to_planes(rays)
        n = rays.origin.shape[0]
        if not self.flat_rows:
            t = torch.full((n,), INF, device=rays.origin.device)
            idx = torch.full((n,), -1, dtype=torch.int32,
                             device=rays.origin.device)
        elif cpu:
            t, idx = trace_reference(self.bank, self.counts, rays)
        else:
            t, idx = trace_planes(self.bank, self.counts, planes, any_hit)
        for fam in self.families:
            t2, idx2 = (treelet.trace_reference(fam, rays) if cpu else
                        treelet.trace_planes(fam, planes, any_hit))
            closer = t2 < t
            t = torch.where(closer, t2, t)
            idx = torch.where(closer, idx2, idx)
        return t, idx

    def occluded(self, rays: ray_mod.RayBatch):
        return torch.isfinite(self.trace(rays, any_hit=True)[0])
