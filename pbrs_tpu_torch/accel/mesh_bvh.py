"""Single-kind primitive-BVH closest-hit / any-hit trace (kernel K6).
Mirrors pbrs_tpu/accel/mesh_pallas.py: the slot-column builders, the
packing, PrimBVHTracer and MeshBVHTracer with their constructor arguments
(the TPU's `interpret` and `block_rows` dropped; `device` added) and ``trace(rays, any_hit=, sort_rays=)``.

The tree is accel/bvh.py's, with leaves of at most TRIS_PER_LEAF = 9
primitives, so its DFS order, its skip links and its tie order are the
reference's under the native and the NumPy builder alike. The TPU's
nine-per-row leaf matrix and 1-D SMEM node arrays are not carried over:

  nodes    [NN, 8] float32: the box (lo xyz, hi xyz), then two int32 as
           float bits: a leaf's first slot << LEAF_SHIFT | its count (0 on
           an interior node) and the node's skip link;
  fields   [P, FIELD_STRIDE] float32: each primitive's slot columns in
           leaf order, padded to whole float4s;
  slot_gid [P] int32: leaf-order slot -> global prim id (the slot
           columns' gid column).

csrc/trace_prim_bvh.cu walks one ray per thread, stackless, over the DFS
order and skip links, descending on its own slab test; ``walk_reference``,
the plain version, is the same per-lane walk with every lane stepping
together while any is live, up to the same cap of num_nodes + 1 steps.
CUDA tensors launch K6, CPU tensors take walk_reference; neither falls
back to the other. The TPU kernel descends a node when any lane of its
32 x 128-lane tile wants it, so a lane here visits a subset of the leaves
it visited there: the two part only where a lane's own slab test culls
the leaf that holds its hit by rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..geometry import ray as ray_mod
from . import bvh as bvh_mod

T_MIN = ray_mod.T_MIN
BIG = 3.0e38
INF = float("inf")
TRIS_PER_LEAF = 9
LEAF_SHIFT = 4
# Primitive families (slot layout: 12 floats + gid):
#   TRI:    p0(3) p1(3) p2(3) plane-normal(3)
#   QUAD:   origin(3) edge_u(3) edge_v(3) normal(3)
#   SPHERE: center(3) radius _ _ ...
#   DISK:   center(3) normal(3) r2 _ ...
KIND_TRI, KIND_QUAD, KIND_SPHERE, KIND_DISK = 0, 1, 2, 3
N_FIELDS = {KIND_TRI: 12, KIND_QUAD: 12, KIND_SPHERE: 4, KIND_DISK: 7}
FIELD_STRIDE = {KIND_TRI: 12, KIND_QUAD: 12, KIND_SPHERE: 4, KIND_DISK: 8}

# Kernel launches since the last reset (a plain count, read by callers
# that need to show which path ran).
LAUNCHES = 0


def tri_slot_cols(p0, p1, p2, gid):
    n = np.cross(p0 - p1, p2 - p1)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(ln > 0, n / np.maximum(ln, 1e-30), 0.0)
    return np.concatenate(
        [p0, p1, p2, n, gid[:, None]], axis=1
    ).astype(np.float32)


def quad_slot_cols(origin, eu, ev, gid):
    n = np.cross(eu, ev)
    return np.concatenate(
        [origin, eu, ev, n, gid[:, None]], axis=1
    ).astype(np.float32)


def sphere_slot_cols(center, radius, gid):
    z = np.zeros((center.shape[0], 1), np.float32)
    return np.concatenate(
        [center, radius[:, None], z, z, z, z, z, z, z, z, gid[:, None]],
        axis=1,
    ).astype(np.float32)


def disk_slot_cols(center, normal, radial, gid):
    r2 = (radial * radial).sum(1, keepdims=True)
    z = np.zeros((center.shape[0], 1), np.float32)
    return np.concatenate(
        [center, normal, r2, z, z, z, z, z, gid[:, None]], axis=1
    ).astype(np.float32)


def pack_mesh(tree: bvh_mod.FlatBVH, slot_cols, kind):
    """(nodes [NN, 8], fields [P, stride], slot_gid [P]) as NumPy arrays.
    slot_cols: [P, 13] in the primitives' original order, the gid column
    last. Every leaf must hold at most TRIS_PER_LEAF primitives."""
    cols = np.asarray(slot_cols, np.float32)[tree.prim_order]
    leaf = tree.is_leaf > 0
    if (tree.count[leaf] > TRIS_PER_LEAF).any():
        raise ValueError(f"rebuild the BVH with max_leaf <= {TRIS_PER_LEAF}")
    nn = tree.bbox_min.shape[0]
    nodes = np.zeros((nn, 8), np.float32)
    nodes[:, 0:3] = tree.bbox_min
    nodes[:, 3:6] = tree.bbox_max
    meta = nodes[:, 6:8].view(np.int32)
    meta[:, 0] = np.where(leaf, (tree.first << LEAF_SHIFT) | tree.count, 0)
    meta[:, 1] = tree.skip
    nf = N_FIELDS[kind]
    fields = np.zeros((cols.shape[0], FIELD_STRIDE[kind]), np.float32)
    fields[:, :nf] = cols[:, :nf]
    return nodes, fields, cols[:, 12].astype(np.int32)


class PrimBVHTracer:
    """Closest-hit / any-hit over a single-type primitive BVH."""

    def __init__(self, kind, slot_cols, bbox_lo, bbox_hi,
                 max_leaf=TRIS_PER_LEAF, device=None):
        if max_leaf > TRIS_PER_LEAF:
            raise ValueError(f"max_leaf must be at most {TRIS_PER_LEAF}")
        self.kind = kind
        self.bvh = bvh_mod.build_bvh(np.asarray(bbox_lo, np.float32),
                                     np.asarray(bbox_hi, np.float32),
                                     max_leaf=max_leaf)
        nodes, fields, slot_gid = pack_mesh(self.bvh, slot_cols, kind)
        self.num_nodes = nodes.shape[0]
        self.n_prims = fields.shape[0]
        self.nodes = torch.from_numpy(nodes).to(device)
        self.fields = torch.from_numpy(fields).to(device)
        self.slot_gid = torch.from_numpy(slot_gid).to(device)

    def trace(self, rays, any_hit=False, sort_rays=True):
        """(t [N], global prim id [N] int32), inf / -1 on a miss. CUDA rays
        launch K6, CPU rays take walk_reference. sort_rays orders the lanes
        by (direction octant, origin cell) before the walk, as the TPU
        tracer does for its packets; a per-lane walk gives the same answer
        either way, and the sort keeps a warp's walks alike."""
        order = None
        if sort_rays:
            order = _octant_cell_order(rays)
            rays = ray_mod.RayBatch(origin=rays.origin[order],
                                    dir=rays.dir[order],
                                    t_max=rays.t_max[order])
        planes = ray_mod.to_planes(rays)
        kind = planes.device.type
        if kind == "cpu":
            t, idx = walk_reference(self, planes, any_hit)
        elif kind == "cuda":
            t, idx = trace_planes(self, planes, any_hit)
        else:
            raise ValueError(f"no trace backend for device {planes.device}")
        if order is not None:
            inv = torch.empty_like(order)
            inv[order] = torch.arange(order.shape[0], device=order.device)
            t, idx = t[inv], idx[inv]
        return t, idx


class MeshBVHTracer(PrimBVHTracer):
    """Triangle-BVH tracer (mesh_pallas.MeshBVHTracer)."""

    def __init__(self, p0, p1, p2, global_base: int, max_leaf=TRIS_PER_LEAF,
                 device=None):
        p0 = np.asarray(p0, np.float32)
        p1 = np.asarray(p1, np.float32)
        p2 = np.asarray(p2, np.float32)
        gid = (global_base + np.arange(p0.shape[0])).astype(np.float32)
        lo, hi = bvh_mod.triangle_bboxes(p0, p1, p2)
        super().__init__(KIND_TRI, tri_slot_cols(p0, p1, p2, gid), lo, hi,
                         max_leaf=max_leaf, device=device)


def _octant_cell_order(rays):
    """Lane order by (direction octant, 8^3 origin cell):
    mesh_pallas.PrimBVHTracer.trace's sort key, stably sorted."""
    o, d = rays.origin, rays.dir
    octant = ((d[:, 0] > 0).to(torch.int64)
              | ((d[:, 1] > 0).to(torch.int64) << 1)
              | ((d[:, 2] > 0).to(torch.int64) << 2))
    lo = o.min(dim=0).values
    span = torch.clamp_min(o.max(dim=0).values - lo, 1e-6)
    cell = torch.clamp(((o - lo) / span * 7).to(torch.int64), 0, 7)
    key = (octant << 9) | (cell[:, 0] << 6) | (cell[:, 1] << 3) | cell[:, 2]
    return torch.argsort(key, stable=True)


# ------------------------------ plain version ------------------------------


def prim_t(kind, f, rox, roy, roz, rdx, rdy, rdz, t_max):
    """t of rays against primitives (broadcasting; f(k) gives slot column
    k), BIG where not a hit within [T_MIN, t_max): _bvh_kernel's tri_test
    op for op, as csrc/trace_prim_bvh.cu computes it."""
    if kind == KIND_SPHERE:
        cx, cy, cz, r = f(0), f(1), f(2), f(3)
        fx, fy, fz = rox - cx, roy - cy, roz - cz
        a = rdx * rdx + rdy * rdy + rdz * rdz
        b_pr = -(fx * rdx + fy * rdy + fz * rdz)
        inv_a = 1.0 / torch.clamp_min(a, 1e-30)
        mx = fx + b_pr * inv_a * rdx
        my = fy + b_pr * inv_a * rdy
        mz = fz + b_pr * inv_a * rdz
        delta = r * r - (mx * mx + my * my + mz * mz)
        cc = fx * fx + fy * fy + fz * fz - r * r
        q = b_pr + torch.where(b_pr >= 0.0, 1.0, -1.0) * torch.sqrt(
            torch.clamp_min(delta * a, 0.0))
        q_s = torch.where(q == 0.0, 1.0, q)
        t0 = cc / q_s
        t1 = q * inv_a
        t_lo = torch.minimum(t0, t1)
        t_hi = torch.maximum(t0, t1)
        ok0 = (delta >= 0.0) & (q != 0.0)
        lo_ok = ok0 & (t_lo >= T_MIN) & (t_lo < t_max)
        t = torch.where(lo_ok, t_lo, t_hi)
        ok = ok0 & (t >= T_MIN) & (t < t_max)
    elif kind == KIND_QUAD:
        ox_, oy_, oz_ = f(0), f(1), f(2)
        ux, uy, uz = f(3), f(4), f(5)
        vx, vy, vz = f(6), f(7), f(8)
        nx, ny, nz = f(9), f(10), f(11)
        n2 = torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-30)
        denom = rdx * nx + rdy * ny + rdz * nz
        denom_s = torch.where(denom == 0.0, 1.0, denom)
        t = ((ox_ - rox) * nx + (oy_ - roy) * ny + (oz_ - roz) * nz) / denom_s
        hx = rox + t * rdx - ox_
        hy = roy + t * rdy - oy_
        hz = roz + t * rdz - oz_
        cx = hy * vz - hz * vy
        cy = hz * vx - hx * vz
        cz = hx * vy - hy * vx
        uu = (cx * nx + cy * ny + cz * nz) / n2
        cx = uy * hz - uz * hy
        cy = uz * hx - ux * hz
        cz = ux * hy - uy * hx
        vv = (cx * nx + cy * ny + cz * nz) / n2
        ok = ((denom != 0.0) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
              & (vv <= 1.0) & (t >= T_MIN) & (t < t_max))
    elif kind == KIND_DISK:
        cx_, cy_, cz_ = f(0), f(1), f(2)
        nx, ny, nz = f(3), f(4), f(5)
        r2 = f(6)
        denom = rdx * nx + rdy * ny + rdz * nz
        denom_s = torch.where(denom == 0.0, 1.0, denom)
        t = ((cx_ - rox) * nx + (cy_ - roy) * ny + (cz_ - roz) * nz) / denom_s
        hx = rox + t * rdx - cx_
        hy = roy + t * rdy - cy_
        hz = roz + t * rdz - cz_
        ok = ((denom != 0.0) & (hx * hx + hy * hy + hz * hz <= r2)
              & (t >= T_MIN) & (t < t_max))
    else:  # KIND_TRI: plane hit, then the three edge functions
        p0x, p0y, p0z = f(0), f(1), f(2)
        p1x, p1y, p1z = f(3), f(4), f(5)
        p2x, p2y, p2z = f(6), f(7), f(8)
        nx, ny, nz = f(9), f(10), f(11)
        denom = rdx * nx + rdy * ny + rdz * nz
        denom_s = torch.where(denom == 0.0, 1.0, denom)
        t = ((p0x - rox) * nx + (p0y - roy) * ny + (p0z - roz) * nz) / denom_s
        hx = rox + t * rdx
        hy = roy + t * rdy
        hz = roz + t * rdz

        def edge(ax, ay, az, bx, by, bz):
            ex, ey, ez = hx - ax, hy - ay, hz - az
            fx, fy, fz = hx - bx, hy - by, hz - bz
            cx = ey * fz - ez * fy
            cy = ez * fx - ex * fz
            cz = ex * fy - ey * fx
            return cx * nx + cy * ny + cz * nz

        b2 = edge(p0x, p0y, p0z, p1x, p1y, p1z)
        b0 = edge(p1x, p1y, p1z, p2x, p2y, p2z)
        b1 = edge(p2x, p2y, p2z, p0x, p0y, p0z)
        inside = (((b0 > 0) & (b1 > 0) & (b2 > 0))
                  | ((b0 < 0) & (b1 < 0) & (b2 < 0)))
        ok = (denom != 0.0) & inside & (t >= T_MIN) & (t < t_max)
    return torch.where(ok, t, BIG)


def walk_reference(tracer: PrimBVHTracer, planes, any_hit: bool = False,
                   work=None):
    """Plain version of K6 on SoA ray planes [7, N]: the kernel's per-lane
    stackless walk, every live lane stepping together, up to num_nodes + 1
    steps. A leaf's primitives are tested at once: the first of them with
    the least t replaces the best hit when strictly closer, which is the
    kernel's in-order `t < t_best` update. (t [N], global id [N] int32).
    `work` (a dict), when given, gains the node and primitive tests the
    walk made ("node_tests", "prim_tests"), the work K6 does for these
    rays (an any-hit walk that stops inside a leaf is counted whole)."""
    dev = planes.device
    n = planes.shape[1]
    nodes = tracer.nodes.to(dev)
    boxes = nodes[:, :6]
    meta = nodes[:, 6:8].contiguous().view(torch.int32).to(torch.int64)
    fields = tracer.fields.to(dev)
    slot_gid = tracer.slot_gid.to(dev)
    num_nodes = tracer.num_nodes
    o = planes[0:3]
    d = planes[3:6]
    t_max = planes[6]
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    t_best = torch.full((n,), BIG, device=dev)
    g_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    lanes = torch.nonzero(t_max > 0.0).squeeze(1)
    ks = torch.arange(TRIS_PER_LEAF, device=dev)
    for _ in range(num_nodes + 1):
        lanes = lanes[node[lanes] < num_nodes]
        if any_hit:
            lanes = lanes[g_best[lanes] < 0]
        if lanes.numel() == 0:
            break
        nd = node[lanes]
        box = boxes[nd]
        ro, ri = o[:, lanes], inv[:, lanes]
        tx0 = (box[:, 0] - ro[0]) * ri[0]
        tx1 = (box[:, 3] - ro[0]) * ri[0]
        ty0 = (box[:, 1] - ro[1]) * ri[1]
        ty1 = (box[:, 4] - ro[1]) * ri[1]
        tz0 = (box[:, 2] - ro[2]) * ri[2]
        tz1 = (box[:, 5] - ro[2]) * ri[2]
        t_enter = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                              torch.minimum(ty0, ty1)),
                                torch.minimum(tz0, tz1))
        t_exit = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                             torch.maximum(ty0, ty1)),
                               torch.maximum(tz0, tz1))
        tm = t_max[lanes]
        limit = torch.minimum(t_best[lanes], tm)
        if work is not None:
            work["node_tests"] = work.get("node_tests", 0) + lanes.numel()
        wanted = (t_enter <= t_exit) & (t_exit >= T_MIN) & (t_enter < limit)
        count = meta[nd, 0] & ((1 << LEAF_SHIFT) - 1)
        leaf = wanted & (count > 0)
        if bool(leaf.any()):
            ln = lanes[leaf]
            m = meta[nd[leaf], 0]
            first, cnt = m >> LEAF_SHIFT, m & ((1 << LEAF_SHIFT) - 1)
            valid = ks[None, :] < cnt[:, None]
            if work is not None:
                work["prim_tests"] = (work.get("prim_tests", 0)
                                      + int(cnt.sum()))
            slot = torch.where(valid, first[:, None] + ks[None, :],
                               first[:, None])
            row = fields[slot]
            r = [x[:, None] for x in (o[0, ln], o[1, ln], o[2, ln], d[0, ln],
                                      d[1, ln], d[2, ln], t_max[ln])]
            t = prim_t(tracer.kind, lambda k: row[..., k], *r)
            t = torch.where(valid, t, BIG)
            tb = t_best[ln]
            if any_hit:
                cand = t < tb[:, None]
            else:
                cand = t == t.min(dim=1, keepdim=True).values
                cand &= t < tb[:, None]
            k_first = torch.where(cand, ks[None, :], TRIS_PER_LEAF)
            k_first = k_first.min(dim=1).values
            take = k_first < TRIS_PER_LEAF
            kk = torch.clamp_max(k_first, TRIS_PER_LEAF - 1)
            t_new = t.gather(1, kk[:, None]).squeeze(1)
            g_new = slot_gid[slot.gather(1, kk[:, None]).squeeze(1)]
            t_best[ln] = torch.where(take, t_new, tb)
            g_best[ln] = torch.where(take, g_new.to(torch.int64), g_best[ln])
        skip = meta[nd, 1]
        node[lanes] = torch.where(wanted & (count == 0), nd + 1, skip)
    hit = t_best < BIG
    return (torch.where(hit, t_best, INF),
            torch.where(hit, g_best, -1).to(torch.int32))


# ------------------------------- CUDA kernel -------------------------------


def trace_planes(tracer: PrimBVHTracer, planes, any_hit: bool = False):
    """Launch K6 on SoA ray planes [7, N] (ox, oy, oz, dx, dy, dz, t_max).
    Returns (t [N] float32, global id [N] int32)."""
    global LAUNCHES
    if not (planes.is_cuda and planes.dtype == torch.float32
            and planes.dim() == 2 and planes.shape[0] == 7
            and planes.is_contiguous()):
        raise ValueError("planes must be contiguous CUDA float32 [7, N], got "
                         f"{planes.dtype} {tuple(planes.shape)} on "
                         f"{planes.device}")
    shapes = {"nodes": (torch.float32, (tracer.num_nodes, 8)),
              "fields": (torch.float32,
                         (tracer.n_prims, FIELD_STRIDE[tracer.kind])),
              "slot_gid": (torch.int32, (tracer.n_prims,))}
    for name, (dtype, shape) in shapes.items():
        tab = getattr(tracer, name)
        if not (tab.device == planes.device and tab.dtype == dtype
                and tuple(tab.shape) == shape and tab.is_contiguous()):
            raise ValueError(f"the tracer's {name} must be contiguous {dtype} "
                             f"{shape} on {planes.device}, got {tab.dtype} "
                             f"{tuple(tab.shape)} on {tab.device}")
    n = planes.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=planes.device)
    ids = torch.empty(n, dtype=torch.int32, device=planes.device)
    if n == 0:
        return t, ids
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = kernels.lib().pbrs_trace_prim_bvh(
        tracer.nodes.data_ptr(), tracer.num_nodes, tracer.fields.data_ptr(),
        tracer.slot_gid.data_ptr(), tracer.kind, planes.data_ptr(), n,
        t.data_ptr(), ids.data_ptr(), int(any_hit), stream)
    kernels.check(rc, "trace_prim_bvh")
    LAUNCHES += 1
    return t, ids
