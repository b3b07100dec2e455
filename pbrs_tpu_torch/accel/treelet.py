"""Per-family BVH closest-hit / any-hit trace (kernel K5). Mirrors
pbrs_tpu/accel/treelet.py: the factories tri_tracer, sphere_tracer,
quad_tracer and disk_tracer with the same arguments (interpret dropped,
device added), each building one FamilyTracer whose
``trace(rays, any_hit)`` gives (t [N], global prim id [N] int32), inf / -1
on a miss.

On Hopper there are no 64-slot treelets, no bf16 3-split tables and no
``mode``: the TPU tracer's treelets, sort keys, one-hot MXU gathers, chunk
DMA and rowdense/rowdyn/rowdynh variants were ways to avoid per-ray
pointer chasing on a TPU. K5 (csrc/trace_bvh.cu) walks the binary SAH BVH
of accel/bvh.py per thread instead, one ray a thread, with a stack. The
family tracer holds that BVH as a node table, the family's field rows
(treelet.py's field builders) in leaf order and a slot -> global id map.

``trace_reference``, the plain version, is a brute-force sweep of every
primitive of the family in chunks of rays, with the kernel's per-primitive
arithmetic and tie rule; ``traverse_reference`` repeats the kernel's walk
on the host, to count the node and primitive tests a ray batch needs and
to check the walk's culling against the sweep. CUDA tensors launch K5, CPU
tensors take trace_reference; neither falls back to the other.

Tie rule (both versions): on equal t the lowest global id wins, so the
result does not depend on the order of traversal. The TPU tracer keeps the
first-visited treelet's hit instead, so ids can differ from pbrs_tpu's on
exact-t ties (coplanar faces of abutting cuboids).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..geometry import ray as ray_mod
from . import bvh as bvh_mod

KIND_TRI, KIND_QUAD, KIND_SPHERE, KIND_DISK = 0, 1, 2, 3
# Fields per primitive (treelet.py N_FIELDS), and the padded row stride of
# the leaf-order field table (whole float4 loads in the kernel).
N_FIELDS = {KIND_TRI: 9, KIND_QUAD: 9, KIND_SPHERE: 4, KIND_DISK: 7}
FIELD_STRIDE = {KIND_TRI: 12, KIND_QUAD: 12, KIND_SPHERE: 4, KIND_DISK: 8}
T_MIN = ray_mod.T_MIN
BIG = 3.0e38
INF = float("inf")
INT_MAX = 2**31 - 1
# Per-thread stack entries of the kernel (csrc/trace_bvh.cu MAX_STACK). A
# walk pushes at most one entry per tree level, and bvh.build_bvh stops
# splitting below depth 61, so every tree it makes fits.
MAX_STACK = 64
# Conservative node tests. Boxes grow on the host by BOX_PAD times the
# family's largest coordinate, and the slab interval [t_enter, t_exit]
# widens by SLAB_EPS of each end's magnitude, so rounding in the slab test
# or in a primitive test never culls a node holding a hit the sweep finds.
BOX_PAD = 1e-5
SLAB_EPS = 1e-4
# Rays per chunk of the plain sweep: [chunk, P] temporaries stay at or
# below this many elements.
SWEEP_ELEMS = 1 << 24

# Kernel launches since the last reset (a plain count, read by callers
# that need to show which path ran).
LAUNCHES = 0


def _tri_fields(p0, p1, p2):
    return np.concatenate([p0, p1, p2], 1).astype(np.float32)


def _quad_fields(o, eu, ev):
    return np.concatenate([o, eu, ev], 1).astype(np.float32)


def _sphere_fields(c, r):
    return np.concatenate([c, r[:, None]], 1).astype(np.float32)


def _disk_fields(c, n, radial):
    r2 = (radial * radial).sum(1, keepdims=True)
    return np.concatenate([c, n, r2], 1).astype(np.float32)


# --------------------------- per-primitive tests ---------------------------


def prim_test(kind, f, rox, roy, roz, rdx, rdy, rdz, t_max):
    """(t, ok) of rays against primitives, broadcasting; f(k) gives field k.
    The tests of treelet.py:_test_prims, op for op as csrc/trace_bvh.cu
    computes them."""
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
        ok0 = (delta >= 0.0) & (q != 0.0) & (r > 0.0)
        lo_ok = ok0 & (t_lo >= T_MIN) & (t_lo < t_max)
        t = torch.where(lo_ok, t_lo, t_hi)
        return t, ok0 & (t >= T_MIN) & (t < t_max)
    if kind == KIND_QUAD:
        ox_, oy_, oz_ = f(0), f(1), f(2)
        ux, uy, uz = f(3), f(4), f(5)
        vx, vy, vz = f(6), f(7), f(8)
        nx = uy * vz - uz * vy
        ny = uz * vx - ux * vz
        nz = ux * vy - uy * vx
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
        return t, ((denom != 0.0) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
                   & (vv <= 1.0) & (t >= T_MIN) & (t < t_max))
    if kind == KIND_DISK:
        cx_, cy_, cz_ = f(0), f(1), f(2)
        nx, ny, nz = f(3), f(4), f(5)
        r2 = f(6)
        denom = rdx * nx + rdy * ny + rdz * nz
        denom_s = torch.where(denom == 0.0, 1.0, denom)
        t = ((cx_ - rox) * nx + (cy_ - roy) * ny + (cz_ - roz) * nz) / denom_s
        hx = rox + t * rdx - cx_
        hy = roy + t * rdy - cy_
        hz = roz + t * rdz - cz_
        return t, ((denom != 0.0) & (hx * hx + hy * hy + hz * hz <= r2)
                   & (t >= T_MIN) & (t < t_max))
    # KIND_TRI: Moller-Trumbore with strict u > 0, v > 0, u + v < 1.
    p0x, p0y, p0z = f(0), f(1), f(2)
    e1x, e1y, e1z = f(3) - p0x, f(4) - p0y, f(5) - p0z
    e2x, e2y, e2z = f(6) - p0x, f(7) - p0y, f(8) - p0z
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    tvx, tvy, tvz = rox - p0x, roy - p0y, roz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return t, ((det != 0.0) & (u > 0.0) & (v > 0.0) & (u + v < 1.0)
               & (t >= T_MIN) & (t < t_max))


def _ray_parts(rays):
    o, d = rays.origin, rays.dir
    return (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], rays.t_max)


# ------------------------------- the tracer -------------------------------


class FamilyTracer:
    """Closest-hit / any-hit over one primitive family through its BVH.

    Tables (on `device`):
      nodes  [NN, 8] float32, DFS order: the box (lo xyz, hi xyz, padded
             outward by BOX_PAD), then two int32 stored as float bits: a leaf
             holds (first slot, prim count > 0), an interior node (right
             child, 0); its left child is the next node.
      fields [P, FIELD_STRIDE] float32: the field rows in leaf order.
      slot_gid [P] int32: leaf-order slot -> global prim id.
    """

    def __init__(self, kind, fields, bbox_lo, bbox_hi, global_base=0,
                 device=None):
        fields = np.asarray(fields, np.float32)
        p, nf = fields.shape
        if nf != N_FIELDS[kind]:
            raise ValueError(f"kind {kind} takes {N_FIELDS[kind]} fields, "
                             f"got {nf}")
        self.kind = kind
        self.n_prims = p
        lo = np.asarray(bbox_lo, np.float32)
        hi = np.asarray(bbox_hi, np.float32)
        tree = bvh_mod.build_bvh(lo, hi)
        self.depth, self.builder = tree.depth, tree.builder
        nn = tree.bbox_min.shape[0]
        self.n_nodes = nn
        pad = np.float32(BOX_PAD * max(float(np.abs(lo).max()),
                                       float(np.abs(hi).max()), 1.0))
        nodes = np.zeros((nn, 8), np.float32)
        nodes[:, 0:3] = tree.bbox_min - pad
        nodes[:, 3:6] = tree.bbox_max + pad
        leaf = tree.is_leaf.astype(bool)
        # The right child of interior node i is the left child's miss link.
        right = np.where(leaf, 0, tree.skip[np.minimum(np.arange(nn) + 1,
                                                       nn - 1)])
        meta = nodes[:, 6:8].view(np.int32)
        meta[:, 0] = np.where(leaf, tree.first, right)
        meta[:, 1] = np.where(leaf, tree.count, 0)
        order = tree.prim_order
        table = np.zeros((p, FIELD_STRIDE[kind]), np.float32)
        table[:, :nf] = fields[order]
        if isinstance(global_base, (int, np.integer)):
            gid = order.astype(np.int64) + int(global_base)
        else:
            gid = np.asarray(global_base, np.int64)[order]
        if gid.max(initial=0) >= 2**31:
            raise ValueError("global prim ids must fit in int32")
        self.nodes = torch.from_numpy(nodes).to(device)
        self.fields = torch.from_numpy(table).to(device)
        self.slot_gid = torch.from_numpy(gid.astype(np.int32)).to(device)

    def trace(self, rays, any_hit: bool = False):
        """(t [N], global prim id [N] int32); inf / -1 on a miss. CUDA
        tensors launch K5, CPU tensors take trace_reference. any_hit stops a
        ray at its first hit: t is then finite exactly where the closest
        hit's t is."""
        kind = rays.origin.device.type
        if kind == "cpu":
            return trace_reference(self, rays)
        if kind != "cuda":
            raise ValueError(f"no trace backend for device {rays.origin.device}")
        return trace_planes(self, ray_mod.to_planes(rays), any_hit)


def trace_reference(tracer: FamilyTracer, rays):
    """Plain version of K5: every ray against every primitive of the family
    in chunks of rays, the lowest global id winning on equal t. (t [N],
    global id [N] int32), inf / -1 on a miss; dead rays (t_max <= 0) miss.
    Any hit is the same function: its t is finite exactly where this t
    is."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    t_out = torch.full((n,), INF, device=dev)
    id_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    gid = tracer.slot_gid.to(dev)[None, :]
    chunk = max(1, SWEEP_ELEMS // max(tracer.n_prims, 1))
    fields = tracer.fields.to(dev)
    parts = _ray_parts(rays)
    for s in range(0, n, chunk):
        r = [x[s:s + chunk, None] for x in parts]
        t, ok = prim_test(tracer.kind, lambda k: fields[None, :, k], *r)
        t = torch.where(ok & (t < BIG), t, BIG)
        t_min = t.min(dim=1).values
        g = torch.where(t == t_min[:, None], gid, INT_MAX).min(dim=1).values
        hit = t_min < BIG
        t_out[s:s + chunk] = torch.where(hit, t_min, INF)
        id_out[s:s + chunk] = torch.where(hit, g, -1).to(torch.int32)
    return t_out, id_out


def _slab(nodes, i, parts, inv, t_max, t_best):
    """The kernel's conservative node test of node i[m] for rays m:
    (pass [m], t_enter [m])."""
    rox, roy, roz = parts[0], parts[1], parts[2]
    box = nodes[i]
    tx0 = (box[:, 0] - rox) * inv[0]
    tx1 = (box[:, 3] - rox) * inv[0]
    ty0 = (box[:, 1] - roy) * inv[1]
    ty1 = (box[:, 4] - roy) * inv[1]
    tz0 = (box[:, 2] - roz) * inv[2]
    tz1 = (box[:, 5] - roz) * inv[2]
    t_enter = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                          torch.minimum(ty0, ty1)),
                            torch.minimum(tz0, tz1))
    t_exit = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                         torch.maximum(ty0, ty1)),
                           torch.maximum(tz0, tz1))
    lo = torch.tensor(1.0 - SLAB_EPS)
    hi = torch.tensor(1.0 + SLAB_EPS)
    te = t_enter * torch.where(t_enter > 0.0, lo, hi)
    tx = t_exit * torch.where(t_exit > 0.0, hi, lo)
    ok = (te <= tx) & (tx >= T_MIN) & (te < t_max) & (te <= t_best)
    return ok, te


def traverse_reference(tracer: FamilyTracer, rays, any_hit: bool = False):
    """The kernel's walk repeated on the host, all rays in lockstep: near
    child first, far child pushed with its t_enter, a popped node skipped
    when its t_enter is above the best t. Returns (t, global id, node tests,
    primitive tests); t and id equal trace_reference's, the counts are the
    work K5 does for these rays."""
    rays = rays.to("cpu")
    nodes = tracer.nodes.cpu()
    meta = nodes[:, 6:8].contiguous().view(torch.int32).to(torch.int64)
    fields = tracer.fields.cpu()
    slot_gid = tracer.slot_gid.cpu()
    n = rays.origin.shape[0]
    parts = _ray_parts(rays)
    inv = [1.0 / torch.where(x == 0.0, 1e-30, x) for x in parts[3:6]]
    t_max = parts[6]
    t_best = torch.full((n,), BIG)
    g_best = torch.full((n,), -1, dtype=torch.int64)
    node = torch.zeros(n, dtype=torch.int64)
    stack_n = torch.zeros(n, MAX_STACK, dtype=torch.int64)
    stack_t = torch.zeros(n, MAX_STACK)
    sp = torch.zeros(n, dtype=torch.int64)
    live = t_max > 0.0
    node_tests = int(live.sum())
    active, _ = _slab(nodes, node, parts, inv, t_max, t_best)
    active &= live
    prim_tests = 0
    while bool(active.any()):
        m = torch.nonzero(active).squeeze(1)
        sub = lambda x: x[m]  # noqa: E731
        p = [sub(x) for x in parts]
        iv = [sub(x) for x in inv]
        nd = node[m]
        first, count = meta[nd, 0], meta[nd, 1]
        leaf = count > 0
        tb, gb = t_best[m], g_best[m]
        done = torch.zeros_like(leaf)
        for k in range(bvh_mod.MAX_LEAF):
            valid = leaf & (k < count) & ~done
            prim_tests += int(valid.sum())
            slot = torch.where(valid, first + k, 0)
            row = fields[slot]
            t, ok = prim_test(tracer.kind, lambda j: row[:, j], *p)
            g = slot_gid[slot].to(torch.int64)
            take = valid & ok & (t < BIG)
            if any_hit:
                done = done | take
            else:
                take &= (t < tb) | ((t == tb) & (g < gb))
            tb = torch.where(take, t, tb)
            gb = torch.where(take, g, gb)
        inner = ~leaf
        left = torch.where(inner, nd + 1, 0)
        right = torch.where(inner, first, 0)
        node_tests += 2 * int(inner.sum())
        hl, tl = _slab(nodes, left, p, iv, p[6], tb)
        hr, tr = _slab(nodes, right, p, iv, p[6], tb)
        hl &= inner
        hr &= inner
        both = hl & hr
        near_l = tl <= tr
        nxt = torch.where(hl & (~hr | near_l), left, right)
        # Push the far child of rays that hit both.
        far = torch.where(near_l, right, left)
        far_t = torch.where(near_l, tr, tl)
        sp_m = sp[m]
        rows = m[both]
        stack_n[rows, sp_m[both]] = far[both]
        stack_t[rows, sp_m[both]] = far_t[both]
        sp_m = sp_m + both.to(torch.int64)
        go_on = hl | hr
        # Pop until an entry can still beat the best t.
        popping = ~go_on & ~done
        for _ in range(MAX_STACK):
            popping &= sp_m > 0
            if not bool(popping.any()):
                break
            sp_m = sp_m - popping.to(torch.int64)
            top = torch.clamp_min(sp_m, 0)
            e_n = stack_n[m, top]
            e_t = stack_t[m, top]
            found = popping & (e_t <= tb)
            nxt = torch.where(found, e_n, nxt)
            go_on |= found
            popping &= ~found
        t_best[m], g_best[m] = tb, gb
        node[m] = nxt
        sp[m] = sp_m
        active[m] = go_on & ~done
    hit = t_best < BIG
    return (torch.where(hit, t_best, INF),
            torch.where(hit, g_best, -1).to(torch.int32), node_tests,
            prim_tests)


# ------------------------------- CUDA kernel -------------------------------


def trace_planes(tracer: FamilyTracer, planes, any_hit: bool = False):
    """Launch K5 on SoA ray planes [7, N] (ox, oy, oz, dx, dy, dz, t_max).
    Returns (t [N] float32, global id [N] int32)."""
    global LAUNCHES
    if not (planes.is_cuda and planes.dtype == torch.float32
            and planes.dim() == 2 and planes.shape[0] == 7
            and planes.is_contiguous()):
        raise ValueError("planes must be contiguous CUDA float32 [7, N], got "
                         f"{planes.dtype} {tuple(planes.shape)} on "
                         f"{planes.device}")
    shapes = {"nodes": (torch.float32, (tracer.n_nodes, 8)),
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
    max_stack = kernels.lib().pbrs_bvh_max_stack()
    if tracer.depth > max_stack:
        raise ValueError(f"a BVH of depth {tracer.depth} overflows the "
                         f"kernel's {max_stack}-entry stack")
    n = planes.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=planes.device)
    ids = torch.empty(n, dtype=torch.int32, device=planes.device)
    if n == 0:
        return t, ids
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = kernels.lib().pbrs_trace_bvh(
        tracer.nodes.data_ptr(), tracer.fields.data_ptr(),
        tracer.slot_gid.data_ptr(), tracer.kind, planes.data_ptr(), n,
        t.data_ptr(), ids.data_ptr(), int(any_hit), stream)
    kernels.check(rc, "trace_bvh")
    LAUNCHES += 1
    return t, ids


# -------------------------------- factories --------------------------------


def tri_tracer(p0, p1, p2, global_base, device=None):
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    lo, hi = bvh_mod.triangle_bboxes(p0, p1, p2)
    return FamilyTracer(KIND_TRI, _tri_fields(p0, p1, p2), lo, hi,
                        global_base, device=device)


def sphere_tracer(c, r, global_base, device=None):
    c = np.asarray(c, np.float32)
    r = np.asarray(r, np.float32)
    lo, hi = c - r[:, None], c + r[:, None]
    return FamilyTracer(KIND_SPHERE, _sphere_fields(c, r), lo, hi,
                        global_base, device=device)


def quad_tracer(o, u, v, global_base, device=None):
    o = np.asarray(o, np.float32)
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    corners = np.stack([o, o + u, o + v, o + u + v])
    return FamilyTracer(KIND_QUAD, _quad_fields(o, u, v), corners.min(0),
                        corners.max(0), global_base, device=device)


def disk_tracer(c, n, radial, global_base, device=None):
    c = np.asarray(c, np.float32)
    n = np.asarray(n, np.float32)
    radial = np.asarray(radial, np.float32)
    r = np.sqrt((radial * radial).sum(1, keepdims=True))
    return FamilyTracer(KIND_DISK, _disk_fields(c, n, radial), c - r, c + r,
                        global_base, device=device)
