"""Single-kind primitive-BVH closest-hit / any-hit trace (kernel K6).
Mirrors pbrs_tpu/accel/mesh_pallas.py: the slot-column builders, the
packing, PrimBVHTracer and MeshBVHTracer with their constructor arguments
(the TPU's `interpret` and `block_rows` dropped; `device` added, "cuda"
unless the caller asks for the CPU) and ``trace(rays, any_hit=,
sort_rays=)``.

The tree is accel/bvh.py's, with leaves of at most TRIS_PER_LEAF = 9
primitives, so its DFS order and its tie order are the reference's under
the native and the NumPy builder alike. The TPU's nine-per-row leaf
matrix and 1-D SMEM node arrays are not carried over:

  nodes    [n_pairs, 16] float32, the child-pair table of that tree
           (accel/treelet.py:_pair_table, boxes unpadded): per interior
           node the left and the right child's box (lo xyz, hi xyz), then
           int32 bits (left ref, left count, right ref, right count); a
           leaf child is (first slot, count 1-9), an interior one (its
           pair index, 0). Pair 0 holds the root beside a NaN box. The
           left child of interior node i is i + 1, the right one
           skip[i + 1], so a child's pair index is above its parent's.
  fields   [P, FIELD_STRIDE] float32: each primitive's slot columns in
           leaf order, padded to whole float4s;
  slot_gid [P] int32: leaf-order slot -> global prim id (the slot
           columns' gid column).

csrc/trace_prim_bvh.cu walks one ray a thread over the pair table in DFS
order: both children of a pair tested at once, the left one visited first
whenever the ray wants it, a wanted right one pushed with its t_enter on a
stack in shared memory and tested again against the best t when popped.
That is the decision the reference's skip-link walk makes when it reaches
the node, so a lane visits the same leaves in the same order and keeps the
same hit. ``walk_reference``, the plain version, is the same walk with
every lane stepping together. A walk ends even on a corrupt table: at most
n_pairs pair fetches (a sound tree fetches each pair once) and no push
past stack_depth. CUDA tensors launch K6, CPU tensors take
walk_reference; neither falls back to the other. The TPU kernel descends a
node when any lane of its 32 x 128-lane tile wants it, so a lane here
visits a subset of the leaves it visited there: the two part only where a
lane's own slab test culls the leaf that holds its hit by rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..geometry import ray as ray_mod
from . import bvh as bvh_mod
from . import treelet

T_MIN = ray_mod.T_MIN
BIG = 3.0e38
INF = float("inf")
TRIS_PER_LEAF = 9
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
    """(pairs [n_pairs, 16], stack depth, fields [P, stride], slot_gid [P])
    as NumPy arrays and an int. slot_cols: [P, 13] in the primitives'
    original order, the gid column last. Every leaf must hold at most
    TRIS_PER_LEAF primitives."""
    cols = np.asarray(slot_cols, np.float32)[tree.prim_order]
    if (tree.count[tree.is_leaf > 0] > TRIS_PER_LEAF).any():
        raise ValueError(f"rebuild the BVH with max_leaf <= {TRIS_PER_LEAF}")
    pairs, depth = treelet._pair_table(tree, np.float32(0.0))
    nf = N_FIELDS[kind]
    fields = np.zeros((cols.shape[0], FIELD_STRIDE[kind]), np.float32)
    fields[:, :nf] = cols[:, :nf]
    return pairs, depth, fields, cols[:, 12].astype(np.int32)


class PrimBVHTracer:
    """Closest-hit / any-hit over a single-type primitive BVH. The tables
    go to `device`, the card unless the caller asks for the CPU; asking
    for the card without one raises."""

    def __init__(self, kind, slot_cols, bbox_lo, bbox_hi,
                 max_leaf=TRIS_PER_LEAF, device="cuda"):
        if max_leaf > TRIS_PER_LEAF:
            raise ValueError(f"max_leaf must be at most {TRIS_PER_LEAF}")
        if (torch.device(device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(f"{type(self).__name__}: no CUDA device; pass "
                               "device='cpu' to trace on the CPU")
        self.kind = kind
        self.bvh = bvh_mod.build_bvh(np.asarray(bbox_lo, np.float32),
                                     np.asarray(bbox_hi, np.float32),
                                     max_leaf=max_leaf)
        pairs, self.stack_depth, fields, slot_gid = pack_mesh(
            self.bvh, slot_cols, kind)
        self.num_nodes = self.bvh.bbox_min.shape[0]
        self.n_pairs = pairs.shape[0]
        self.n_prims = fields.shape[0]
        self.nodes = torch.from_numpy(pairs).to(device)
        self.fields = torch.from_numpy(fields).to(device)
        self.slot_gid = torch.from_numpy(slot_gid).to(device)

    def trace(self, rays, any_hit=False, sort_rays=True):
        """(t [N], global prim id [N] int32), inf / -1 on a miss. CUDA rays
        launch K6, CPU rays take walk_reference. sort_rays orders the lanes
        by (direction octant, origin cell) before the walk, as the TPU
        tracer does for its packets; a per-lane walk gives the same answer
        either way, and the sort keeps a warp's walks alike."""
        planes = ray_mod.to_planes(rays)
        order = _octant_cell_order(rays) if sort_rays else None
        if order is not None:
            planes = planes[:, order]
        kind = planes.device.type
        if kind == "cpu":
            t, idx = walk_reference(self, planes, any_hit)
        elif kind == "cuda":
            t, idx = trace_planes(self, planes, any_hit)
        else:
            raise ValueError(f"no trace backend for device {planes.device}")
        if order is not None:
            t = torch.empty_like(t).index_copy_(0, order, t)
            idx = torch.empty_like(idx).index_copy_(0, order, idx)
        return t, idx


class MeshBVHTracer(PrimBVHTracer):
    """Triangle-BVH tracer (mesh_pallas.MeshBVHTracer)."""

    def __init__(self, p0, p1, p2, global_base: int, max_leaf=TRIS_PER_LEAF,
                 device="cuda"):
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
    # 12-bit keys: a 16-bit sort gives the same order in fewer passes.
    return torch.argsort(key.to(torch.int16), stable=True)


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


def _slab(box, o, inv, limit):
    """K6's slab test of boxes box[m] (lo xyz, hi xyz) for lanes m:
    (wanted [m], t_enter [m]). NaN-propagating min / max, as the kernel's
    (the NaN box beside the root is never wanted)."""
    tx0 = (box[:, 0] - o[0]) * inv[0]
    tx1 = (box[:, 3] - o[0]) * inv[0]
    ty0 = (box[:, 1] - o[1]) * inv[1]
    ty1 = (box[:, 4] - o[1]) * inv[1]
    tz0 = (box[:, 2] - o[2]) * inv[2]
    tz1 = (box[:, 5] - o[2]) * inv[2]
    t_enter = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                          torch.minimum(ty0, ty1)),
                            torch.minimum(tz0, tz1))
    t_exit = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                         torch.maximum(ty0, ty1)),
                           torch.maximum(tz0, tz1))
    wanted = (t_enter <= t_exit) & (t_exit >= T_MIN) & (t_enter < limit)
    return wanted, t_enter


def walk_reference(tracer: PrimBVHTracer, planes, any_hit: bool = False,
                   work=None):
    """Plain version of K6 on SoA ray planes [7, N]: the kernel's per-lane
    walk over the pair table, every live lane taking one step (a pair or a
    leaf) together. At a pair both children are tested; the left one is
    taken when wanted, a wanted right one pushed with its t_enter (none
    past stack_depth); a lane with neither, or done with a leaf, pops
    until an entry's t_enter is below its best t. A lane stops after
    n_pairs pair fetches, or at a pair index outside the table. A leaf's
    primitives are tested at once: the first of them with the least t
    replaces the best hit when strictly closer, which is the kernel's
    in-order `t < t_best` update. (t [N], global id [N] int32). `work` (a
    dict), when given, gains the box and primitive tests the walk made
    ("node_tests", two a pair; "prim_tests"), the work K6 does for these
    rays (an any-hit walk that stops inside a leaf is counted whole)."""
    dev = planes.device
    n = planes.shape[1]
    pairs = tracer.nodes.to(dev)
    refs = pairs[:, 12:16].contiguous().view(torch.int32).to(torch.int64)
    fields = tracer.fields.to(dev)
    slot_gid = tracer.slot_gid.to(dev)
    n_pairs, depth = tracer.n_pairs, tracer.stack_depth
    o = planes[0:3]
    d = planes[3:6]
    t_max = planes[6]
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    t_best = torch.full((n,), BIG, device=dev)
    g_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    # The node in hand: a pair index (cnt 0) or a leaf (first slot, cnt).
    ref = torch.zeros(n, dtype=torch.int64, device=dev)
    cnt = torch.zeros(n, dtype=torch.int64, device=dev)
    fetches = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack_ref = torch.zeros(n, depth, dtype=torch.int32, device=dev)
    stack_cnt = torch.zeros(n, depth, dtype=torch.int32, device=dev)
    stack_t = torch.zeros(n, depth, device=dev)
    lanes = torch.nonzero(t_max > 0.0).squeeze(1)
    ks = torch.arange(TRIS_PER_LEAF, device=dev)
    node_tests = prim_tests = 0
    while lanes.numel():
        leaf = cnt[lanes] > 0
        done = torch.zeros_like(leaf)
        popping = torch.zeros_like(leaf)
        if bool(leaf.any()):
            ln = lanes[leaf]
            first, c = ref[ln], cnt[ln]
            valid = ks[None, :] < c[:, None]
            prim_tests += int(c.sum())
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
            if any_hit:
                done[leaf] = take
                popping[leaf] = ~take
            else:
                popping[leaf] = True
        pos = torch.nonzero(~leaf).squeeze(1)
        if pos.numel():
            lp = lanes[pos]
            pr = ref[lp]
            # The cap (a sound tree fetches each pair at most once) and a
            # pair index outside the table end the walk.
            stop = (fetches[lp] >= n_pairs) | (pr < 0) | (pr >= n_pairs)
            done[pos[stop]] = True
            pos, lp, pr = pos[~stop], lp[~stop], pr[~stop]
            fetches[lp] += 1
            node_tests += 2 * lp.numel()
            box, rr = pairs[pr], refs[pr]
            limit = torch.minimum(t_best[lp], t_max[lp])
            wl, tl = _slab(box[:, 0:6], o[:, lp], inv[:, lp], limit)
            wr, tr = _slab(box[:, 6:12], o[:, lp], inv[:, lp], limit)
            push = wl & wr & (sp[lp] < depth)
            pl, at = lp[push], sp[lp[push]]
            stack_ref[pl, at] = rr[push, 2].to(torch.int32)
            stack_cnt[pl, at] = rr[push, 3].to(torch.int32)
            stack_t[pl, at] = tr[push]
            sp[pl] += 1
            ref[lp] = torch.where(wl, rr[:, 0], rr[:, 2])
            cnt[lp] = torch.where(wl, rr[:, 1], rr[:, 3])
            popping[pos[~(wl | wr)]] = True
        # Pop until an entry's t_enter is below the best t: a pushed t_enter
        # is below t_max, so this is the slab test's `t_enter < min(t_best,
        # t_max)` at that node. An empty stack ends the walk.
        pos = torch.nonzero(popping).squeeze(1)
        while pos.numel():
            pl = lanes[pos]
            has = sp[pl] > 0
            done[pos[~has]] = True
            pos, pl = pos[has], pl[has]
            sp[pl] -= 1
            top = sp[pl]
            found = stack_t[pl, top] < t_best[pl]
            pf, tf = pl[found], top[found]
            ref[pf] = stack_ref[pf, tf].to(torch.int64)
            cnt[pf] = stack_cnt[pf, tf].to(torch.int64)
            pos = pos[~found]
        lanes = lanes[~done]
    if work is not None:
        work["node_tests"] = work.get("node_tests", 0) + node_tests
        work["prim_tests"] = work.get("prim_tests", 0) + prim_tests
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
    shapes = {"nodes": (torch.float32, (tracer.n_pairs, treelet.PAIR_COLS)),
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
    max_depth = kernels.lib().pbrs_prim_bvh_max_stack_depth()
    if tracer.stack_depth > max_depth:
        raise ValueError(f"a BVH of depth {tracer.stack_depth} overflows the "
                         f"{max_depth} stack entries shared memory holds")
    n = planes.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=planes.device)
    ids = torch.empty(n, dtype=torch.int32, device=planes.device)
    if n == 0:
        return t, ids
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = kernels.lib().pbrs_trace_prim_bvh(
        tracer.nodes.data_ptr(), tracer.n_pairs, tracer.stack_depth,
        tracer.fields.data_ptr(), tracer.slot_gid.data_ptr(), tracer.kind,
        planes.data_ptr(), n, t.data_ptr(), ids.data_ptr(), int(any_hit),
        stream)
    kernels.check(rc, "trace_prim_bvh")
    LAUNCHES += 1
    return t, ids


# Fields of kernel_info, in the order pbrs_trace_prim_bvh_info fills them.
KERNEL_INFO = ("registers", "local_bytes", "warps_per_sm", "threads",
               "static_smem", "dynamic_smem")


def kernel_info(kind, any_hit, stack_depth) -> dict:
    """The K6 instance for (kind, any_hit) as built and as it fits an SM of
    the current card at this stack depth: registers and local memory
    (spill and stack) bytes a thread, resident warps an SM, threads a
    block, static and dynamic shared bytes a block (KERNEL_INFO). CUDA
    only."""
    import ctypes

    info = (ctypes.c_int * len(KERNEL_INFO))()
    kernels.check(kernels.lib().pbrs_trace_prim_bvh_info(
        kind, int(any_hit), stack_depth, ctypes.cast(info, ctypes.c_void_p)),
        "trace_prim_bvh info")
    return dict(zip(KERNEL_INFO, info))
