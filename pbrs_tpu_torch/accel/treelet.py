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
of accel/bvh.py per thread instead, live rays packed into full warps, with
a stack in shared memory. The family tracer holds that BVH as a table of
child-pair nodes (both children's boxes and references in 64 bytes, one
fetch a step), the family's field rows (treelet.py's field builders) in
leaf order and a slot -> global id map.

A trace may take the query's running hit (t_in, id_in: the flat bank's, or
an earlier family's) and returns the merged result, the family's hit where
it is strictly closer, else the running one: the merge of
trace_kernel.Tracer. The kernel starts its walk from that hit, culls every
node beyond it and merges into the running hit's tensors in place; with
any_hit a lane whose running hit is finite is not walked at all.

``trace_reference``, the plain version, is a brute-force sweep of every
primitive of the family in chunks of rays, with the kernel's per-primitive
arithmetic and tie rule, merged with the running hit; ``traverse_reference``
repeats the kernel's walk over the child-pair table on the host, to count
the node and primitive tests a ray batch needs and to check the walk's
culling against the sweep. CUDA tensors launch K5, CPU tensors take
trace_reference; neither falls back to the other.

Tie rule (both versions): on equal t the running hit stays, and among the
family's primitives the lowest global id wins, so the result does not
depend on the order of traversal. The TPU tracer keeps the first-visited
treelet's hit instead, so ids can differ from pbrs_tpu's on exact-t ties
(coplanar faces of abutting cuboids).
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
# Floats of one child-pair node: two boxes (lo xyz, hi xyz), then the left
# and right child's (ref, count) as int32 bits.
PAIR_COLS = 16
# Primitives a leaf of the pair table holds at most (csrc/trace_bvh.cu
# LEAF_MAX: a stack entry packs a leaf as ~(first * 16 + count)).
LEAF_MAX = 15
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


def _pair_table(tree, pad):
    """The child-pair node table of a FlatBVH: [1 + interior nodes, 16]
    float32, and the walk's stack depth. Pair 0 holds the root beside a NaN
    box (which no slab test passes); pair 1 + k the two children of the
    k-th interior node in DFS order. A child is (first slot, prim count >
    0) for a leaf and (its pair index, 0) for an interior node; boxes grow
    outward by `pad`. A leaf above LEAF_MAX primitives (a builder leaves
    any count below depth 60) becomes pairs of halves in its own box,
    appended after the rest. A child's pair index is above its parent's."""
    nn = tree.bbox_min.shape[0]
    leaf = tree.is_leaf.astype(bool)
    inner = np.nonzero(~leaf)[0]
    pair_of = np.zeros(nn, np.int64)
    pair_of[inner] = 1 + np.arange(inner.size)
    lo = (tree.bbox_min - pad).astype(np.float32)
    hi = (tree.bbox_max + pad).astype(np.float32)
    # The right child of interior node i is the left child's miss link.
    left = inner + 1
    right = tree.skip[left].astype(np.int64)
    table = np.zeros((1 + inner.size, PAIR_COLS), np.float32)
    refs = table[:, 12:16].view(np.int32)

    def put(rows, child, col):
        table[rows, 6 * col:6 * col + 3] = lo[child]
        table[rows, 6 * col + 3:6 * col + 6] = hi[child]
        refs[rows, 2 * col] = np.where(leaf[child], tree.first[child],
                                       pair_of[child])
        refs[rows, 2 * col + 1] = np.where(leaf[child], tree.count[child], 0)

    put(np.zeros(1, np.int64), np.zeros(1, np.int64), 0)
    table[0, 6:12] = np.nan
    put(1 + np.arange(inner.size), left, 0)
    put(1 + np.arange(inner.size), right, 1)
    extra = []

    def split(first, count, box):
        if count <= LEAF_MAX:
            return first, count
        k = len(extra)
        extra.append(None)
        half = count // 2
        kids = (split(first, half, box), split(first + half, count - half,
                                              box))
        extra[k] = (box, kids)
        return table.shape[0] + k, 0

    for pair, side in zip(*np.nonzero(refs[:, 1::2] > LEAF_MAX)):
        refs[pair, 2 * side:2 * side + 2] = split(
            int(refs[pair, 2 * side]), int(refs[pair, 2 * side + 1]),
            table[pair, 6 * side:6 * side + 6].copy())
    if extra:
        more = np.zeros((len(extra), PAIR_COLS), np.float32)
        more_refs = more[:, 12:16].view(np.int32)
        for k, (box, kids) in enumerate(extra):
            more[k, 0:6] = more[k, 6:12] = box
            more_refs[k] = (*kids[0], *kids[1])
        table = np.concatenate([table, more])
        refs = table[:, 12:16].view(np.int32)
    # Stack entries a walk needs: one for each pair above it on its path.
    level = np.zeros(table.shape[0], np.int64)
    for p in range(table.shape[0]):
        for side in (0, 1):
            if refs[p, 2 * side + 1] == 0 and not (p == 0 and side == 1):
                level[refs[p, 2 * side]] = level[p] + 1
    return table, max(int(level.max()), 1)


class FamilyTracer:
    """Closest-hit / any-hit over one primitive family through its BVH.

    Tables (on `device`):
      nodes  [n_pairs, 16] float32, the child-pair table (_pair_table): per
             node the left and right child's box (lo xyz, hi xyz, padded
             outward by BOX_PAD), then int32 bits (left ref, left count,
             right ref, right count): a leaf child is (first slot, 1 to
             LEAF_MAX prims), an interior one (its pair index, 0). Pair 0
             holds the root.
      fields [P, FIELD_STRIDE] float32: the field rows in leaf order.
      slot_gid [P] int32: leaf-order slot -> global prim id.
    stack_depth is the walk's stack entries a ray: one per tree level.
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
        self.n_nodes = tree.bbox_min.shape[0]
        pad = np.float32(BOX_PAD * max(float(np.abs(lo).max()),
                                       float(np.abs(hi).max()), 1.0))
        nodes, self.stack_depth = _pair_table(tree, pad)
        self.n_pairs = nodes.shape[0]
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

    def trace(self, rays, any_hit: bool = False, t_in=None, id_in=None):
        """(t [N], global prim id [N] int32); inf / -1 on a miss, merged
        with the running hit (t_in, id_in) when given (in place, on CUDA
        tensors). CUDA tensors launch K5, CPU tensors take trace_reference.
        any_hit stops a ray at its first hit: t is then finite exactly where
        the closest hit's t is."""
        kind = rays.origin.device.type
        if kind == "cpu":
            return trace_reference(self, rays, t_in, id_in)
        if kind != "cuda":
            raise ValueError(f"no trace backend for device {rays.origin.device}")
        return trace_planes(self, ray_mod.to_planes(rays), any_hit, t_in,
                            id_in)


def merge(t_in, id_in, t, idx):
    """The running hit merged with a family's: the family's where strictly
    closer (on equal t the running hit stays)."""
    if t_in is None:
        return t, idx
    closer = t < t_in
    return torch.where(closer, t, t_in), torch.where(closer, idx, id_in)


def trace_reference(tracer: FamilyTracer, rays, t_in=None, id_in=None):
    """Plain version of K5: every ray against every primitive of the family
    in chunks of rays, the lowest global id winning on equal t, merged with
    the running hit (t_in, id_in) when given. (t [N], global id [N] int32),
    inf / -1 on a miss; dead rays (t_max <= 0) keep the running hit. Any
    hit is the same function: its t is finite exactly where this t is."""
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
    return merge(t_in, id_in, t_out, id_out)


def _slab(box, parts, inv, t_max, t_best):
    """The kernel's conservative slab test of boxes box[m] (lo xyz, hi xyz)
    for rays m: (pass [m], t_enter [m]). NaN-dropping fmin / fmax, as the
    kernel's (a box of NaNs never passes)."""
    rox, roy, roz = parts[0], parts[1], parts[2]
    tx0 = (box[:, 0] - rox) * inv[0]
    tx1 = (box[:, 3] - rox) * inv[0]
    ty0 = (box[:, 1] - roy) * inv[1]
    ty1 = (box[:, 4] - roy) * inv[1]
    tz0 = (box[:, 2] - roz) * inv[2]
    tz1 = (box[:, 5] - roz) * inv[2]
    t_enter = torch.fmax(torch.fmax(torch.fmin(tx0, tx1),
                                    torch.fmin(ty0, ty1)),
                         torch.fmin(tz0, tz1))
    t_exit = torch.fmin(torch.fmin(torch.fmax(tx0, tx1),
                                   torch.fmax(ty0, ty1)),
                        torch.fmax(tz0, tz1))
    lo = torch.tensor(1.0 - SLAB_EPS)
    hi = torch.tensor(1.0 + SLAB_EPS)
    te = t_enter * torch.where(t_enter > 0.0, lo, hi)
    tx = t_exit * torch.where(t_exit > 0.0, hi, lo)
    ok = (te <= tx) & (tx >= T_MIN) & (te < t_max) & (te <= t_best)
    return ok, te


def traverse_reference(tracer: FamilyTracer, rays, any_hit: bool = False,
                       t_in=None, id_in=None):
    """The kernel's walk over the child-pair table repeated on the host,
    all rays in lockstep: both children of a node tested from the one
    pair, the nearer hit child taken and the farther pushed with its
    t_enter, a popped entry skipped when its t_enter is above the best t,
    which starts at the running hit. Returns (t, global id, node tests,
    primitive tests); t and id equal trace_reference's, the counts are the
    box and primitive tests K5 does for these rays (two box tests a
    pair)."""
    rays = rays.to("cpu")
    pairs = tracer.nodes.cpu()
    refs = pairs[:, 12:16].contiguous().view(torch.int32).to(torch.int64)
    fields = tracer.fields.cpu()
    slot_gid = tracer.slot_gid.cpu()
    n = rays.origin.shape[0]
    parts = _ray_parts(rays)
    inv = [1.0 / torch.where(x == 0.0, 1e-30, x) for x in parts[3:6]]
    t_max = parts[6]
    seed = torch.full((n,), INF) if t_in is None else t_in.cpu()
    t_best = torch.where(seed < BIG, seed, torch.tensor(BIG))
    g_best = torch.full((n,), -1, dtype=torch.int64)
    ref = torch.zeros(n, dtype=torch.int64)
    cnt = torch.zeros(n, dtype=torch.int64)
    depth = tracer.stack_depth
    stack_ref = torch.zeros(n, depth, dtype=torch.int64)
    stack_cnt = torch.zeros(n, depth, dtype=torch.int64)
    stack_t = torch.zeros(n, depth)
    sp = torch.zeros(n, dtype=torch.int64)
    active = t_max > 0.0
    if any_hit:
        active &= ~(seed < BIG)
    node_tests = prim_tests = 0
    while bool(active.any()):
        m = torch.nonzero(active).squeeze(1)
        p = [x[m] for x in parts]
        iv = [x[m] for x in inv]
        rf, ct, tb, gb = ref[m], cnt[m], t_best[m], g_best[m]
        leaf = ct > 0
        done = torch.zeros_like(leaf)
        # A leaf: its primitives, the lowest global id winning on equal t.
        for k in range(int(ct.max())):
            valid = leaf & (k < ct) & ~done
            prim_tests += int(valid.sum())
            slot = torch.where(valid, rf + k, 0)
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
        # An interior pair: both children from one node.
        inner = ~leaf
        node_tests += 2 * int(inner.sum())
        pr = pairs[torch.where(inner, rf, 0)]
        rr = refs[torch.where(inner, rf, 0)]
        hl, tl = _slab(pr[:, 0:6], p, iv, p[6], tb)
        hr, tr = _slab(pr[:, 6:12], p, iv, p[6], tb)
        hl &= inner
        hr &= inner
        both = hl & hr
        near_l = tl <= tr
        go_l = hl & (~hr | near_l)
        nxt_ref = torch.where(go_l, rr[:, 0], rr[:, 2])
        nxt_cnt = torch.where(go_l, rr[:, 1], rr[:, 3])
        # Push the far child of rays that hit both.
        sp_m = sp[m]
        rows = m[both]
        far_l = both & ~near_l
        stack_ref[rows, sp_m[both]] = torch.where(far_l, rr[:, 0],
                                                  rr[:, 2])[both]
        stack_cnt[rows, sp_m[both]] = torch.where(far_l, rr[:, 1],
                                                  rr[:, 3])[both]
        stack_t[rows, sp_m[both]] = torch.where(far_l, tl, tr)[both]
        sp_m = sp_m + both.to(torch.int64)
        go_on = hl | hr
        # Pop until an entry can still beat the best t.
        popping = ~go_on & ~done
        for _ in range(depth):
            popping &= sp_m > 0
            if not bool(popping.any()):
                break
            sp_m = sp_m - popping.to(torch.int64)
            top = torch.clamp(sp_m, 0, depth - 1)
            found = popping & (stack_t[m, top] <= tb)
            nxt_ref = torch.where(found, stack_ref[m, top], nxt_ref)
            nxt_cnt = torch.where(found, stack_cnt[m, top], nxt_cnt)
            go_on |= found
            popping &= ~found
        t_best[m], g_best[m] = tb, gb
        ref[m], cnt[m], sp[m] = nxt_ref, nxt_cnt, sp_m
        active[m] = go_on & ~done
    fam = g_best >= 0
    t = torch.where(fam, t_best, seed)
    g = torch.where(fam, g_best, -1 if id_in is None else id_in.cpu().to(
        torch.int64))
    return t, g.to(torch.int32), node_tests, prim_tests


# ------------------------------- CUDA kernel -------------------------------


def trace_planes(tracer: FamilyTracer, planes, any_hit: bool = False,
                 t_in=None, id_in=None):
    """Launch K5 on SoA ray planes [7, N] (ox, oy, oz, dx, dy, dz, t_max).
    Returns (t [N] float32, global id [N] int32). Given the running hit
    (t_in [N] float32, id_in [N] int32; both or neither), K5 merges its
    family's hits into those two tensors in place and returns them."""
    global LAUNCHES
    if not (planes.is_cuda and planes.dtype == torch.float32
            and planes.dim() == 2 and planes.shape[0] == 7
            and planes.is_contiguous()):
        raise ValueError("planes must be contiguous CUDA float32 [7, N], got "
                         f"{planes.dtype} {tuple(planes.shape)} on "
                         f"{planes.device}")
    n = planes.shape[1]
    shapes = {"nodes": (tracer, torch.float32, (tracer.n_pairs, PAIR_COLS)),
              "fields": (tracer, torch.float32,
                         (tracer.n_prims, FIELD_STRIDE[tracer.kind])),
              "slot_gid": (tracer, torch.int32, (tracer.n_prims,))}
    if (t_in is None) != (id_in is None):
        raise ValueError("give both t_in and id_in, or neither")
    if t_in is not None:
        shapes["t_in"] = (t_in, torch.float32, (n,))
        shapes["id_in"] = (id_in, torch.int32, (n,))
    for name, (owner, dtype, shape) in shapes.items():
        tab = getattr(owner, name) if owner is tracer else owner
        if not (tab.device == planes.device and tab.dtype == dtype
                and tuple(tab.shape) == shape and tab.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{planes.device}, got {tab.dtype} "
                             f"{tuple(tab.shape)} on {tab.device}")
    max_depth = kernels.lib().pbrs_bvh_max_stack_depth()
    if tracer.stack_depth > max_depth:
        raise ValueError(f"a BVH of depth {tracer.stack_depth} overflows the "
                         f"{max_depth} stack entries shared memory holds")
    if t_in is None:
        t = torch.empty(n, dtype=torch.float32, device=planes.device)
        ids = torch.empty(n, dtype=torch.int32, device=planes.device)
    else:
        t, ids = t_in, id_in
    if n == 0:
        return t, ids
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = kernels.lib().pbrs_trace_bvh(
        tracer.nodes.data_ptr(), tracer.fields.data_ptr(),
        tracer.slot_gid.data_ptr(), tracer.kind, planes.data_ptr(),
        0 if t_in is None else t_in.data_ptr(),
        0 if id_in is None else id_in.data_ptr(), n, tracer.stack_depth,
        kernels.TRACE_CLAIM[bool(any_hit)], t.data_ptr(), ids.data_ptr(),
        int(any_hit), stream)
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
