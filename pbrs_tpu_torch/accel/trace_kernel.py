"""Flat-table closest-hit / occlusion trace (kernel K1) and the tracer
that joins it with the per-family BVH tracer (K5). Mirrors
pbrs_tpu/accel/trace_pallas.py: ``prim_scalars``, ``_partition_big`` and
``PallasTracer`` (here ``Tracer``), the ``trace/occluded`` contract of
``_trace_kernel``.

The CUDA kernel (``csrc/trace_flat.cu``) sweeps a packed copy of the
[P,16] primitive bank (``pack_bank``): each family's rows in Morton order
of their centres, cut into chunks of CHUNK rows with a padded box each, a
family's rows at its own stride, the global ids apart. Each block copies
it into shared memory; a warp sweeps its live rays 32 at a time and skips
every chunk whose box none of them can reach before its best hit.
Its plain version, ``trace_reference``, is the whole sweep as a broadcast
[N, P] tensor program with the kernel's per-primitive arithmetic, op for
op; ``sweep_chunks_reference`` repeats the kernel's chunk-culled sweep on
the host (to check the culling and to count the tests a ray batch needs).

``Tracer`` hands every family above TREELET_THRESHOLD primitives (or
``bvh_threshold``) to a BVH family tracer (accel/treelet.py, kernel K5),
keeps the rest in the flat bank, and splits a mixed-scale family by area:
its few big primitives stay in the bank, the dense rest goes to K5. Ids
stay global on both sides (bank column 15, the family tracer's id map).
K1's hit seeds each K5 walk, which merges its family's hits into it in
place. Its ``trace`` and ``occluded`` launch the kernels for CUDA tensors
and take their plain versions for CPU tensors; they never fall back from
one to the other.
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
INT_MAX = 2**31 - 1
BANK_COLS = 16
# Rows of the [P,16] bank that K2 and K3 stage whole in shared memory:
# 227 KB less 32 KB kept for their static arrays (csrc/trace_flat.cuh
# MAX_BANK_ROWS; chip_smoke.py phase 1 holds the two equal).
MAX_BANK_ROWS = (232448 - 32768) // (BANK_COLS * 4)
# The packed bank of K1 (csrc/trace_flat.cu): rows a chunk (of 4, 8, 16,
# 32 and 64, 4 culled best on the main paths' banks of 272 and 1007 rows),
# floats a row of each family (spheres, quads, triangles, disks), floats a
# chunk entry (box lo xyz, hi xyz, first row within the family and row
# count as int32 bits), and the Morton code's bits an axis.
CHUNK = 4
FAMILY_STRIDE = (4, 13, 12, 8)
CHUNK_FLOATS = 8
MORTON_BITS = 10

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


def _family_t(fam, p, rox, roy, roz, rdx, rdy, rdz, tm):
    """Candidate t of rays (columns [N, 1]) against rows of one family
    (p(j): column j as [1, R]), BIG where a row is no hit: K1's and K2's
    per-primitive tests, op for op."""

    def consider(t, ok):
        return torch.where(ok & (t >= T_MIN) & (t < tm), t, BIG)

    if fam == 0:
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
        return consider(torch.where(lo_ok, t_lo, t_hi), ok)
    if fam == 1:
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
        return consider(t, ok)
    if fam == 2:
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
        return consider(t, (denom != 0.0) & inside)
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
    return consider(t, (denom != 0.0) & inside)


def sweep_reference(bank, counts, rox, roy, roz, rdx, rdy, rdz, t_max):
    """Closest hit of [N] rays over the bank: (t [N], bank row [N]), with
    BIG / -1 on a miss. Ties go to the lowest row, as in the kernel's
    sequential `t < t_best` sweep."""
    ray = [x[:, None] for x in (rox, roy, roz, rdx, rdy, rdz, t_max)]
    ts = []
    start = 0
    for fam, count in enumerate(counts):
        if count:
            rows = bank[start:start + count]
            ts.append(_family_t(fam, lambda j: rows[:, j][None, :], *ray))
        start += count
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


# ---------------------- the packed bank of the kernel ----------------------


@dataclasses.dataclass
class FlatBank:
    """K1's packed copy of a [P,16] bank (``pack_bank``).

    packed [W] float32 (on the bank's device): the chunk table (every
    family's chunks in family order, CHUNK_FLOATS each), then each family's
    rows in Morton order at FAMILY_STRIDE floats, then the rows' global ids
    as int32 bits; every section starts on a 16-byte boundary. layout [14]
    int32 on the CPU: rows and chunks of each family, the first float of
    each family's rows, of the ids, and W (csrc/trace_flat.cu Layout)."""

    bank: torch.Tensor
    counts: tuple
    packed: torch.Tensor
    layout: torch.Tensor
    chunks: tuple


def _row_boxes(fam, rows):
    """Bounds (lo, hi) [R, 3] float64 of bank rows of one family."""
    r = rows.astype(np.float64)
    if fam == 0:
        rad = np.abs(r[:, 3:4])
        return r[:, 0:3] - rad, r[:, 0:3] + rad
    if fam == 3:
        rad = np.sqrt(np.maximum(r[:, 6:7], 0.0))
        return r[:, 0:3] - rad, r[:, 0:3] + rad
    if fam == 1:
        o, u, v = r[:, 0:3], r[:, 3:6], r[:, 6:9]
        pts = np.stack([o, o + u, o + v, o + u + v])
    else:
        pts = np.stack([r[:, 0:3], r[:, 3:6], r[:, 6:9]])
    return pts.min(0), pts.max(0)


def _morton(centres):
    """Morton codes of points, MORTON_BITS an axis over their bounds."""
    lo, hi = centres.min(0), centres.max(0)
    ext = np.where(hi > lo, hi - lo, 1.0)
    top = (1 << MORTON_BITS) - 1
    q = np.clip(((centres - lo) / ext * top).astype(np.int64), 0, top)
    code = np.zeros(len(centres), np.int64)
    for b in range(MORTON_BITS):
        for axis in range(3):
            code |= ((q[:, axis] >> b) & 1) << (3 * b + axis)
    return code


def _pad4(a):
    return np.concatenate([a, np.zeros((-a.size) % 4, np.float32)])


def pack_bank(bank, counts) -> FlatBank:
    """K1's packed bank from a [P,16] bank and its family counts: each
    family's rows sorted by the Morton code of their box centres (stable),
    cut into chunks of CHUNK rows, each chunk's box grown outward by
    treelet.BOX_PAD times the family's largest coordinate (as K5 pads its
    nodes). The values of a row are the bank's, bit for bit. Ids must rise
    with the bank row (as prim_scalars makes them), so the lowest id is
    the lowest row."""
    host = bank.detach().cpu().numpy().astype(np.float32)
    counts = tuple(int(c) for c in counts)
    n_rows = sum(counts)
    ids = host[:n_rows, 15].astype(np.int64)
    if (np.diff(ids) <= 0).any():
        raise ValueError("bank ids must rise with the row")
    start = np.cumsum((0,) + counts)
    chunk_tab, rows_out, ids_out, n_chunks = [], [], [], []
    for f in range(4):
        rows = host[start[f]:start[f + 1]]
        lo, hi = _row_boxes(f, rows)
        pad = treelet.BOX_PAD * max(float(np.abs(lo).max(initial=0.0)),
                                    float(np.abs(hi).max(initial=0.0)), 1.0)
        order = (np.argsort(_morton(0.5 * (lo + hi)), kind="stable")
                 if len(rows) else np.zeros(0, np.int64))
        lo, hi, rows = lo[order], hi[order], rows[order]
        ids_out.append(ids[start[f]:start[f + 1]][order])
        rows_out.append(_pad4(rows[:, :FAMILY_STRIDE[f]].reshape(-1)))
        firsts = range(0, len(rows), CHUNK)
        n_chunks.append(len(firsts))
        for c0 in firsts:
            entry = np.zeros(CHUNK_FLOATS, np.float32)
            entry[0:3] = lo[c0:c0 + CHUNK].min(0) - pad
            entry[3:6] = hi[c0:c0 + CHUNK].max(0) + pad
            entry[6:8].view(np.int32)[:] = (c0, min(CHUNK, len(rows) - c0))
            chunk_tab.append(entry)
    table = (np.concatenate(chunk_tab) if chunk_tab
             else np.zeros(0, np.float32))
    id_bits = _pad4(np.concatenate(ids_out).astype(np.int32).view(
        np.float32))
    sections = [table] + rows_out + [id_bits]
    offsets = np.cumsum([0] + [x.size for x in sections])
    packed = np.concatenate(sections)
    layout = np.asarray(list(counts) + n_chunks + list(offsets[1:5])
                        + [offsets[5], packed.size], np.int32)
    return FlatBank(bank=bank, counts=counts,
                    packed=torch.from_numpy(packed).to(bank.device),
                    layout=torch.from_numpy(layout), chunks=tuple(n_chunks))


def sweep_chunks_reference(flat: FlatBank, rays, order=None,
                           any_hit: bool = False):
    """K1's chunk-culled sweep repeated on the host from the packed bank:
    chunks visited in `order` (indices into the chunk table; by default
    the kernel's), a chunk's rows tested only by the rays whose best hit it
    may hold (the conservative slab test of treelet.py, against the best t
    so far), a hit kept by its (t, global id). Returns (t [N], global id
    [N] int32, chunk box tests, primitive tests of each family); t and id
    equal trace_reference's for a closest hit, and with any_hit t is finite
    where they are."""
    rays = rays.to("cpu")
    packed = flat.packed.cpu()
    lay = [int(x) for x in flat.layout]
    rows, n_chunks, offset = lay[0:4], lay[4:8], lay[8:12]
    ids = packed[lay[12]:lay[12] + sum(rows)].view(torch.int32).to(
        torch.int64)
    table = packed[:CHUNK_FLOATS * sum(n_chunks)].view(-1, CHUNK_FLOATS)
    meta = table[:, 6:8].contiguous().view(torch.int32).to(torch.int64)
    fam_of = torch.repeat_interleave(torch.arange(4), torch.tensor(n_chunks))
    id_base = np.cumsum([0] + rows)
    o, d = rays.origin, rays.dir
    parts = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
             rays.t_max)
    inv = [1.0 / torch.where(x == 0.0, 1e-30, x) for x in parts[3:6]]
    n = o.shape[0]
    t_best = torch.full((n,), BIG)
    g_best = torch.full((n,), -1, dtype=torch.int64)
    active = parts[6] > 0.0
    chunk_tests, prim_tests = 0, [0, 0, 0, 0]
    for c in (range(table.shape[0]) if order is None else order):
        c = int(c)
        fam = int(fam_of[c])
        chunk_tests += int(active.sum())
        box = table[c:c + 1, 0:6].expand(n, 6)
        hit, _ = treelet._slab(box, parts, inv, parts[6], t_best)
        m = torch.nonzero(hit & active).squeeze(1)
        if not m.numel():
            continue
        first, count = int(meta[c, 0]), int(meta[c, 1])
        stride = FAMILY_STRIDE[fam]
        sub = packed[offset[fam] + first * stride:
                     offset[fam] + (first + count) * stride].view(count,
                                                                  stride)
        t = _family_t(fam, lambda j: sub[:, j][None, :],
                      *[x[m][:, None] for x in parts])
        g = ids[id_base[fam] + first:id_base[fam] + first + count][None, :]
        valid = t < BIG
        if any_hit:
            # Rows in order; a ray stops at its first hit.
            k = torch.where(valid.any(1), valid.int().argmax(1), count - 1)
            prim_tests[fam] += int((k + 1).sum())
            got = valid.any(1)
            tc = t[torch.arange(m.numel()), k]
            gc = g[0, k]
            take = got
            active[m[got]] = False
        else:
            prim_tests[fam] += m.numel() * count
            tc = t.min(1).values
            gc = torch.where(t == tc[:, None], g, INT_MAX).min(1).values
            take = (tc < BIG) & ((tc < t_best[m])
                                 | ((tc == t_best[m]) & (gc < g_best[m])))
        t_best[m] = torch.where(take, tc, t_best[m])
        g_best[m] = torch.where(take, gc, g_best[m])
    hit = g_best >= 0
    return (torch.where(hit, t_best, INF), g_best.to(torch.int32),
            chunk_tests, tuple(prim_tests))


# ------------------------------ CUDA kernel -------------------------------


def _check_bank(bank, counts):
    """The [P,16] bank K2 and K3 stage whole into shared memory."""
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


def trace_planes(flat: FlatBank, planes, any_hit: bool = False):
    """Launch K1 on SoA ray planes [7, N] (ox, oy, oz, dx, dy, dz, t_max).
    Returns (t [N] float32, id [N] int32). any_hit stops a ray at its first
    hit: t is then finite exactly where the full sweep's t is."""
    global LAUNCHES
    packed = flat.packed
    if not (packed.is_cuda and packed.dtype == torch.float32
            and packed.dim() == 1 and packed.is_contiguous()):
        raise ValueError("the packed bank must be a contiguous CUDA float32 "
                         f"vector, got {packed.dtype} {tuple(packed.shape)} "
                         f"on {packed.device}")
    max_bytes = kernels.lib().pbrs_flat_max_bytes()
    if 4 * packed.numel() > max_bytes:
        raise ValueError(f"a packed bank of {4 * packed.numel()} bytes "
                         f"exceeds the {max_bytes} bytes shared memory holds")
    if not (planes.device == packed.device and planes.dtype == torch.float32
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
        packed.data_ptr(), flat.layout.data_ptr(), planes.data_ptr(), n,
        kernels.TRACE_CLAIM[bool(any_hit)], t.data_ptr(), ids.data_ptr(),
        int(any_hit), stream)
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
    family tracers (K5), the rest to the flat bank (K1); K1's hit seeds
    each family's walk, which keeps the closer hit (on equal t the earlier
    one)."""

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
        self.flat = pack_bank(self.bank, self.counts)

    def trace(self, rays: ray_mod.RayBatch, any_hit: bool = False):
        """(t [N], global prim id [N] int32), inf / -1 on a miss: K1 and K5
        on CUDA tensors, their plain versions on CPU tensors. Each family
        takes the hit so far and returns it merged with its own."""
        cpu = _device_kind(rays) == "cpu"
        planes = None if cpu else ray_mod.to_planes(rays)
        if not self.flat_rows:
            t = idx = None
        elif cpu:
            t, idx = trace_reference(self.bank, self.counts, rays)
        else:
            t, idx = trace_planes(self.flat, planes, any_hit)
        for fam in self.families:
            t, idx = (treelet.trace_reference(fam, rays, t, idx) if cpu else
                      treelet.trace_planes(fam, planes, any_hit, t, idx))
        if t is None:
            n = rays.origin.shape[0]
            t = torch.full((n,), INF, device=rays.origin.device)
            idx = torch.full((n,), -1, dtype=torch.int32,
                             device=rays.origin.device)
        return t, idx

    def occluded(self, rays: ray_mod.RayBatch):
        return torch.isfinite(self.trace(rays, any_hit=True)[0])
