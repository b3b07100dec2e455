"""Host-side BVH builder (binned SAH, skip-link flattening). A copy of
pbrs_tpu/accel/bvh.py; `FlatBVH.builder` says which builder made a tree.

Replaces the reference's recursive per-mesh BVH build
(reference shape/src/blas.rs:333-420: leaf <= 4 prims, max-extent axis,
area-balanced pivot) with a binned-SAH build producing *flat arrays* for
device traversal:

* depth-first node order; an interior node's left child is `node + 1`
* `skip[node]` = index of the next node after the whole subtree (the
  "miss link" of threaded traversal — no stack needed)
* leaves reference a contiguous range of the permuted primitive order

The right child of an interior node i is skip[i + 1] (the left child's
miss link) under both builders; the native one also stores it in first[i].
csrc/trace_bvh.cu walks the tree per ray with a stack (accel/treelet.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_LEAF = 8
N_BINS = 16


@dataclass
class FlatBVH:
    bbox_min: np.ndarray  # [NN,3] f32
    bbox_max: np.ndarray  # [NN,3] f32
    is_leaf: np.ndarray  # [NN] i32
    first: np.ndarray  # [NN] i32 leaf: offset into prim_order
    count: np.ndarray  # [NN] i32 leaf: prim count
    skip: np.ndarray  # [NN] i32 next node after this subtree
    prim_order: np.ndarray  # [P] i32 permutation of primitive indices
    depth: int = 0
    builder: str = "numpy"  # "native" (native/pbrs_host.cpp) or "numpy"


def build_bvh(prim_bbox_min, prim_bbox_max, max_leaf=MAX_LEAF,
              use_native=True) -> FlatBVH:
    """Binned-SAH BVH over primitive AABBs.

    Delegates to the C++ builder (native/pbrs_host.cpp) when it compiles;
    the NumPy implementation below is the reference/fallback."""
    if use_native:
        from . import native

        built = native.build_bvh_native(prim_bbox_min, prim_bbox_max, max_leaf)
        if built is not None:
            return built
    lo = np.asarray(prim_bbox_min, np.float32)
    hi = np.asarray(prim_bbox_max, np.float32)
    p = lo.shape[0]
    centroids = 0.5 * (lo + hi)
    order = np.arange(p, dtype=np.int32)

    nodes = []  # (bb_lo, bb_hi, is_leaf, first, count); skip patched later

    def emit(bb_lo, bb_hi, is_leaf, first, count):
        nodes.append([bb_lo, bb_hi, is_leaf, first, count, -1])
        return len(nodes) - 1

    max_depth = [0]

    def recurse(start, end, depth):
        max_depth[0] = max(max_depth[0], depth)
        idx = order[start:end]
        bb_lo = lo[idx].min(axis=0)
        bb_hi = hi[idx].max(axis=0)
        n = end - start
        if n <= max_leaf or depth > 60:
            return emit(bb_lo, bb_hi, 1, start, n)

        # Binned SAH on the largest centroid axis.
        c = centroids[idx]
        c_lo = c.min(axis=0)
        c_hi = c.max(axis=0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            mid = start + n // 2
        else:
            scale = N_BINS * (1.0 - 1e-6) / extent[axis]
            bins = ((c[:, axis] - c_lo[axis]) * scale).astype(np.int32)
            bins = np.clip(bins, 0, N_BINS - 1)
            # Bin bounds + counts.
            counts = np.bincount(bins, minlength=N_BINS)
            bin_lo = np.full((N_BINS, 3), np.inf, np.float32)
            bin_hi = np.full((N_BINS, 3), -np.inf, np.float32)
            for b in range(N_BINS):
                m = bins == b
                if m.any():
                    bin_lo[b] = lo[idx[m]].min(axis=0)
                    bin_hi[b] = hi[idx[m]].max(axis=0)

            def area(blo, bhi):
                d = np.maximum(bhi - blo, 0.0)
                return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

            # Prefix/suffix sweeps.
            cost = np.full(N_BINS - 1, np.inf)
            acc_lo = np.full(3, np.inf); acc_hi = np.full(3, -np.inf)
            left_area = np.zeros(N_BINS - 1)
            left_count = np.zeros(N_BINS - 1)
            cnt = 0
            for b in range(N_BINS - 1):
                if counts[b]:
                    acc_lo = np.minimum(acc_lo, bin_lo[b])
                    acc_hi = np.maximum(acc_hi, bin_hi[b])
                cnt += counts[b]
                left_area[b] = area(acc_lo, acc_hi) if cnt else 0.0
                left_count[b] = cnt
            acc_lo = np.full(3, np.inf); acc_hi = np.full(3, -np.inf)
            cnt = 0
            for b in range(N_BINS - 1, 0, -1):
                if counts[b]:
                    acc_lo = np.minimum(acc_lo, bin_lo[b])
                    acc_hi = np.maximum(acc_hi, bin_hi[b])
                cnt += counts[b]
                right_area = area(acc_lo, acc_hi) if cnt else 0.0
                cost[b - 1] = left_area[b - 1] * left_count[b - 1] + right_area * cnt
            best = int(np.argmin(cost))
            if not np.isfinite(cost[best]):
                mid = start + n // 2
            else:
                sel = bins <= best
                n_left = int(sel.sum())
                if n_left == 0 or n_left == n:
                    mid = start + n // 2
                else:
                    order[start:end] = np.concatenate([idx[sel], idx[~sel]])
                    mid = start + n_left

        me = emit(bb_lo, bb_hi, 0, 0, 0)
        recurse(start, mid, depth + 1)
        right_start = recurse(mid, end, depth + 1)
        nodes[me][3] = right_start  # reuse 'first' as right-child index
        return me

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(200000)
    try:
        recurse(0, p, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    nn = len(nodes)
    # Skip links: DFS order; subtree of node i ends where its parent's next
    # sibling begins. Compute via a stack walk.
    skip = np.full(nn, nn, np.int32)

    def assign_skip(i, after):
        skip[i] = after
        if not nodes[i][2]:  # interior
            right = nodes[i][3]
            assign_skip(i + 1, right)  # left child is i+1
            assign_skip(right, after)

    sys.setrecursionlimit(200000)
    try:
        assign_skip(0, nn)
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        bbox_min=np.stack([n[0] for n in nodes]).astype(np.float32),
        bbox_max=np.stack([n[1] for n in nodes]).astype(np.float32),
        is_leaf=np.asarray([n[2] for n in nodes], np.int32),
        first=np.asarray(
            [n[3] if n[2] else 0 for n in nodes], np.int32
        ),
        count=np.asarray([n[4] for n in nodes], np.int32),
        skip=skip,
        prim_order=order,
        depth=max_depth[0],
    )


def triangle_bboxes(p0, p1, p2):
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    return lo, hi


def validate_bvh(bvh: FlatBVH, prim_lo, prim_hi) -> bool:
    """Soundness: every leaf's prims are inside the leaf bbox (the
    reference's geometric_sound invariant, tlas/src/bvh.rs:62-71)."""
    nn = bvh.bbox_min.shape[0]
    for i in range(nn):
        if bvh.is_leaf[i]:
            prims = bvh.prim_order[bvh.first[i]:bvh.first[i] + bvh.count[i]]
            if prims.size == 0:
                continue
            if (prim_lo[prims] < bvh.bbox_min[i] - 1e-3).any():
                return False
            if (prim_hi[prims] > bvh.bbox_max[i] + 1e-3).any():
                return False
    return True
