"""Loop subdivision (host-side NumPy, runs once at scene load). A copy of
pbrs_tpu/scene/subdivision.py.

Replaces reference shape/src/subdivision.rs:76-218: even (original) vertices
are repositioned with the valence-dependent β rule, odd (edge) vertices use
the 3/8-3/8-1/8-1/8 rule; boundary edges/vertices use the 1/8-3/4-1/8 and
midpoint rules. Each triangle splits 4-way.
"""

from __future__ import annotations

import numpy as np


def _beta(valence: int) -> float:
    """Loop's β(n). [ref: shape/src/subdivision.rs:107-113]"""
    if valence == 3:
        return 3.0 / 16.0
    return 3.0 / (8.0 * valence)


def loop_subdivide_once(positions, indices):
    positions = np.asarray(positions, np.float64)
    indices = np.asarray(indices, np.int64)
    nv = positions.shape[0]

    # Edge -> (midpoint index, adjacent opposite vertices)
    edge_faces: dict[tuple, list] = {}
    for f, (a, b, c) in enumerate(indices):
        for (i, j, k) in ((a, b, c), (b, c, a), (c, a, b)):
            e = (min(i, j), max(i, j))
            edge_faces.setdefault(e, []).append(int(k))

    neighbors: dict[int, set] = {i: set() for i in range(nv)}
    boundary_nbrs: dict[int, list] = {i: [] for i in range(nv)}
    for (i, j), opp in edge_faces.items():
        neighbors[i].add(j)
        neighbors[j].add(i)
        if len(opp) == 1:  # boundary edge
            boundary_nbrs[i].append(j)
            boundary_nbrs[j].append(i)

    # Odd (edge) vertices. [ref: subdivision.rs:161-184]
    edge_index: dict[tuple, int] = {}
    new_pts = []
    for e, opp in edge_faces.items():
        i, j = e
        if len(opp) >= 2:
            p = (3.0 / 8.0) * (positions[i] + positions[j]) + (1.0 / 8.0) * (
                positions[opp[0]] + positions[opp[1]]
            )
        else:
            p = 0.5 * (positions[i] + positions[j])
        edge_index[e] = nv + len(new_pts)
        new_pts.append(p)

    # Even (original) vertices. [ref: subdivision.rs:115-158]
    even = np.empty_like(positions)
    for v in range(nv):
        if boundary_nbrs[v]:
            nb = boundary_nbrs[v]
            if len(nb) >= 2:
                even[v] = (
                    0.75 * positions[v]
                    + 0.125 * (positions[nb[0]] + positions[nb[1]])
                )
            else:
                even[v] = positions[v]
        else:
            ring = list(neighbors[v])
            n = len(ring)
            if n == 0:
                even[v] = positions[v]
                continue
            beta = _beta(n)
            even[v] = (1.0 - n * beta) * positions[v] + beta * positions[
                ring
            ].sum(axis=0)

    out_pos = np.concatenate([even, np.asarray(new_pts)], axis=0)

    # 4-way split. [ref: subdivision.rs:195-213]
    out_idx = []
    for (a, b, c) in indices:
        ab = edge_index[(min(a, b), max(a, b))]
        bc = edge_index[(min(b, c), max(b, c))]
        ca = edge_index[(min(c, a), max(c, a))]
        out_idx.extend([(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)])
    return out_pos.astype(np.float32), np.asarray(out_idx, np.int64)


def loop_subdivide(positions, indices, levels: int = 1):
    pos, idx = np.asarray(positions, np.float32), np.asarray(indices, np.int64)
    for _ in range(max(0, int(levels))):
        pos, idx = loop_subdivide_once(pos, idx)
    return pos, idx
