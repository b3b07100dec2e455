"""Typed primitive tables: the device-resident scene geometry.
Mirrors pbrs_tpu/shapes/tables.py.

Instance transforms are baked into world-space primitives grouped by
type: spheres, quads (cuboids become 6 quads), triangles (meshes become
one triangle per face) and disks, each
with a per-primitive material id. Built in NumPy on the host; `.to(device)`
moves every table at once.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass

import numpy as np
import torch

SPHERE, QUAD, TRIANGLE, DISK = 0, 1, 2, 3

log = logging.getLogger(__name__)


def _is_similarity(m3, tol=1e-4):
    """True when the linear part is rotation x uniform scale."""
    mtm = m3.T @ m3
    s2 = np.trace(mtm) / 3.0
    return bool(np.allclose(mtm, s2 * np.eye(3), atol=tol * max(s2, 1.0)))


@dataclass
class GeometryTables:
    sph_center: torch.Tensor  # [S,3]
    sph_radius: torch.Tensor  # [S]
    sph_mat: torch.Tensor  # [S] int32
    quad_origin: torch.Tensor  # [Q,3]
    quad_u: torch.Tensor  # [Q,3]
    quad_v: torch.Tensor  # [Q,3]
    quad_mat: torch.Tensor  # [Q] int32
    tri_p0: torch.Tensor  # [T,3]
    tri_p1: torch.Tensor  # [T,3]
    tri_p2: torch.Tensor  # [T,3]
    tri_n0: torch.Tensor  # [T,3] shading normals
    tri_n1: torch.Tensor  # [T,3]
    tri_n2: torch.Tensor  # [T,3]
    tri_uv0: torch.Tensor  # [T,2]
    tri_uv1: torch.Tensor  # [T,2]
    tri_uv2: torch.Tensor  # [T,2]
    tri_mat: torch.Tensor  # [T] int32
    disk_center: torch.Tensor  # [D,3]
    disk_normal: torch.Tensor  # [D,3]
    disk_radial: torch.Tensor  # [D,3]
    disk_mat: torch.Tensor  # [D] int32

    def to(self, device) -> "GeometryTables":
        return GeometryTables(**{f.name: getattr(self, f.name).to(device)
                                 for f in dataclasses.fields(self)})

    @property
    def counts(self):
        return (self.sph_center.shape[0], self.quad_origin.shape[0],
                self.tri_p0.shape[0], self.disk_center.shape[0])


class GeometryBuilder:
    """Host-side accumulator; `build()` pads each table to at least one
    never-hit dummy primitive so every table is non-empty."""

    def __init__(self):
        self.spheres = []  # (center, radius, mat)
        self.quads = []  # (origin, u, v, mat)
        self.tris = []  # (p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, mat)
        self.disks = []  # (center, normal, radial, mat)

    def add_sphere(self, center, radius, mat: int, transform=None):
        center = np.asarray(center, np.float32)
        radius = float(radius)
        if transform is not None:
            m = np.asarray(transform, np.float64)
            if not _is_similarity(m[:3, :3]):
                log.warning(
                    "add_sphere: non-similarity transform approximated by "
                    "uniform cbrt(|det|) scale")
            scale = np.cbrt(abs(np.linalg.det(m[:3, :3])))
            center = (m[:3, :3] @ center + m[:3, 3]).astype(np.float32)
            radius *= float(scale)
        self.spheres.append((center, radius, mat))

    def add_quad(self, origin, edge_u, edge_v, mat: int, transform=None):
        origin = np.asarray(origin, np.float32)
        edge_u = np.asarray(edge_u, np.float32)
        edge_v = np.asarray(edge_v, np.float32)
        if transform is not None:
            m = np.asarray(transform, np.float32)
            origin = m[:3, :3] @ origin + m[:3, 3]
            edge_u = m[:3, :3] @ edge_u
            edge_v = m[:3, :3] @ edge_v
        self.quads.append((origin, edge_u, edge_v, mat))

    def add_cuboid(self, pmin, pmax, mat: int, transform=None):
        """An AABB as 6 outward-facing quads, then the transform baked."""
        lo = np.minimum(np.asarray(pmin, np.float32),
                        np.asarray(pmax, np.float32))
        hi = np.maximum(np.asarray(pmin, np.float32),
                        np.asarray(pmax, np.float32))
        d = hi - lo
        ex = np.array([d[0], 0, 0], np.float32)
        ey = np.array([0, d[1], 0], np.float32)
        ez = np.array([0, 0, d[2]], np.float32)
        faces = [
            (lo, ez, ey),  # x = lo: normal -x
            (lo + ex, ey, ez),  # x = hi: normal +x
            (lo, ex, ez),  # y = lo: normal -y
            (lo + ey, ez, ex),  # y = hi: normal +y
            (lo, ey, ex),  # z = lo: normal -z
            (lo + ez, ex, ey),  # z = hi: normal +z
        ]
        for origin, u, v in faces:
            self.add_quad(origin, u, v, mat, transform)

    def add_triangle(self, p0, p1, p2, mat: int, normals=None, uvs=None,
                     transform=None):
        p = [np.asarray(x, np.float32) for x in (p0, p1, p2)]
        if transform is not None:
            m = np.asarray(transform, np.float32)
            p = [m[:3, :3] @ x + m[:3, 3] for x in p]
        geo_n = np.cross(p[0] - p[1], p[2] - p[1])
        nrm = np.linalg.norm(geo_n)
        geo_n = geo_n / nrm if nrm > 0 else np.array([0, 0, 1], np.float32)
        if normals is None:
            n = [geo_n] * 3
        else:
            n = [np.asarray(x, np.float32) for x in normals]
            if transform is not None:
                it = np.linalg.inv(np.asarray(transform, np.float64)[:3, :3]).T
                n = [(it @ x / max(np.linalg.norm(it @ x), 1e-20)
                      ).astype(np.float32) for x in n]
        if uvs is None:
            uvs = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)]
        uv = [np.asarray(x, np.float32) for x in uvs]
        self.tris.append((*p, *n, *uv, mat))

    def add_mesh(self, positions, indices, mat: int, normals=None, uvs=None,
                 transform=None):
        """An indexed triangle soup, one add_triangle per face with its
        vertices' normals and uvs (families above the trace threshold go to
        the BVH tracer, accel/treelet.py)."""
        positions = np.asarray(positions, np.float32)
        normals = None if normals is None else np.asarray(normals, np.float32)
        uvs = None if uvs is None else np.asarray(uvs, np.float32)
        for (i, j, k) in np.asarray(indices, np.int64):
            self.add_triangle(
                positions[i], positions[j], positions[k], mat,
                normals=None if normals is None else (
                    normals[i], normals[j], normals[k]),
                uvs=None if uvs is None else (uvs[i], uvs[j], uvs[k]),
                transform=transform)

    def add_disk(self, center, normal, radial, mat: int, transform=None):
        center = np.asarray(center, np.float32)
        normal = np.asarray(normal, np.float32)
        radial = np.asarray(radial, np.float32)
        if transform is not None:
            m = np.asarray(transform, np.float64)
            if not _is_similarity(m[:3, :3]):
                log.warning("add_disk: non-similarity transform; radius uses "
                            "|M.radial|")
            center = (m[:3, :3] @ center + m[:3, 3]).astype(np.float32)
            it = np.linalg.inv(m[:3, :3]).T
            normal = (it @ normal).astype(np.float32)
            radial = (m[:3, :3] @ radial).astype(np.float32)
        normal = normal / max(np.linalg.norm(normal), 1e-20)
        self.disks.append((center, normal, radial, mat))

    def build(self) -> GeometryTables:
        far = 3.0e37

        def stack(rows, cols, dummies):
            if rows:
                return [np.stack([np.asarray(r[i], np.float32) for r in rows])
                        for i in cols]
            return [np.asarray(d, np.float32)[None] for d in dummies]

        def mats(rows, i):
            return (np.array([r[i] for r in rows], np.int32) if rows
                    else np.zeros(1, np.int32))

        sph = stack(self.spheres, range(2), [np.array([far] * 3), 0.0])
        quad = stack(self.quads, range(3),
                     [np.array([far] * 3), np.zeros(3), np.zeros(3)])
        tri = stack(self.tris, range(9),
                    [np.array([far] * 3)] * 3 + [np.array([0, 0, 1.0])] * 3
                    + [np.zeros(2)] * 3)
        disk = stack(self.disks, range(3),
                     [np.array([far] * 3), np.array([0, 0, 1.0]), np.zeros(3)])
        t = torch.from_numpy
        return GeometryTables(
            sph_center=t(sph[0]), sph_radius=t(sph[1]),
            sph_mat=t(mats(self.spheres, 2)),
            quad_origin=t(quad[0]), quad_u=t(quad[1]), quad_v=t(quad[2]),
            quad_mat=t(mats(self.quads, 3)),
            tri_p0=t(tri[0]), tri_p1=t(tri[1]), tri_p2=t(tri[2]),
            tri_n0=t(tri[3]), tri_n1=t(tri[4]), tri_n2=t(tri[5]),
            tri_uv0=t(tri[6]), tri_uv1=t(tri[7]), tri_uv2=t(tri[8]),
            tri_mat=t(mats(self.tris, 9)),
            disk_center=t(disk[0]), disk_normal=t(disk[1]),
            disk_radial=t(disk[2]), disk_mat=t(mats(self.disks, 3)),
        )
