"""Perspective pinhole camera. Mirrors pbrs_tpu/geometry/camera.py.

Left-handed basis: x right, y up, z forward, film y flipped.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import ray as ray_mod


@dataclass
class Camera:
    center: torch.Tensor  # [3]
    a: torch.Tensor  # [3] per-column film step (pre-orientation)
    b: torch.Tensor  # [3] per-row film step (pre-orientation, y flipped)
    c: torch.Tensor  # [3] top-left film corner direction (pre-orientation)
    orientation: torch.Tensor  # [3,3] columns = (right, up, forward)
    width: int = 800
    height: int = 800

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Camera":
        return self.replace(
            center=self.center.to(device), a=self.a.to(device),
            b=self.b.to(device), c=self.c.to(device),
            orientation=self.orientation.to(device))


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def make_camera(resolution, fov_y_deg: float) -> Camera:
    width, height = resolution
    aspect = width / height
    half_v = math.tan(math.radians(fov_y_deg) * 0.5)
    half_h = half_v * aspect
    return Camera(
        center=torch.zeros(3, dtype=torch.float32),
        a=_f32([half_h / (width // 2), 0.0, 0.0]),
        b=_f32([0.0, -half_v / (height // 2), 0.0]),
        c=_f32([-half_h, half_v, 1.0]),
        orientation=torch.eye(3, dtype=torch.float32),
        width=width, height=height,
    )


def looking_at(cam: Camera, from_pos, target, up) -> Camera:
    from_pos = np.asarray(from_pos, np.float32)
    forward = np.asarray(target, np.float32) - from_pos
    forward = forward / np.linalg.norm(forward)
    right = np.cross(np.asarray(up, np.float32), forward)
    right = right / np.linalg.norm(right)
    up_adj = np.cross(forward, right)
    orient = np.stack([right, up_adj, forward], axis=1)  # columns
    return cam.replace(center=_f32(from_pos).to(cam.center.device),
                       orientation=_f32(orient).to(cam.center.device))


def shoot_rays(cam: Camera, row, col, jitter_xy) -> ray_mod.RayBatch:
    """One ray per (row, col, jitter): dir = R @ (c + a*(col+dx) +
    b*(row+dy)), unnormalized; t is the parameter along it."""
    x = col.to(torch.float32) + jitter_xy[..., 0]
    y = row.to(torch.float32) + jitter_xy[..., 1]
    d_local = (cam.c[None, :] + cam.a[None, :] * x[..., None]
               + cam.b[None, :] * y[..., None])
    d_world = d_local @ cam.orientation.T
    origin = cam.center.expand_as(d_world)
    return ray_mod.make_rays(origin, d_world)


def pixel_coords(cam: Camera, pixel_idx):
    """Flat pixel index -> (row, col)."""
    return pixel_idx // cam.width, pixel_idx % cam.width
