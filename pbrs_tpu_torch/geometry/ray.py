"""SoA ray batches. Mirrors pbrs_tpu/geometry/ray.py."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# t below this is rejected as a self-intersection; t >= t_max is out of
# extent.
T_MIN = 1.19209290e-07
# Offset along the normal when spawning secondary rays.
SPAWN_EPS = 1e-3


@dataclass
class RayBatch:
    origin: torch.Tensor  # [N, 3]
    dir: torch.Tensor  # [N, 3]
    t_max: torch.Tensor  # [N]

    @property
    def n(self):
        return self.origin.shape[0]

    def replace(self, **kw) -> "RayBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "RayBatch":
        return RayBatch(self.origin.to(device), self.dir.to(device),
                        self.t_max.to(device))


def make_rays(origin, dir, t_max=None):
    origin = torch.as_tensor(origin, dtype=torch.float32)
    dir = torch.as_tensor(dir, dtype=torch.float32, device=origin.device)
    if t_max is None:
        t_max = torch.full(origin.shape[:-1], float("inf"),
                           dtype=torch.float32, device=origin.device)
    return RayBatch(origin=origin, dir=dir,
                    t_max=torch.as_tensor(t_max, dtype=torch.float32,
                                          device=origin.device))


def to_planes(rays: RayBatch):
    """SoA ray planes [7, N] (ox, oy, oz, dx, dy, dz, t_max), the layout the
    trace kernels read."""
    o, d = rays.origin, rays.dir
    return torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                        rays.t_max]).contiguous()


def position_at(rays: RayBatch, t):
    return rays.origin + t[..., None] * rays.dir


def spawn(pos, normal, dir):
    """Secondary ray offset SPAWN_EPS along the side of `normal` that `dir`
    points to."""
    side = torch.sign((dir * normal).sum(dim=-1, keepdim=True))
    side = torch.where(side == 0.0, 1.0, side)
    return make_rays(pos + side * normal * SPAWN_EPS, dir)


def spawn_limited_to(pos, normal, target):
    """Shadow ray from pos to target, t_max = 1 - 1e-3 (t=1 is the target)."""
    r = spawn(pos, normal, target - pos)
    return r.replace(t_max=torch.full_like(r.t_max, 1.0 - 1e-3))
