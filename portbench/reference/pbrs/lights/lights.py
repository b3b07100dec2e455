"""Light tables: delta lights, area lights and the environment light.
Mirrors pbrs_tpu/lights/lights.py: point/distant lights, the four area
shapes and the none/const/gradient/dusk/equirect-image environments (an
image environment carries its importance-sampling distribution,
``lights/env_sampling.py``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import vecmath as vm
from . import sample_shape as ss

# Delta light kinds
POINT = 0
DISTANT = 1

# Env light kinds
ENV_NONE = 0
ENV_CONST = 1
ENV_GRADIENT = 2  # lerp(bottom, top, (y+1)/2)
ENV_DUSK = 3
ENV_IMAGE = 4


def _to(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclass
class DeltaLights:
    kind: torch.Tensor  # [D] int32
    position: torch.Tensor  # [D,3]
    color: torch.Tensor  # [D,3]
    world_radius: torch.Tensor  # [] scalar
    count: int = 0

    def to(self, device):
        return _to(self, device)


@dataclass
class AreaLights:
    shape_kind: torch.Tensor  # [A] int32 (sample_shape kinds)
    emit: torch.Tensor  # [A,3]
    p0: torch.Tensor  # [A,3]
    p1: torch.Tensor  # [A,3]
    p2: torch.Tensor  # [A,3]
    scalar: torch.Tensor  # [A]
    count: int = 0
    present_shapes: tuple = (ss.QUAD,)

    def to(self, device):
        return _to(self, device)


@dataclass
class EnvLight:
    kind: int = ENV_NONE
    color_a: torch.Tensor = None  # top / constant
    color_b: torch.Tensor = None  # bottom
    image: torch.Tensor = None  # [H,W,3] equirect (1x1 black otherwise)
    scale: torch.Tensor = None  # [3]
    # Importance-sampling distribution (env_sampling.EnvDistribution) of an
    # image environment; None = BSDF-sampled only.
    dist: object = None

    def to(self, device):
        out = _to(self, device)
        if self.dist is not None:
            out.dist = self.dist.to(device)
        return out


def _f3(x):
    return torch.tensor(np.asarray(x, np.float32).reshape(3))


def _env(kind, color_a, color_b) -> EnvLight:
    return EnvLight(kind=kind, color_a=color_a, color_b=color_b,
                    image=torch.zeros(1, 1, 3), scale=torch.ones(3))


def make_env_gradient(top, bottom) -> EnvLight:
    return _env(ENV_GRADIENT, _f3(top), _f3(bottom))


def make_env_const(color) -> EnvLight:
    return _env(ENV_CONST, _f3(color), torch.zeros(3, dtype=torch.float32))


def make_env_none() -> EnvLight:
    return _env(ENV_NONE, torch.zeros(3, dtype=torch.float32),
                torch.zeros(3, dtype=torch.float32))


def make_env_dusk() -> EnvLight:
    """Dome over an orange horizon band."""
    horizon = torch.tensor([245, 174, 82], dtype=torch.float32) / 255.0
    dome = torch.tensor([109, 150, 204], dtype=torch.float32) / 255.0
    return _env(ENV_DUSK, dome, horizon)


def make_env_image(image_hw3, scale=(1.0, 1.0, 1.0),
                   importance: bool = True) -> EnvLight:
    """Equirect image environment; `importance` builds its sampling
    distribution (the env arm of NEE then samples it)."""
    from . import env_sampling as es

    img = np.asarray(image_hw3, np.float32)
    return EnvLight(
        kind=ENV_IMAGE, color_a=torch.zeros(3), color_b=torch.zeros(3),
        image=torch.from_numpy(img.copy()), scale=_f3(scale),
        dist=es.build_distribution(img, scale) if importance else None)


def equirect_texel(d, h, w):
    """(row, col, theta) of the equirect texel along unit directions d
    [N,3]: phi = atan2(z, x), theta = acos(y) from +y."""
    phi = torch.atan2(d[..., 2], d[..., 0])
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    u = torch.remainder(phi / (2.0 * math.pi) + 0.5, 1.0)
    v = theta / math.pi
    col = torch.clamp((u * w).to(torch.int32), 0, w - 1)
    row = torch.clamp((v * h).to(torch.int32), 0, h - 1)
    return row.to(torch.int64), col.to(torch.int64), theta


def eval_env(env: EnvLight, directions):
    """Environment radiance along ray directions [N,3] -> [N,3]."""
    if env.kind == ENV_NONE:
        return torch.zeros_like(directions)
    if env.kind == ENV_CONST:
        return env.color_a.expand_as(directions)
    d = vm.normalize(directions)
    if env.kind == ENV_GRADIENT:
        y = (d[..., 1:2] + 1.0) * 0.5
        return env.color_a * y + env.color_b * (1.0 - y)
    if env.kind == ENV_DUSK:
        tilt = torch.arccos(torch.clamp(d[..., 1:2], -1.0, 1.0))
        t = tilt / (math.pi * 0.25)
        mid = env.color_a * t + env.color_b * (1.0 - t)
        out = torch.where(tilt > math.pi * 0.25, env.color_a, mid)
        return torch.where(tilt <= 0.0, 0.2, out)
    # ENV_IMAGE: the nearest equirect texel.
    row, col, _ = equirect_texel(d, env.image.shape[0], env.image.shape[1])
    return env.image[row, col] * env.scale


def area_rows(lights: AreaLights, idx):
    """Gather (shape_kind, emit, params) of the chosen area lights."""
    i = idx.to(torch.int64)
    params = {"p0": lights.p0[i], "p1": lights.p1[i], "p2": lights.p2[i],
              "scalar": lights.scalar[i]}
    return lights.shape_kind[i], lights.emit[i], params


def sample_delta(lights: DeltaLights, idx, hit_pos):
    """Incident radiance from a chosen delta light: (radiance [N,3], wi
    unit [N,3], vis_target [N,3]); the shadow segment is hit_pos ->
    vis_target."""
    i = idx.to(torch.int64)
    kind, p, c = lights.kind[i], lights.position[i], lights.color[i]
    to_l = p - hit_pos
    d2 = torch.clamp_min(vm.dot(to_l, to_l), 1e-30)
    rad_point = c / d2[..., None]
    wi_point = vm.normalize(to_l)
    # A distant light's position holds its casting direction.
    wi_dist = vm.normalize(-p)
    outside = hit_pos - 2.0 * lights.world_radius * p
    k3 = kind[..., None] == POINT
    return (torch.where(k3, rad_point, c), torch.where(k3, wi_point, wi_dist),
            torch.where(k3, p, outside))


def sample_area(lights: AreaLights, idx, hit_pos, u2):
    """Sample incident radiance from a chosen area light.
    Returns (radiance [N,3], wi unit [N,3], pdf [N], point_on_light [N,3])."""
    kind, emit, params = area_rows(lights, idx)
    pt, n_l = ss.sample_towards(kind, params, hit_pos, u2,
                                present=lights.present_shapes)
    wi = vm.normalize(pt - hit_pos)
    # One-sided emission: radiance only if the light's front faces us.
    facing = vm.dot(n_l, -wi) > 0.0
    radiance = torch.where(facing[..., None], emit, 0.0)
    pdf = ss.pdf_at(kind, params, hit_pos, wi, present=lights.present_shapes)
    return radiance, wi, pdf, pt


def area_radiance_to(lights: AreaLights, idx, hit_pos, wi):
    """BSDF-sampled MIS arm: does direction wi hit the chosen light, and at
    what pdf? Returns (radiance [N,3], pdf [N], hit_mask [N], point [N,3])."""
    kind, emit, params = area_rows(lights, idx)
    wi_n = vm.normalize(wi)
    ok, t, _ = ss.intersect_shape(kind, params, hit_pos, wi_n,
                                  present=lights.present_shapes)
    pdf = ss.pdf_at(kind, params, hit_pos, wi_n,
                    present=lights.present_shapes)
    pt = hit_pos + t[..., None] * wi_n
    radiance = torch.where(ok[..., None], emit, 0.0)
    return radiance, pdf, ok, pt


class LightsBuilder:
    """Host-side accumulator for scene lights."""

    def __init__(self):
        self.delta = []  # (kind, position/dir, color)
        self.area = []  # (shape_kind, emit, p0, p1, p2, scalar)
        self.env = make_env_none()
        self.world_radius = 1.0

    def add_point(self, position, intensity):
        self.delta.append((POINT, np.asarray(position, np.float32),
                           np.asarray(intensity, np.float32)))

    def add_distant(self, casting_dir, radiance):
        self.delta.append((DISTANT, np.asarray(casting_dir, np.float32),
                           np.asarray(radiance, np.float32)))

    def add_area_quad(self, emit, origin, edge_u, edge_v):
        self.area.append((ss.QUAD, emit, origin, edge_u, edge_v, 0.0))

    def add_area_sphere(self, emit, center, radius):
        self.area.append((ss.SPHERE, emit, center, (0, 0, 1), (0, 0, 0),
                          float(radius)))

    def add_area_disk(self, emit, center, normal, radial):
        self.area.append((ss.DISK, emit, center, normal, radial, 0.0))

    def add_area_triangle(self, emit, p0, p1, p2):
        self.area.append((ss.TRIANGLE, emit, p0, p1, p2, 0.0))

    def build(self):
        t = torch.from_numpy
        if self.delta:
            delta = DeltaLights(
                kind=t(np.asarray([d[0] for d in self.delta], np.int32)),
                position=t(np.stack([d[1] for d in self.delta])),
                color=t(np.stack([d[2] for d in self.delta])),
                world_radius=torch.tensor(self.world_radius,
                                          dtype=torch.float32),
                count=len(self.delta))
        else:
            # The empty table (world radius 1, as the JAX package's).
            delta = DeltaLights(
                kind=torch.zeros(1, dtype=torch.int32),
                position=torch.zeros(1, 3), color=torch.zeros(1, 3),
                world_radius=torch.tensor(1.0), count=0)
        if self.area:
            f3 = lambda i: np.stack(  # noqa: E731
                [np.asarray(a[i], np.float32).reshape(3) for a in self.area])
            kind = np.asarray([a[0] for a in self.area], np.int32)
            area = AreaLights(
                shape_kind=t(kind), emit=t(f3(1)), p0=t(f3(2)),
                p1=t(f3(3)), p2=t(f3(4)),
                scalar=t(np.asarray([float(a[5]) for a in self.area],
                                    np.float32)),
                count=len(self.area),
                present_shapes=tuple(sorted({int(k) for k in kind})))
        else:
            area = AreaLights(
                shape_kind=torch.zeros(1, dtype=torch.int32),
                emit=torch.zeros(1, 3), p0=torch.zeros(1, 3),
                p1=torch.tensor([[1.0, 0.0, 0.0]]),
                p2=torch.tensor([[0.0, 1.0, 0.0]]), scalar=torch.ones(1),
                count=0)
        return delta, area, self.env
