"""Scene buffers: the full scene as one dataclass. Mirrors
pbrs_tpu/scene/buffers.py (trace-time instance groups are not ported
yet).

The scene is built in NumPy on the host and moved with one
``scene.to(device)``, so one builder serves the CPU tests and the card.
``scene_from_arrays`` / ``scene_to_arrays`` carry a scene across as a flat
dict of NumPy arrays, keyed by dotted field paths ("geom.quad_u", ...).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.camera import Camera
from ..lights import lights as lt
from ..lights.lights import AreaLights, DeltaLights, EnvLight, LightsBuilder
from ..materials.table import MaterialBuilder, MaterialTable
from ..shapes.tables import GeometryBuilder, GeometryTables
from ..textures.textures import TextureBuilder, TextureTable


@dataclass
class Scene:
    geom: GeometryTables
    materials: MaterialTable
    textures: TextureTable
    delta_lights: DeltaLights
    area_lights: AreaLights
    env: EnvLight
    camera: Camera

    @property
    def num_lights(self) -> int:
        """Uniform light-pick denominator."""
        return (self.delta_lights.count + self.area_lights.count
                + (1 if self.env.kind != lt.ENV_NONE else 0))

    @property
    def device(self):
        return self.geom.quad_origin.device

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Scene":
        return Scene(*(getattr(self, f.name).to(device)
                       for f in dataclasses.fields(self)))


# Field paths carried by scene_from_arrays / scene_to_arrays. The static
# fields (counts, kinds, sizes) are Python ints, carried as 0-d arrays.
_TENSOR_FIELDS = {
    "geom": [f.name for f in dataclasses.fields(GeometryTables)],
    "materials": ["kind", "albedo", "specular", "alpha", "distrib",
                  "fr_kind", "eta", "eta_t", "k", "tex_id", "emission"],
    "textures": ["kind", "color_a", "color_b", "freq"],
    "delta_lights": ["kind", "position", "color", "world_radius"],
    "area_lights": ["shape_kind", "emit", "p0", "p1", "p2", "scalar"],
    "env": ["color_a", "color_b"],
    "camera": ["center", "a", "b", "c", "orientation"],
}
_INT_FIELDS = ["delta_lights.count", "area_lights.count", "env.kind",
               "camera.width", "camera.height"]
ARRAY_KEYS = tuple(f"{g}.{n}" for g, ns in _TENSOR_FIELDS.items()
                   for n in ns) + tuple(_INT_FIELDS)


def scene_to_arrays(scene: Scene) -> dict:
    """{dotted field path: np.ndarray} for every field in ARRAY_KEYS."""
    out = {}
    for key in ARRAY_KEYS:
        group, name = key.split(".")
        v = getattr(getattr(scene, group), name)
        out[key] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v))
    return out


def scene_from_arrays(d: dict) -> Scene:
    """Build a Scene (on the CPU) from {dotted field path: np.ndarray}."""
    missing = [k for k in ARRAY_KEYS if k not in d]
    if missing:
        raise KeyError(f"scene_from_arrays: missing {missing}")
    t = {k: torch.from_numpy(np.array(d[k])) for k in ARRAY_KEYS
         if k not in _INT_FIELDS}
    i = {k: int(np.asarray(d[k])) for k in _INT_FIELDS}
    g = lambda group: {n: t[f"{group}.{n}"]  # noqa: E731
                       for n in _TENSOR_FIELDS[group]}
    mkind = g("materials")["kind"].numpy()
    tex = g("materials")["tex_id"].numpy()
    n_area = i["area_lights.count"]
    shapes = tuple(sorted({int(k) for k in
                           t["area_lights.shape_kind"].numpy()[:n_area]}))
    return Scene(
        geom=GeometryTables(**g("geom")),
        materials=MaterialTable(
            **g("materials"),
            textured_slots=tuple(sorted(set(np.nonzero(tex >= 0)[1].tolist()))),
            present_kinds=tuple(sorted(set(mkind[mkind != 0].tolist())))),
        textures=TextureTable(**g("textures"), present_kinds=tuple(sorted(
            set(t["textures.kind"].tolist())))),
        delta_lights=DeltaLights(**g("delta_lights"),
                                 count=i["delta_lights.count"]),
        area_lights=AreaLights(**g("area_lights"), count=n_area,
                               present_shapes=shapes or (0,)),
        env=EnvLight(kind=i["env.kind"], **g("env")),
        camera=Camera(**g("camera"), width=i["camera.width"],
                      height=i["camera.height"]),
    )


class SceneBuilder:
    """Aggregates the host-side builders and finalizes a Scene."""

    def __init__(self):
        self.geometry = GeometryBuilder()
        self.materials = MaterialBuilder()
        self.textures = TextureBuilder()
        self.lights = LightsBuilder()
        self.camera: Camera | None = None

    def add_instance_group(self, *a, **k):
        raise NotImplementedError(
            "pbrs_tpu.scene.buffers.SceneBuilder.add_instance_group is not "
            "ported to pbrs_tpu_torch yet")

    def world_bound(self):
        """Conservative scene AABB of the accumulated primitives."""
        g = self.geometry
        pts = []
        for c, r, _ in g.spheres:
            pts += [np.asarray(c) - r, np.asarray(c) + r]
        for o, u, v, _ in g.quads:
            pts += [o, o + u, o + v, o + u + v]
        for t in g.tris:
            pts += [t[0], t[1], t[2]]
        for c, _, r, _ in g.disks:
            rad = np.linalg.norm(r)
            pts += [np.asarray(c) - rad, np.asarray(c) + rad]
        if not pts:
            return -np.ones(3), np.ones(3)
        pts = np.stack([np.asarray(p, np.float64) for p in pts])
        return pts.min(axis=0), pts.max(axis=0)

    def build(self) -> Scene:
        lo, hi = self.world_bound()
        # Distant lights are placed outside the scene bound.
        self.lights.world_radius = float(np.linalg.norm(hi - lo) * 0.5
                                         + 1e-3)
        delta, area, env = self.lights.build()
        return Scene(geom=self.geometry.build(),
                     materials=self.materials.build(),
                     textures=self.textures.build(), delta_lights=delta,
                     area_lights=area, env=env, camera=self.camera)
