"""Scene buffers: the full scene as one dataclass. Mirrors
pbrs_tpu/scene/buffers.py, trace-time instance groups included.

The scene is built in NumPy on the host and moved with one
``scene.to(device)``, so one builder serves the CPU tests and the card.
``scene_from_arrays`` / ``scene_to_arrays`` carry a scene across as a flat
dict of NumPy arrays, keyed by dotted field paths ("geom.quad_u", ...):
every key of ARRAY_KEYS, plus "env.dist.<field>" for an image
environment's sampling distribution and "instanced.<i>.<field>" for each
instance group (its master's geometry fields and its transforms).
``scene_to_arrays`` reads any object with the same field names, so it also
takes a scene of the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.camera import Camera
from ..accel import instanced as inst_mod
from ..lights import env_sampling as es
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
    # Trace-time instance groups (accel/instanced.py): master geometry
    # stored once + per-instance transforms.
    instanced: tuple = ()

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
                       for f in dataclasses.fields(self)
                       if f.name != "instanced"),
                     instanced=tuple(g.to(device) for g in self.instanced))


# Field paths carried by scene_from_arrays / scene_to_arrays. The static
# fields (counts, kinds, sizes) are Python ints, carried as 0-d arrays.
_TENSOR_FIELDS = {
    "geom": [f.name for f in dataclasses.fields(GeometryTables)],
    "materials": ["kind", "albedo", "specular", "alpha", "distrib",
                  "fr_kind", "eta", "eta_t", "k", "tex_id", "emission"],
    "textures": ["kind", "color_a", "color_b", "freq", "img_offset",
                 "img_w", "img_h", "atlas"],
    "delta_lights": ["kind", "position", "color", "world_radius"],
    "area_lights": ["shape_kind", "emit", "p0", "p1", "p2", "scalar"],
    "env": ["color_a", "color_b", "image", "scale"],
    "camera": ["center", "a", "b", "c", "orientation"],
}
_INT_FIELDS = ["delta_lights.count", "area_lights.count", "env.kind",
               "camera.width", "camera.height"]
ARRAY_KEYS = tuple(f"{g}.{n}" for g, ns in _TENSOR_FIELDS.items()
                   for n in ns) + tuple(_INT_FIELDS)


_DIST_FIELDS = ("marginal_cdf", "conditional_cdf", "pdf_img", "alias_packed")
_GROUP_FIELDS = ("fwd", "inv", "inv_t", "bbox_lo", "bbox_hi")


def _np(v):
    return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v))


def scene_to_arrays(scene) -> dict:
    """{dotted field path: np.ndarray}: every key of ARRAY_KEYS, the env
    distribution's fields and every instance group's fields."""
    out = {}
    for key in ARRAY_KEYS:
        group, name = key.split(".")
        out[key] = _np(getattr(getattr(scene, group), name))
    dist = getattr(scene.env, "dist", None)
    if dist is not None:
        for name in _DIST_FIELDS:
            out[f"env.dist.{name}"] = _np(getattr(dist, name))
    for i, grp in enumerate(getattr(scene, "instanced", ())):
        for name in _TENSOR_FIELDS["geom"]:
            out[f"instanced.{i}.geom.{name}"] = _np(getattr(grp.geom, name))
        for name in _GROUP_FIELDS:
            out[f"instanced.{i}.{name}"] = _np(getattr(grp, name))
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
    env = EnvLight(kind=i["env.kind"], **g("env"))
    if "env.dist.pdf_img" in d:
        env.dist = es.EnvDistribution(
            **{n: torch.from_numpy(np.array(d[f"env.dist.{n}"]))
               for n in _DIST_FIELDS},
            image=env.image.clone(), scale=env.scale.clone())
    groups = []
    while f"instanced.{len(groups)}.fwd" in d:
        pre = f"instanced.{len(groups)}."
        groups.append(inst_mod.InstanceGroup(
            geom=GeometryTables(**{
                n: torch.from_numpy(np.array(d[f"{pre}geom.{n}"]))
                for n in _TENSOR_FIELDS["geom"]}),
            **{n: torch.from_numpy(np.array(d[pre + n]))
               for n in _GROUP_FIELDS}))
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
        env=env,
        camera=Camera(**g("camera"), width=i["camera.width"],
                      height=i["camera.height"]),
        instanced=tuple(groups),
    )


class SceneBuilder:
    """Aggregates the host-side builders and finalizes a Scene."""

    def __init__(self):
        self.geometry = GeometryBuilder()
        self.materials = MaterialBuilder()
        self.textures = TextureBuilder()
        self.lights = LightsBuilder()
        self.camera: Camera | None = None
        # (master GeometryBuilder, [4x4 object->world transforms])
        self.instanced: list[tuple[GeometryBuilder, list]] = []

    def add_instance_group(self, master: GeometryBuilder, transforms):
        """A trace-time instance group: `master` holds object-space
        geometry stored once; `transforms` are 4x4 object->world matrices,
        one per instance (any affine)."""
        self.instanced.append((master, [np.asarray(t, np.float64)
                                        for t in transforms]))

    @staticmethod
    def _builder_bound(geometry: GeometryBuilder):
        """Conservative AABB of one GeometryBuilder's primitives."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)

        def grow(points):
            nonlocal lo, hi
            pts = np.atleast_2d(np.asarray(points, np.float64))
            lo = np.minimum(lo, pts.min(axis=0))
            hi = np.maximum(hi, pts.max(axis=0))

        for c, r, _ in geometry.spheres:
            grow([np.asarray(c) - r, np.asarray(c) + r])
        for o, u, v, _ in geometry.quads:
            grow([o, o + u, o + v, o + u + v])
        for t in geometry.tris:
            grow([t[0], t[1], t[2]])
        for c, _, r, _ in geometry.disks:
            rad = np.linalg.norm(r)
            grow([np.asarray(c) - rad, np.asarray(c) + rad])
        return lo, hi

    def world_bound(self):
        """Conservative scene AABB of the accumulated primitives and the
        transformed bounds of the instance groups."""
        lo, hi = self._builder_bound(self.geometry)
        for master, tfs in self.instanced:
            mlo, mhi = self._builder_bound(master)
            if not np.all(np.isfinite(mlo)):
                continue
            corners = np.stack(
                [np.array([[mlo, mhi][ix][0], [mlo, mhi][iy][1],
                           [mlo, mhi][iz][2]])
                 for ix in (0, 1) for iy in (0, 1) for iz in (0, 1)])
            for t in tfs:
                wc = corners @ np.asarray(t)[:3, :3].T + np.asarray(t)[:3, 3]
                lo = np.minimum(lo, wc.min(axis=0))
                hi = np.maximum(hi, wc.max(axis=0))
        if not np.all(np.isfinite(lo)):
            lo, hi = -np.ones(3), np.ones(3)
        return lo, hi

    def build(self) -> Scene:
        lo, hi = self.world_bound()
        # Distant lights are placed outside the scene bound.
        self.lights.world_radius = float(np.linalg.norm(hi - lo) * 0.5
                                         + 1e-3)
        delta, area, env = self.lights.build()
        groups = tuple(
            inst_mod.make_group(master.build(), np.stack(tfs),
                                self._builder_bound(master))
            for master, tfs in self.instanced)
        return Scene(geom=self.geometry.build(),
                     materials=self.materials.build(),
                     textures=self.textures.build(), delta_lights=delta,
                     area_lights=area, env=env, camera=self.camera,
                     instanced=groups)
