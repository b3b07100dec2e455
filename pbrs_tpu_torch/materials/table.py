"""Material table: materials compiled to per-slot lobe templates.
Mirrors pbrs_tpu/materials/table.py for Lambertian materials with a solid
albedo and diffuse lights; other materials and textured slots raise
NotImplementedError until their slice is ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..bxdf import lobes as lb

MAX_LOBES = 5


def _not_ported(name):
    raise NotImplementedError(
        f"pbrs_tpu.materials.table.MaterialBuilder.{name} is not ported to "
        "pbrs_tpu_torch yet")


@dataclass
class MaterialTable:
    kind: torch.Tensor  # [M,L] int32
    albedo: torch.Tensor  # [M,L,3]
    tex_id: torch.Tensor  # [M,L] int32, -1 = solid albedo
    emission: torch.Tensor  # [M,3]
    textured_slots: tuple = ()
    present_kinds: tuple = (lb.LAMBERT,)

    @property
    def num_materials(self):
        return self.kind.shape[0]

    def to(self, device) -> "MaterialTable":
        return dataclasses.replace(
            self, kind=self.kind.to(device), albedo=self.albedo.to(device),
            tex_id=self.tex_id.to(device), emission=self.emission.to(device))


def shading_at(table: MaterialTable, mat_id):
    """(Lobes, emission) for a hit batch; mat_id < 0 (miss) gives no lobes
    and black emission."""
    if table.textured_slots:
        raise NotImplementedError(
            "pbrs_tpu.textures.textures.eval_texture (textured material "
            "slots) is not ported to pbrs_tpu_torch yet")
    lb.check_ported(table.present_kinds)
    safe = torch.clamp_min(mat_id, 0).to(torch.int64)
    hit_ok = mat_id >= 0
    kind = torch.where(hit_ok[..., None], table.kind[safe], lb.NONE)
    emission = torch.where(hit_ok[..., None], table.emission[safe], 0.0)
    return lb.Lobes(kind=kind, albedo=table.albedo[safe],
                    present_kinds=table.present_kinds), emission


def emission_of(table: MaterialTable, mat_id):
    safe = torch.clamp_min(mat_id, 0).to(torch.int64)
    return torch.where((mat_id >= 0)[..., None], table.emission[safe], 0.0)


class MaterialBuilder:
    """Host-side material compiler; `add_*` returns the material id."""

    def __init__(self):
        self.materials = []  # list[(lobes [(kind, albedo, tex_id)], emission)]

    def _add(self, lobes, emission=(0, 0, 0)) -> int:
        assert len(lobes) <= MAX_LOBES
        self.materials.append((lobes, np.asarray(emission, np.float32)))
        return len(self.materials) - 1

    def add_lambertian(self, albedo=None, tex_id: int = -1) -> int:
        if tex_id >= 0:
            raise NotImplementedError(
                "pbrs_tpu.textures.textures.eval_texture (textured albedo) "
                "is not ported to pbrs_tpu_torch yet")
        albedo = albedo if albedo is not None else (0, 0, 0)
        return self._add([(lb.LAMBERT, np.asarray(albedo, np.float32), -1)])

    def add_diffuse_light(self, emit) -> int:
        """No lobes; emission only."""
        return self._add([], emission=emit)

    def add_matte(self, *a, **k):
        _not_ported("add_matte")

    def add_metal(self, *a, **k):
        _not_ported("add_metal")

    def add_glossy(self, *a, **k):
        _not_ported("add_glossy")

    def add_mirror(self, *a, **k):
        _not_ported("add_mirror")

    def add_dielectric(self, *a, **k):
        _not_ported("add_dielectric")

    def add_fourier(self, *a, **k):
        _not_ported("add_fourier")

    def add_plastic(self, *a, **k):
        _not_ported("add_plastic")

    def add_substrate(self, *a, **k):
        _not_ported("add_substrate")

    def add_uber(self, *a, **k):
        _not_ported("add_uber")

    def build(self) -> MaterialTable:
        mats = self.materials or [([], np.zeros(3, np.float32))]
        m = len(mats)
        # The lobe axis is trimmed to the widest material present.
        n_lobes = max(1, max(len(lobe_list) for lobe_list, _ in mats))
        kind = np.zeros((m, n_lobes), np.int32)
        albedo = np.zeros((m, n_lobes, 3), np.float32)
        tex_id = np.full((m, n_lobes), -1, np.int32)
        emission = np.zeros((m, 3), np.float32)
        for i, (lobe_list, emit) in enumerate(mats):
            emission[i] = emit
            for l, (k, alb, tid) in enumerate(lobe_list):
                kind[i, l], albedo[i, l], tex_id[i, l] = k, alb, tid
        return MaterialTable(
            kind=torch.from_numpy(kind), albedo=torch.from_numpy(albedo),
            tex_id=torch.from_numpy(tex_id),
            emission=torch.from_numpy(emission),
            present_kinds=tuple(sorted(
                {l[0] for ll, _ in mats for l in ll})),
        )
