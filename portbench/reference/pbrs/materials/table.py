"""Material table: materials compiled to per-slot lobe templates. Mirrors
pbrs_tpu/materials/table.py: the Lambert, matte (Lambert or Oren-Nayar),
metal, glossy, mirror, dielectric, plastic, substrate (FresnelBlend), uber
and Fourier materials and textured slots. Each Fourier material brings its
own table; ``build`` stacks them into the scene's one ``fourier`` table
and a lobe's alpha[0] holds its table's index. The JAX package's packed
one-hot row layout is not ported: a hit's row is one indexed load.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..bxdf import fourier as fb
from ..bxdf import fresnel as fr
from ..bxdf import lobes as lb
from ..bxdf import microfacet as mf
from ..textures import textures as tex

MAX_LOBES = 5


@dataclass
class MaterialTable:
    kind: torch.Tensor  # [M,L] int32
    albedo: torch.Tensor  # [M,L,3]
    specular: torch.Tensor  # [M,L,3]
    alpha: torch.Tensor  # [M,L,2]
    distrib: torch.Tensor  # [M,L] int32
    fr_kind: torch.Tensor  # [M,L] int32
    eta: torch.Tensor  # [M,L,2]
    eta_t: torch.Tensor  # [M,L,3]
    k: torch.Tensor  # [M,L,3]
    tex_id: torch.Tensor  # [M,L] int32, -1 = solid albedo
    emission: torch.Tensor  # [M,3]
    fourier: object = None  # scene-level FourierTable, if any material uses it
    textured_slots: tuple = ()
    present_kinds: tuple = (lb.LAMBERT,)

    @property
    def num_materials(self):
        return self.kind.shape[0]

    def to(self, device) -> "MaterialTable":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name),
                          (torch.Tensor, fb.FourierTable))})


def shading_at(table: MaterialTable, textures: tex.TextureTable, mat_id, uv,
               pos):
    """(Lobes, emission) for a hit batch: mat_id [N], uv [N,2], pos [N,3].
    mat_id < 0 (a miss) gives no lobes and black emission."""
    safe = torch.clamp_min(mat_id, 0).to(torch.int64)
    f = {name: getattr(table, name)[safe] for name in lb.FIELDS}
    albedo = f["albedo"]
    if table.textured_slots:
        albedo = albedo.clone()
        tex_rows = table.tex_id[safe]
        for s in table.textured_slots:
            tid = tex_rows[:, s]
            value = tex.eval_texture(textures, tid, uv, pos)
            albedo[:, s, :] = torch.where((tid >= 0)[..., None], value,
                                          albedo[:, s, :])
    hit_ok = mat_id >= 0
    f["albedo"] = albedo
    f["kind"] = torch.where(hit_ok[..., None], f["kind"], lb.NONE)
    emission = torch.where(hit_ok[..., None], table.emission[safe], 0.0)
    return lb.Lobes(**f, fourier=table.fourier,
                    present_kinds=table.present_kinds), emission


def lobes_at(table, textures, mat_id, uv, pos) -> lb.Lobes:
    return shading_at(table, textures, mat_id, uv, pos)[0]


def emission_of(table: MaterialTable, mat_id):
    safe = torch.clamp_min(mat_id, 0).to(torch.int64)
    return torch.where((mat_id >= 0)[..., None], table.emission[safe], 0.0)


def _alpha(roughness) -> float:
    """roughness_to_alpha in float32, as a Python float."""
    return float(mf.roughness_to_alpha(torch.tensor(roughness,
                                                    dtype=torch.float32)))


class _Lobe:
    def __init__(self, kind, albedo=(0, 0, 0), specular=(0, 0, 0),
                 alpha=(0.0, 0.0), distrib=mf.BECKMANN, fr_kind=fr.NOP,
                 eta=(1.0, 1.5), eta_t=(1, 1, 1), k=(0, 0, 0), tex_id=-1):
        self.kind = kind
        self.albedo = np.asarray(albedo, np.float32)
        self.specular = np.asarray(specular, np.float32)
        self.alpha = np.asarray(alpha, np.float32)
        self.distrib = distrib
        self.fr_kind = fr_kind
        self.eta = np.asarray(eta, np.float32)
        self.eta_t = np.asarray(eta_t, np.float32)
        self.k = np.asarray(k, np.float32)
        self.tex_id = tex_id


class MaterialBuilder:
    """Host-side material compiler; `add_*` returns the material id."""

    def __init__(self):
        self.materials = []  # list[(lobes, emission)]
        self.fourier_tables = []

    def _add(self, lobes, emission=(0, 0, 0)) -> int:
        assert len(lobes) <= MAX_LOBES
        self.materials.append((lobes, np.asarray(emission, np.float32)))
        return len(self.materials) - 1

    def add_lambertian(self, albedo=None, tex_id: int = -1) -> int:
        return self._add([_Lobe(
            lb.LAMBERT, albedo=albedo if albedo is not None else (0, 0, 0),
            tex_id=tex_id)])

    def add_matte(self, albedo=None, sigma_deg: float = 0.0,
                  tex_id: int = -1) -> int:
        """PBRT matte: Lambert for sigma 0, else Oren-Nayar with its (A, B)
        coefficients in alpha."""
        if sigma_deg == 0.0:
            return self.add_lambertian(albedo, tex_id)
        s2 = np.radians(sigma_deg) ** 2
        a = 1.0 - s2 / (2.0 * (s2 + 0.33))
        b = 0.45 * s2 / (s2 + 0.09)
        return self._add([_Lobe(
            lb.OREN_NAYAR, albedo=albedo if albedo is not None else (0, 0, 0),
            alpha=(a, b), tex_id=tex_id)])

    def add_metal(self, eta, k, fuzz: float) -> int:
        """Conductor microfacet with a white albedo."""
        alpha = _alpha(fuzz)
        return self._add([_Lobe(lb.MICROFACET, albedo=(1, 1, 1),
                                alpha=(alpha, alpha), distrib=mf.BECKMANN,
                                fr_kind=fr.CONDUCTOR, eta_t=eta, k=k)])

    def add_glossy(self, albedo, roughness: float) -> int:
        alpha = _alpha(roughness)
        return self._add([_Lobe(lb.MICROFACET, albedo=albedo,
                                alpha=(alpha, alpha), distrib=mf.BECKMANN,
                                fr_kind=fr.NOP)])

    def add_mirror(self, albedo=(1, 1, 1)) -> int:
        return self._add([_Lobe(lb.SPEC_MIRROR, albedo=albedo,
                                fr_kind=fr.NOP)])

    def add_dielectric(self, ior: float, reflect=(1, 1, 1)) -> int:
        return self._add([_Lobe(lb.SPEC_DIELECTRIC, albedo=reflect,
                                fr_kind=fr.DIELECTRIC, eta=(1.0, ior))])

    def add_diffuse_light(self, emit) -> int:
        """No lobes; emission only."""
        return self._add([], emission=emit)

    def add_plastic(self, diffuse, specular, roughness: float,
                    remap_roughness: bool = True, kd_tex: int = -1,
                    ks_tex: int = -1) -> int:
        """Microfacet + Lambert."""
        alpha = _alpha(roughness) if remap_roughness else roughness
        return self._add([
            _Lobe(lb.MICROFACET, albedo=specular, alpha=(alpha, alpha),
                  distrib=mf.BECKMANN, fr_kind=fr.NOP, tex_id=ks_tex),
            _Lobe(lb.LAMBERT, albedo=diffuse, tex_id=kd_tex),
        ])

    def add_uber(self, kd, ks, kr=None, kt=None, roughness=0.1, eta=1.5,
                 opacity=1.0, remap_roughness=True, kd_tex=-1,
                 ks_tex=-1) -> int:
        """Up to five lobes: transmission, Lambert, microfacet, and the
        optional specular reflection and transmission."""
        lobes = []
        transmission = max(0.0, min(1.0, 1.0 - opacity))
        if transmission > 0.0:
            lobes.append(_Lobe(lb.SPEC_TRANSMIT, albedo=(transmission,) * 3,
                               fr_kind=fr.DIELECTRIC, eta=(1.0, eta)))
        lobes.append(_Lobe(lb.LAMBERT, albedo=kd, tex_id=kd_tex))
        alpha = _alpha(roughness) if remap_roughness else roughness
        lobes.append(_Lobe(lb.MICROFACET, albedo=ks, alpha=(alpha, alpha),
                           distrib=mf.BECKMANN, fr_kind=fr.DIELECTRIC,
                           eta=(1.0, eta), tex_id=ks_tex))
        if kr is not None:
            lobes.append(_Lobe(lb.SPEC_DIELECTRIC, albedo=kr,
                               fr_kind=fr.DIELECTRIC, eta=(1.0, eta)))
        if kt is not None:
            lobes.append(_Lobe(lb.SPEC_TRANSMIT, albedo=kt,
                               fr_kind=fr.DIELECTRIC, eta=(1.0, eta)))
        return self._add(lobes)

    def add_fourier(self, table) -> int:
        """Measured Fourier BSDF with its own table; the table's index rides
        in alpha[0], which the Fourier model does not read."""
        idx = len(self.fourier_tables)
        self.fourier_tables.append(table)
        return self._add([_Lobe(lb.FOURIER, alpha=(float(idx), 0.0))])

    def add_substrate(self, kd, ks, roughness: float,
                      remap_roughness: bool = True, kd_tex: int = -1) -> int:
        """FresnelBlend (Ashikhmin-Shirley) with a Trowbridge-Reitz NDF."""
        alpha = _alpha(roughness) if remap_roughness else roughness
        return self._add([_Lobe(lb.FRESNEL_BLEND, albedo=kd, specular=ks,
                                alpha=(alpha, alpha),
                                distrib=mf.TROWBRIDGE_REITZ, tex_id=kd_tex)])

    def build(self) -> MaterialTable:
        mats = self.materials or [([], np.zeros(3, np.float32))]
        m = len(mats)
        # The lobe axis is trimmed to the widest material present.
        n_lobes = max(1, max(len(lobe_list) for lobe_list, _ in mats))
        shape2 = (m, n_lobes)
        cols = {
            "kind": np.zeros(shape2, np.int32),
            "albedo": np.zeros(shape2 + (3,), np.float32),
            "specular": np.zeros(shape2 + (3,), np.float32),
            "alpha": np.zeros(shape2 + (2,), np.float32),
            "distrib": np.zeros(shape2, np.int32),
            "fr_kind": np.zeros(shape2, np.int32),
            "eta": np.tile(np.asarray([1.0, 1.5], np.float32), shape2 + (1,)),
            "eta_t": np.ones(shape2 + (3,), np.float32),
            "k": np.zeros(shape2 + (3,), np.float32),
            "tex_id": np.full(shape2, -1, np.int32),
        }
        emission = np.zeros((m, 3), np.float32)
        textured = set()
        for i, (lobe_list, emit) in enumerate(mats):
            emission[i] = emit
            for l, lobe in enumerate(lobe_list):
                for name, arr in cols.items():
                    arr[i, l] = getattr(lobe, name)
                if lobe.tex_id >= 0:
                    textured.add(l)
        t = torch.from_numpy
        return MaterialTable(
            **{name: t(arr) for name, arr in cols.items()},
            emission=t(emission),
            fourier=(fb.concat_tables(self.fourier_tables)
                     if self.fourier_tables else None),
            textured_slots=tuple(sorted(textured)),
            present_kinds=tuple(sorted(
                {l.kind for ll, _ in mats for l in ll})))
