"""BSDF lobe models with branchless kind dispatch. Mirrors
pbrs_tpu/bxdf/lobes.py for the LAMBERT kind; every other kind raises
NotImplementedError until its slice is ported.

Directions are unit vectors in the local shading frame (+z = normal).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import vecmath as vm

NONE = 0
LAMBERT = 1
OREN_NAYAR = 2
MICROFACET = 3
SPEC_MIRROR = 4
SPEC_DIELECTRIC = 5
SPEC_TRANSMIT = 6
FRESNEL_BLEND = 7
FOURIER = 8

INV_PI = 1.0 / math.pi
PORTED_KINDS = (LAMBERT,)


@dataclass
class Lobes:
    """Per-hit lobe table: kind [..., L], albedo [..., L, 3]. present_kinds
    is the static set of kinds the scene can produce."""

    kind: torch.Tensor
    albedo: torch.Tensor
    present_kinds: tuple = (LAMBERT,)

    @property
    def num_slots(self):
        return self.kind.shape[-1]

    def has(self, *kinds):
        return any(k in self.present_kinds for k in kinds)


def check_ported(present_kinds):
    missing = set(present_kinds) - set(PORTED_KINDS) - {NONE}
    if missing:
        raise NotImplementedError(
            f"pbrs_tpu.bxdf.lobes kinds {sorted(missing)} (eval_lobe/"
            "sample_lobe) are not ported to pbrs_tpu_torch yet")


def slot(lobes: Lobes, l) -> Lobes:
    """View of slot l; `l` is an int or a per-lane int tensor."""
    if isinstance(l, int):
        return Lobes(lobes.kind[..., l], lobes.albedo[..., l, :],
                     lobes.present_kinds)
    idx = l.to(torch.int64)[:, None]
    kind = lobes.kind.gather(1, idx)[:, 0]
    albedo = lobes.albedo.gather(1, idx[..., None].expand(-1, 1, 3))[:, 0]
    return Lobes(kind, albedo, lobes.present_kinds)


def num_active(lobes: Lobes):
    return (lobes.kind != NONE).sum(dim=-1).to(torch.int32)


def is_delta_kind(kind):
    return (kind == SPEC_MIRROR) | (kind == SPEC_DIELECTRIC) | (
        kind == SPEC_TRANSMIT)


def same_hemisphere(w0, w1):
    return w0[..., 2] * w1[..., 2] >= 0.0


def concentric_sample_disk(u2):
    """Map [0,1)^2 uniformly to the unit disk (Shirley-Chiu concentric)."""
    x = u2[..., 0] * 2.0 - 1.0
    y = u2[..., 1] * 2.0 - 1.0
    big = torch.abs(x) > torch.abs(y)
    r = torch.where(big, x, y)
    x_safe = torch.where(x == 0.0, 1.0, x)
    y_safe = torch.where(y == 0.0, 1.0, y)
    theta = torch.where(big, (math.pi / 4.0) * (y / x_safe),
                        (math.pi / 2.0) - (math.pi / 4.0) * (x / y_safe))
    px = r * torch.cos(theta)
    py = r * torch.sin(theta)
    degenerate = (x == 0.0) & (y == 0.0)
    zero = torch.zeros_like(px)
    return torch.where(degenerate, zero, px), torch.where(degenerate, zero, py)


def cos_sample_hemisphere(u2):
    x, y = concentric_sample_disk(u2)
    z = vm.safe_sqrt(1.0 - x * x - y * y)
    return torch.stack([x, y, z], dim=-1)


def cos_hemisphere_pdf(wi):
    return torch.abs(wi[..., 2]) * INV_PI


def eval_lobe(lb: Lobes, wo, wi):
    """f(wo, wi) for one lobe slot; reflection-only, so zero across the
    horizon."""
    check_ported(lb.present_kinds)
    out = torch.zeros_like(lb.albedo)
    same = same_hemisphere(wo, wi)[..., None]
    if lb.has(LAMBERT):
        out = torch.where((lb.kind[..., None] == LAMBERT) & same,
                          lb.albedo * INV_PI, out)
    return out


def pdf_lobe(lb: Lobes, wo, wi):
    check_ported(lb.present_kinds)
    out = torch.zeros(lb.kind.shape, dtype=torch.float32,
                      device=lb.kind.device)
    if lb.has(LAMBERT):
        p_cos = torch.where(same_hemisphere(wo, wi), cos_hemisphere_pdf(wi),
                            torch.zeros_like(out))
        out = torch.where(lb.kind == LAMBERT, p_cos, out)
    return torch.clamp_min(out, 0.0)


def sample_lobe(lb: Lobes, wo, u2):
    """Returns (f, wi, pdf, is_delta) for one lobe slot."""
    wi = cos_sample_hemisphere(u2)
    wi = wi * torch.where(wo[..., 2] < 0.0, -1.0, 1.0)[..., None]
    f = eval_lobe(lb, wo, wi)
    p = pdf_lobe(lb, wo, wi)
    is_delta = is_delta_kind(lb.kind)
    none = lb.kind == NONE
    p = torch.where(none, 0.0, p)
    f = torch.where(none[..., None], 0.0, f)
    return f, wi, p, is_delta
