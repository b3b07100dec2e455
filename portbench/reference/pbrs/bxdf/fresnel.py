"""Fresnel reflectance models. Mirrors pbrs_tpu/bxdf/fresnel.py."""

from __future__ import annotations

import torch

from ..core import vecmath as vm

NOP = 0
DIELECTRIC = 1
CONDUCTOR = 2


def dielectric_refl(cos_theta_i, eta_front, eta_back):
    """Unpolarized Fresnel reflectance of a dielectric interface; a
    negative cosine hits the back side (the etas swap)."""
    cos_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = cos_i > 0.0
    eta_i = torch.where(entering, eta_front, eta_back)
    eta_t = torch.where(entering, eta_back, eta_front)
    cos_i = torch.abs(cos_i)
    sin_i = vm.safe_sqrt(1.0 - cos_i * cos_i)
    sin_t = eta_i / eta_t * sin_i
    tir = sin_t >= 1.0
    cos_t = vm.safe_sqrt(1.0 - sin_t * sin_t)
    r_perp = (eta_i * cos_i - eta_t * cos_t) / torch.clamp_min(
        eta_i * cos_i + eta_t * cos_t, 1e-30)
    r_par = (eta_t * cos_i - eta_i * cos_t) / torch.clamp_min(
        eta_t * cos_i + eta_i * cos_t, 1e-30)
    r = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, r)


def conductor_refl(cos_theta_i, eta_t, k):
    """Per-channel conductor Fresnel (eta_t, k: [..., 3]; eta_i = 1)."""
    cos2 = torch.clamp(cos_theta_i, -1.0, 1.0)
    cos2 = cos2 * cos2
    sin2 = 1.0 - cos2
    cos2 = cos2[..., None]
    sin2 = sin2[..., None]
    eta2 = eta_t * eta_t
    etak2 = k * k
    t0 = eta2 - etak2 - sin2
    a2b2 = torch.sqrt(torch.clamp_min(t0 * t0 + 4.0 * eta2 * etak2, 0.0))
    t1 = a2b2 + cos2
    a = torch.sqrt(torch.clamp_min(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * torch.sqrt(torch.clamp_min(cos2, 0.0))
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-30)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-30)
    return torch.clamp_min(0.5 * (rs + rp), 0.0)


def eval_color(kind, cos_theta_i, eta_front, eta_back, eta_t, k):
    """[..., 3] reflectance of the model `kind` (broadcast against
    cos_theta_i): NOP -> 1, dielectric (scalar), conductor (rgb)."""
    diel = dielectric_refl(cos_theta_i, eta_front, eta_back)[..., None]
    cond = conductor_refl(cos_theta_i, eta_t, k)
    out = torch.where(kind[..., None] == DIELECTRIC, diel,
                      torch.ones_like(diel))
    return torch.where(kind[..., None] == CONDUCTOR, cond, out)
