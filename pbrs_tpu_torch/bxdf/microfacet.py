"""Microfacet normal distributions (Beckmann, Trowbridge-Reitz). Mirrors
pbrs_tpu/bxdf/microfacet.py, including the Trowbridge-Reitz `sample_wh`.

Directions are unit [..., 3] tensors in the local shading frame (+z =
normal).
"""

from __future__ import annotations

import math

import torch

from ..core import vecmath as vm

BECKMANN = 0
TROWBRIDGE_REITZ = 1


def roughness_to_alpha(roughness):
    """PBRT-style remap of a float32 roughness tensor."""
    x = torch.clamp_min(torch.log(torch.clamp_min(roughness, 1e-30)), -8.0)
    x2 = x * x
    return (1.62142 + 0.819955 * x + 0.1734 * x2 + 0.0171201 * (x * x2)
            + 0.000640711 * (x2 * x2))


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def sin2_theta(w):
    return torch.clamp_min(1.0 - cos2_theta(w), 0.0)


def tan2_theta(w):
    return sin2_theta(w) / torch.clamp_min(cos2_theta(w), 1e-30)


def _xy2(w):
    return w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1]


def cos2_phi(w):
    xy2 = _xy2(w)
    return torch.where(xy2 > 0.0,
                       w[..., 0] * w[..., 0] / torch.clamp_min(xy2, 1e-30),
                       1.0)


def sin2_phi(w):
    xy2 = _xy2(w)
    return torch.where(xy2 > 0.0,
                       w[..., 1] * w[..., 1] / torch.clamp_min(xy2, 1e-30),
                       0.0)


def same_hemisphere(w0, w1):
    return cos_theta(w0) * cos_theta(w1) >= 0.0


def d(distrib, alpha_x, alpha_y, wh):
    """Microfacet area density of normal wh (integral of D cos = 1)."""
    t2 = tan2_theta(wh)
    c2 = cos2_theta(wh)
    c4 = c2 * c2
    e = cos2_phi(wh) / (alpha_x * alpha_x) + sin2_phi(wh) / (alpha_y * alpha_y)
    denom = torch.clamp_min(math.pi * alpha_x * alpha_y * c4, 1e-30)
    d_beck = torch.exp(-e * t2) / denom
    et = 1.0 + e * t2
    d_tr = 1.0 / torch.clamp_min(et * et * denom, 1e-30)
    val = torch.where(distrib == BECKMANN, d_beck, d_tr)
    grazing = ~torch.isfinite(t2) | (c4 < 1e-32)
    return torch.where(grazing, 0.0, val)


def _lambda(distrib, alpha_x, alpha_y, w):
    """Masked-area ratio Lambda(w)."""
    abs_tan = torch.sqrt(torch.clamp_min(tan2_theta(w), 0.0))
    alpha2 = (cos2_phi(w) * (alpha_x * alpha_x)
              + sin2_phi(w) * (alpha_y * alpha_y))
    a = 1.0 / torch.clamp_min(torch.sqrt(alpha2) * abs_tan, 1e-30)
    lam_beck = torch.where(
        a >= 1.6, 0.0,
        (1.0 - 1.259 * a + 0.396 * (a * a))
        / torch.clamp_min(3.535 * a + 2.181 * (a * a), 1e-30))
    lam_tr = 0.5 * (-1.0 + torch.sqrt(1.0 + alpha2 * tan2_theta(w)))
    val = torch.where(distrib == BECKMANN, lam_beck, lam_tr)
    return torch.where(torch.isfinite(abs_tan), val, 0.0)


def g1(distrib, alpha_x, alpha_y, w):
    return 1.0 / (1.0 + _lambda(distrib, alpha_x, alpha_y, w))


def g(distrib, alpha_x, alpha_y, wo, wi):
    """Masking-shadowing 1 / (1 + Lambda(wo) + Lambda(wi))."""
    return 1.0 / (1.0 + _lambda(distrib, alpha_x, alpha_y, wo)
                  + _lambda(distrib, alpha_x, alpha_y, wi))


def pdf_wh(distrib, alpha_x, alpha_y, wo, wh):
    """Sampling density of wh: D(wh) |cos theta_h|."""
    return d(distrib, alpha_x, alpha_y, wh) * torch.abs(cos_theta(wh))


def sample_wh(distrib, alpha_x, alpha_y, wo, u2):
    """A microfacet normal from D(wh) cos theta_h, on wo's side."""
    u, v = u2[..., 0], u2[..., 1]
    iso = alpha_x == alpha_y
    phi_aniso = torch.atan(alpha_y / alpha_x
                           * torch.tan(2.0 * math.pi * v + 0.5 * math.pi))
    phi_aniso = phi_aniso + torch.where(v >= 0.5, math.pi, 0.0)
    phi = torch.where(iso, 2.0 * math.pi * v, phi_aniso)
    sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
    cx, sy = cos_phi / alpha_x, sin_phi / alpha_y
    inv_a2 = torch.where(iso,
                         1.0 / torch.clamp_min(alpha_x * alpha_x, 1e-30),
                         cx * cx + sy * sy)
    log_sample = torch.log(torch.clamp_min(1.0 - u, 1e-30))
    tan2_beck = -log_sample / inv_a2
    tan2_tr = u / torch.clamp_min(1.0 - u, 1e-30) / inv_a2
    tan2 = torch.where(distrib == BECKMANN, tan2_beck, tan2_tr)
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = cos_t * torch.sqrt(torch.clamp_min(tan2, 0.0))
    wh = vm.spherical_direction(sin_t, cos_t, phi)
    return vm.face_forward(wh, wo)
