"""BSDF lobe models with branchless kind dispatch. Mirrors
pbrs_tpu/bxdf/lobes.py for the LAMBERT, OREN_NAYAR, MICROFACET,
SPEC_MIRROR, SPEC_DIELECTRIC, SPEC_TRANSMIT and FRESNEL_BLEND kinds;
FOURIER raises NotImplementedError until its slice is ported.

A lobe is a row of SoA parameter tensors tagged with an integer kind;
eval/pdf/sample compute every model the scene can produce and mask-select.
Directions are unit vectors in the local shading frame (+z = normal).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import vecmath as vm
from . import fresnel as fr
from . import microfacet as mf

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
PORTED_KINDS = (LAMBERT, OREN_NAYAR, MICROFACET, SPEC_MIRROR,
                SPEC_DIELECTRIC, SPEC_TRANSMIT, FRESNEL_BLEND)
FIELDS = ("kind", "albedo", "specular", "alpha", "distrib", "fr_kind", "eta",
          "eta_t", "k")


@dataclass
class Lobes:
    """Per-hit lobe table: every field is [..., L] or [..., L, C].
    present_kinds is the static set of kinds the scene can produce."""

    kind: torch.Tensor
    albedo: torch.Tensor
    specular: torch.Tensor  # FresnelBlend Rs
    alpha: torch.Tensor  # [..., L, 2] microfacet alphas / Oren-Nayar (A, B)
    distrib: torch.Tensor
    fr_kind: torch.Tensor
    eta: torch.Tensor  # [..., L, 2] dielectric (front, back)
    eta_t: torch.Tensor  # [..., L, 3] conductor eta
    k: torch.Tensor  # [..., L, 3] conductor absorption
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
    nd = lobes.kind.dim()
    if isinstance(l, int):
        def pick(a):
            return a[..., l, :] if a.dim() > nd else a[..., l]
    else:
        idx = l.to(torch.int64)[:, None]

        def pick(a):
            if a.dim() > nd:
                return a.gather(1, idx[..., None].expand(-1, 1, a.shape[-1])
                                )[:, 0]
            return a.gather(1, idx)[:, 0]
    return Lobes(*(pick(getattr(lobes, f)) for f in FIELDS),
                 present_kinds=lobes.present_kinds)


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


# ------------------------------- eval --------------------------------------


def _fresnel_of(lb: Lobes, cos_i):
    return fr.eval_color(lb.fr_kind, cos_i, lb.eta[..., 0], lb.eta[..., 1],
                         lb.eta_t, lb.k)


def _oren_nayar_factor(lb, wo, wi):
    a, b = lb.alpha[..., 0], lb.alpha[..., 1]
    sin_i = torch.sqrt(mf.sin2_theta(wi))
    sin_o = torch.sqrt(mf.sin2_theta(wo))
    hyp_i = torch.clamp_min(torch.sqrt(wi[..., 0] ** 2 + wi[..., 1] ** 2),
                            1e-20)
    hyp_o = torch.clamp_min(torch.sqrt(wo[..., 0] ** 2 + wo[..., 1] ** 2),
                            1e-20)
    cos_dphi = (wi[..., 0] * wo[..., 0]
                + wi[..., 1] * wo[..., 1]) / (hyp_i * hyp_o)
    d_cos = torch.clamp_min(cos_dphi, 0.0)
    aci = torch.abs(wi[..., 2])
    aco = torch.abs(wo[..., 2])
    i_steeper = aci > aco
    sin_alpha = torch.where(i_steeper, sin_o, sin_i)
    tan_beta = torch.where(i_steeper, sin_i / torch.clamp_min(aci, 1e-20),
                           sin_o / torch.clamp_min(aco, 1e-20))
    return a + b * d_cos * sin_alpha * tan_beta


def _microfacet_eval(lb, wo, wi):
    aco = torch.abs(mf.cos_theta(wo))
    aci = torch.abs(mf.cos_theta(wi))
    mid = wo + wi
    ok = vm.dot(mid, mid) > 1e-16
    wh = vm.normalize(mid)
    z_axis = torch.zeros_like(wh)
    z_axis[..., 2] = 1.0
    wh = vm.face_forward(wh, z_axis)
    f_color = _fresnel_of(lb, vm.dot(wi, wh))
    ax, ay = lb.alpha[..., 0], lb.alpha[..., 1]
    val = (lb.albedo
           * (mf.d(lb.distrib, ax, ay, wh)
              * mf.g(lb.distrib, ax, ay, wo, wi))[..., None]
           * f_color * vm.weak_recip(4.0 * aco * aci)[..., None])
    zero_mask = (~ok) | (aco == 0.0) | (aci == 0.0)
    return torch.where(zero_mask[..., None], 0.0, val)


def _fresnel_blend_eval(lb, wo, wi):
    """Ashikhmin-Shirley FresnelBlend."""
    mid = wo + wi
    ok = vm.dot(mid, mid) > 1e-16
    wh = vm.normalize(mid)
    aci = torch.abs(mf.cos_theta(wi))
    aco = torch.abs(mf.cos_theta(wo))
    rd, rs = lb.albedo, lb.specular
    diffuse = ((28.0 / 23.0 * INV_PI) * rd * (1.0 - rs)
               * ((1.0 - (1.0 - 0.5 * aci) ** 5)
                  * (1.0 - (1.0 - 0.5 * aco) ** 5))[..., None])
    iw = vm.dot(wi, wh)
    schlick_c = rs + ((1.0 - iw) ** 5)[..., None] * (1.0 - rs)
    ax, ay = lb.alpha[..., 0], lb.alpha[..., 1]
    denom = 4.0 * torch.abs(iw) * torch.maximum(aci, aco)
    spec = (mf.d(lb.distrib, ax, ay, wh)
            * vm.weak_recip(denom))[..., None] * schlick_c
    return torch.where(ok[..., None], diffuse + spec, 0.0)


def eval_lobe(lb: Lobes, wo, wi):
    """f(wo, wi) for one lobe slot; delta kinds evaluate to 0 and the
    reflection-only kinds are zero across the horizon."""
    check_ported(lb.present_kinds)
    k = lb.kind
    out = torch.zeros_like(lb.albedo)
    same = same_hemisphere(wo, wi)[..., None]
    if lb.has(LAMBERT):
        out = torch.where((k[..., None] == LAMBERT) & same,
                          lb.albedo * INV_PI, out)
    if lb.has(OREN_NAYAR):
        on = lb.albedo * INV_PI * _oren_nayar_factor(lb, wo, wi)[..., None]
        out = torch.where((k[..., None] == OREN_NAYAR) & same, on, out)
    if lb.has(MICROFACET):
        out = torch.where((k[..., None] == MICROFACET) & same,
                          _microfacet_eval(lb, wo, wi), out)
    if lb.has(FRESNEL_BLEND):
        out = torch.where((k[..., None] == FRESNEL_BLEND) & same,
                          _fresnel_blend_eval(lb, wo, wi), out)
    return out


def pdf_lobe(lb: Lobes, wo, wi):
    """Sampling density of one lobe slot (0 for delta kinds)."""
    check_ported(lb.present_kinds)
    k = lb.kind
    same = same_hemisphere(wo, wi)
    out = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    if lb.has(LAMBERT, OREN_NAYAR, FRESNEL_BLEND):
        p_cos = torch.where(same, cos_hemisphere_pdf(wi), 0.0)
        out = torch.where((k == LAMBERT) | (k == OREN_NAYAR), p_cos, out)
    if lb.has(MICROFACET, FRESNEL_BLEND):
        mid = wo + wi
        ok = vm.dot(mid, mid) > 1e-16
        wh = vm.normalize(mid)
        ax, ay = lb.alpha[..., 0], lb.alpha[..., 1]
        p_mf = mf.pdf_wh(lb.distrib, ax, ay, wo, wh) * vm.weak_recip(
            4.0 * vm.dot(wo, wh))
        p_mf = torch.where(same & ok, p_mf, 0.0)
        out = torch.where(k == MICROFACET, p_mf, out)
        if lb.has(FRESNEL_BLEND):
            p_fb = torch.where(same & ok,
                               0.5 * (cos_hemisphere_pdf(wi) + p_mf), 0.0)
            out = torch.where(k == FRESNEL_BLEND, p_fb, out)
    return torch.clamp_min(out, 0.0)


# ------------------------------- sample ------------------------------------


def _refract_local(wo, eta_front, eta_back):
    """Refract wo across the local z interface -> (wi, tir)."""
    entering = mf.cos_theta(wo) > 0.0
    eta_i = torch.where(entering, eta_front, eta_back)
    eta_t = torch.where(entering, eta_back, eta_front)
    normal = torch.zeros_like(wo)
    normal[..., 2] = torch.where(entering, 1.0, -1.0)
    return vm.refract(normal, wo, eta_i / eta_t)


def sample_lobe(lb: Lobes, wo, u2):
    """Sample an incident direction from one lobe slot: (f, wi, pdf, is_delta);
    for delta kinds the pdf is the mass of the chosen branch."""
    check_ported(lb.present_kinds)
    k = lb.kind
    u, v = u2[..., 0], u2[..., 1]
    has = lb.has
    k3 = k[..., None]

    wi = cos_sample_hemisphere(u2)
    wi = wi * torch.where(mf.cos_theta(wo) < 0.0, -1.0, 1.0)[..., None]
    ax, ay = lb.alpha[..., 0], lb.alpha[..., 1]
    fb_diffuse = u < 0.5

    if has(MICROFACET):
        wh = mf.sample_wh(lb.distrib, ax, ay, wo, u2)
        wi = torch.where(k3 == MICROFACET, vm.reflect(wh, wo), wi)
    if has(SPEC_MIRROR, SPEC_DIELECTRIC):
        wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
        wi = torch.where(k3 == SPEC_MIRROR, wi_mirror, wi)
    if has(SPEC_TRANSMIT, SPEC_DIELECTRIC):
        wi_refr, tir = _refract_local(wo, lb.eta[..., 0], lb.eta[..., 1])
        wi = torch.where(k3 == SPEC_TRANSMIT, wi_refr, wi)
    if has(FRESNEL_BLEND):
        # Two strategies split on u: cosine hemisphere, or a reflected
        # microfacet normal.
        u_fb_lo = torch.clamp_max(u * 2.0, 1.0 - 1e-7)
        u_fb_hi = torch.remainder(u * 2.0, 1.0)
        wi_fb_cos = cos_sample_hemisphere(torch.stack([u_fb_lo, v], dim=-1))
        wh_fb = mf.sample_wh(lb.distrib, ax, ay, wo,
                             torch.stack([u_fb_hi, v], dim=-1))
        wi_fb = torch.where(fb_diffuse[..., None], wi_fb_cos,
                            vm.reflect(wh_fb, wo))
        wi = torch.where(k3 == FRESNEL_BLEND, wi_fb, wi)
    if has(SPEC_DIELECTRIC):
        # Reflect with probability R(wo), else refract.
        r_coeff = fr.dielectric_refl(mf.cos_theta(wo), lb.eta[..., 0],
                                     lb.eta[..., 1])
        diel_reflect = v < r_coeff
        wi_diel = torch.where(diel_reflect[..., None], wi_mirror, wi_refr)
        wi = torch.where(k3 == SPEC_DIELECTRIC, wi_diel, wi)

    f = eval_lobe(lb, wo, wi)
    p = pdf_lobe(lb, wo, wi)
    if has(MICROFACET, FRESNEL_BLEND):
        # Microfacet / FresnelBlend-specular samples below the horizon are
        # rejected.
        reject = ((k == MICROFACET) | ((k == FRESNEL_BLEND) & ~fb_diffuse)
                  ) & ~same_hemisphere(wo, wi)
        f = torch.where(reject[..., None], 0.0, f)
        p = torch.where(reject, 0.0, p)

    is_delta = is_delta_kind(k)
    if has(SPEC_MIRROR, SPEC_DIELECTRIC, SPEC_TRANSMIT):
        aci = torch.clamp_min(torch.abs(mf.cos_theta(wi)), 0.0)
        inv_aci = vm.weak_recip(aci)[..., None]
        pmf = torch.ones(k.shape, dtype=torch.float32, device=k.device)
        if has(SPEC_MIRROR):
            f_mirror = _fresnel_of(lb, mf.cos_theta(wi)) * lb.albedo * inv_aci
            f = torch.where(k3 == SPEC_MIRROR, f_mirror, f)
        if has(SPEC_TRANSMIT, SPEC_DIELECTRIC):
            r_at_wi = fr.dielectric_refl(mf.cos_theta(wi), lb.eta[..., 0],
                                         lb.eta[..., 1])
            f_refr = (1.0 - r_at_wi)[..., None] * lb.albedo * inv_aci
            f_refr = torch.where(tir[..., None], 0.0, f_refr)
            f = torch.where(k3 == SPEC_TRANSMIT, f_refr, f)
        if has(SPEC_DIELECTRIC):
            f_diel = torch.where(diel_reflect[..., None],
                                 r_coeff[..., None] * inv_aci * lb.albedo,
                                 f_refr)
            f = torch.where(k3 == SPEC_DIELECTRIC, f_diel, f)
            pmf = torch.where(k == SPEC_DIELECTRIC,
                              torch.where(diel_reflect, r_coeff,
                                          1.0 - r_coeff), pmf)
        p = torch.where(is_delta, pmf, p)

    p = torch.where(k == NONE, 0.0, p)
    f = torch.where((k == NONE)[..., None], 0.0, f)
    return f, wi, p, is_delta
