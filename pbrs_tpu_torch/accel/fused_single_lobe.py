"""Fused per-bounce megakernel for single-lobe material/light scenes
(kernel K3). Mirrors pbrs_tpu/accel/fused_single_lobe.py:
``scene_supports_single_lobe``, ``_bounce2_kernel`` (PCG and Sobol') and
``FusedSingleLobeIntegrator``.

One launch runs a whole wavefront bounce for every single-lobe material
(Lambert, isotropic Beckmann/Trowbridge-Reitz microfacet with
nop/dielectric/conductor Fresnel, mirror, hybrid dielectric, transmit),
two-lobe smooth mixtures (plastic, default uber), point/distant lights,
quad/sphere-cone/disk/triangle area lights, flat triangles, disks, the
none/const/gradient/dusk environments and solid/checker/Perlin textures.
The CUDA kernel (``csrc/fused_single_lobe.cu``) runs one thread per lane;
``bounce2_reference`` is the same bounce as a tensor program, op for op.
``bounce2`` takes the kernel for CUDA tensors and the plain version for CPU
tensors.

The TPU kernel's one-hot MXU gathers and bf16 3-split banks are not ported:
a lane reads its primitive, material, texture and light rows with one
indexed load each.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..bxdf import fresnel as frs
from ..bxdf import lobes as lb
from ..bxdf import microfacet as mfm
from ..core import sampler as smp
from ..geometry import ray as ray_mod
from ..integrators import wavefront
from ..lights import lights as lt
from ..lights import sample_shape as ss
from ..textures import textures as tex
from . import fused_kernel as fk
from . import trace_kernel as tk

T_MIN = ray_mod.T_MIN
BIG = tk.BIG
INF = float("inf")
SPAWN_EPS = ray_mod.SPAWN_EPS
INV_PI = 1.0 / math.pi
BVH_THRESHOLD = 4096  # pbrs_tpu/accel/trace_pallas.py BVH_THRESHOLD
N_IN, N_OUT = 9, 12  # float planes in / out (see bounce2_reference)

_SUPPORTED_KINDS = {
    lb.NONE, lb.LAMBERT, lb.MICROFACET, lb.SPEC_MIRROR, lb.SPEC_DIELECTRIC,
    lb.SPEC_TRANSMIT,
}

# Material bank columns [M, 3 + 16*n_slots]: 0-2 emission, then 16 columns
# per lobe slot: albedo(3), kind, alpha, distrib, fr_kind, eta(2),
# eta_t(3), k(3), tex_id.
SLOT_COLS = 16
# Texture bank [T, 8]: kind, color_a(3), color_b(3), perlin freq.
TEX_COLS = 8
TEX_CHECKER = tex.CHECKER
TEX_PERLIN = tex.PERLIN
# Area-light bank [A, 14]: shape kind, p0, p1, p2, scalar, emit.
LIGHT_COLS = 14
# Delta-light bank [D, 8]: kind, position / direction, color, unused.
DELTA_COLS = 8

# Kernel launches since the last reset.
LAUNCHES = 0


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def scene_supports_single_lobe(scene) -> bool:
    """Fast-path eligibility for the generalized single-lobe kernel."""
    if getattr(scene, "instanced", ()):
        return False  # trace-time instance groups -> general path
    mt = scene.materials
    if mt.textured_slots:
        # Procedural textures (solid/checker/perlin) evaluate in-kernel on
        # the hit position; image textures need the atlas -> general path.
        tt = scene.textures
        kinds_used = set()
        tid_all = _np(mt.tex_id)
        for sl in mt.textured_slots:
            kinds_used |= set(
                int(_np(tt.kind)[t])
                for t in tid_all[:, sl].tolist() if t >= 0)
        if kinds_used - {0, TEX_CHECKER, TEX_PERLIN}:
            return False
        if _np(tt.kind).shape[0] > 64:
            return False
    kinds = set(_np(mt.kind).reshape(-1).tolist())
    if kinds - _SUPPORTED_KINDS:
        return False
    km_all = _np(mt.kind)
    if km_all.shape[1] > 2 and (km_all[:, 2:] != lb.NONE).any():
        return False  # 3+ lobes (full uber) -> general path
    two = km_all.shape[1] > 1 and (km_all[:, 1] != lb.NONE).any()
    if two:
        # Two-lobe mixtures (plastic / default uber): smooth kinds only --
        # delta+smooth mixing has different pdf semantics.
        if kinds - {lb.NONE, lb.LAMBERT, lb.MICROFACET}:
            return False
    n_check = 2 if two else 1
    for s in range(n_check):
        alpha = _np(mt.alpha)[:, s, :]
        mf_rows = km_all[:, s] == lb.MICROFACET
        if mf_rows.any() and not np.allclose(alpha[mf_rows, 0],
                                             alpha[mf_rows, 1]):
            return False  # anisotropic microfacet -> general path
    if scene.env.kind == lt.ENV_IMAGE:
        return False
    if mt.kind.shape[0] > 512 or scene.delta_lights.count > 16:
        return False
    geom = scene.geom
    counts = geom.counts
    if sum(counts) > 512 or counts[2] > BVH_THRESHOLD:
        return False
    # Triangles: only flat shading reproduces in-kernel (vertex-normal
    # interpolation needs the full attribute tables).
    if counts[2]:
        p0 = _np(geom.tri_p0)
        p1 = _np(geom.tri_p1)
        p2 = _np(geom.tri_p2)
        ng = np.cross(p0 - p1, p2 - p1)
        ln = np.linalg.norm(ng, axis=-1, keepdims=True)
        real = ln[:, 0] > 0
        ng = np.where(ln > 0, ng / np.maximum(ln, 1e-30), 0.0)
        # Accept either orientation: shading normals are face-forwarded, so
        # for flat normals a sign flip is invisible downstream.
        for nv in (geom.tri_n0, geom.tri_n1, geom.tri_n2):
            dots = np.abs((_np(nv) * ng).sum(-1))
            if not np.allclose(dots[real], 1.0, atol=1e-5):
                return False
    if counts[3]:
        dn = _np(geom.disk_normal)
        lens = np.linalg.norm(dn, axis=-1)
        if not np.allclose(lens[lens > 0], 1.0, atol=1e-5):
            return False
    return True


def light_banks(scene):
    """(area-light bank [max(A,1), 14], its shapes, delta-light bank
    [max(D,1), 8]) as NumPy float32: the host packing K3 and K4 share."""
    al = scene.area_lights
    a = al.count
    if a:
        lights = np.concatenate([
            _np(al.shape_kind)[:a, None].astype(np.float32),
            _np(al.p0)[:a], _np(al.p1)[:a], _np(al.p2)[:a],
            _np(al.scalar)[:a, None], _np(al.emit)[:a]], axis=1)
        light_shapes = tuple(sorted(set(_np(al.shape_kind)[:a].tolist())))
    else:
        lights = np.zeros((1, LIGHT_COLS), np.float32)
        light_shapes = ()
    dl = scene.delta_lights
    delta = np.zeros((max(dl.count, 1), DELTA_COLS), np.float32)
    if dl.count:
        delta[:, 0] = _np(dl.kind)[:dl.count]
        delta[:, 1:4] = _np(dl.position)[:dl.count]
        delta[:, 4:7] = _np(dl.color)[:dl.count]
    return lights, light_shapes, delta


def _mask(kinds) -> int:
    return sum(1 << int(k) for k in set(kinds))


@dataclass
class SingleLobeTables:
    """The scene as the bounce kernel reads it, plus its static switches
    (the TPU kernel's static arguments; per-launch arguments on the card)."""

    bank: torch.Tensor  # [P,16] prim bank, column 13 = material id
    counts: tuple  # bank rows per family (spheres, quads, tris, disks)
    mats: torch.Tensor  # [M, 3 + 16*slots]
    texs: torch.Tensor  # [max(T,1), 8]
    lights: torch.Tensor  # [max(A,1), 14]
    delta: torch.Tensor  # [max(D,1), 8]
    env: torch.Tensor  # [7] env color a, color b, world radius
    n_area: int
    n_delta: int
    n_texs: int  # 0 = no textured slot (the overlay is skipped)
    env_kind: int
    two_slots: bool
    present_kinds: tuple
    light_shapes: tuple
    tex_kinds: tuple

    @property
    def n_lights(self):
        return (self.n_delta + self.n_area
                + (1 if self.env_kind != lt.ENV_NONE else 0))

    @staticmethod
    def from_scene(scene) -> "SingleLobeTables":
        """The host bank packing of FusedSingleLobeIntegrator.__init__."""
        geom = scene.geom
        dev = geom.quad_origin.device
        bank, counts = tk.prim_scalars(geom)
        bank[:, 13] = torch.cat([geom.sph_mat, geom.quad_mat, geom.tri_mat,
                                 geom.disk_mat]).to(torch.float32)
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.float32), device=dev)

        mt = scene.materials
        km = _np(mt.kind)
        two_slots = bool(km.shape[1] > 1 and (km[:, 1] != lb.NONE).any())

        def slot_cols(s):
            return np.concatenate([
                _np(mt.albedo)[:, s, :], km[:, s, None].astype(np.float32),
                _np(mt.alpha)[:, s, 0, None],
                _np(mt.distrib)[:, s, None].astype(np.float32),
                _np(mt.fr_kind)[:, s, None].astype(np.float32),
                _np(mt.eta)[:, s, :], _np(mt.eta_t)[:, s, :],
                _np(mt.k)[:, s, :],
                _np(mt.tex_id)[:, s, None].astype(np.float32),
            ], axis=1).astype(np.float32)

        parts = [_np(mt.emission).astype(np.float32), slot_cols(0)]
        used = km[:, 0].tolist()
        if two_slots:
            parts.append(slot_cols(1))
            used += km[:, 1].tolist()
        mats = np.concatenate(parts, axis=1)

        tt = scene.textures
        tex_used = set()
        tid_all = _np(mt.tex_id)
        for sl in mt.textured_slots:
            tex_used |= set(int(_np(tt.kind)[t])
                            for t in tid_all[:, sl].tolist() if t >= 0)
        if mt.textured_slots:
            texs = np.concatenate([
                _np(tt.kind)[:, None].astype(np.float32),
                _np(tt.color_a), _np(tt.color_b),
                _np(tt.freq)[:, None]], axis=1)
        else:
            texs = np.zeros((1, TEX_COLS), np.float32)

        lights, light_shapes, delta = light_banks(scene)
        dl = scene.delta_lights
        env = scene.env
        env_vec = np.concatenate([_np(env.color_a).reshape(3),
                                  _np(env.color_b).reshape(3),
                                  [float(_np(dl.world_radius))]])
        return SingleLobeTables(
            bank=bank.contiguous(), counts=counts, mats=f32(mats),
            texs=f32(texs), lights=f32(lights), delta=f32(delta),
            env=f32(env_vec), n_area=scene.area_lights.count,
            n_delta=dl.count,
            n_texs=int(texs.shape[0]) if mt.textured_slots else 0,
            env_kind=env.kind, two_slots=two_slots,
            present_kinds=tuple(sorted(set(used) - {lb.NONE})),
            light_shapes=light_shapes, tex_kinds=tuple(sorted(tex_used)))


# ----------------------- plain version: BSDF pieces ------------------------
# Component form on [N] planes, in the local frame (+z = shading normal).
# Each helper is op for op the arithmetic of the device function of the
# same name in csrc/fused_single_lobe.cu.

PI_F = math.pi


def _weak_recip(x):
    nz = x != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, x, 1.0), 0.0)


def _fr_dielectric(cos_i, e0, e1):
    """fresnel.dielectric_refl."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, e0, e1)
    et = torch.where(entering, e1, e0)
    ci = torch.abs(cos_i)
    si = torch.sqrt(torch.clamp_min(1.0 - ci * ci, 0.0))
    st = ei / et * si
    tir = st >= 1.0
    ct = torch.sqrt(torch.clamp_min(1.0 - st * st, 0.0))
    r_perp = (ei * ci - et * ct) / torch.clamp_min(ei * ci + et * ct, 1e-30)
    r_par = (et * ci - ei * ct) / torch.clamp_min(et * ci + ei * ct, 1e-30)
    return torch.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))


def _fr_conductor_ch(cos_i, eta, k):
    """One channel of fresnel.conductor_refl."""
    c2 = torch.clamp(cos_i, -1.0, 1.0)
    c2 = c2 * c2
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp_min(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp_min(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * torch.sqrt(torch.clamp_min(c2, 0.0))
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-30)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-30)
    return torch.clamp_min(0.5 * (rs + rp), 0.0)


def _fresnel_rgb(lob, cos_i):
    """fresnel.eval_color: NOP -> 1, dielectric scalar, conductor rgb."""
    fr = torch.where(lob["fr_kind"] == frs.DIELECTRIC,
                _fr_dielectric(cos_i, lob["eta0"], lob["eta1"]), 1.0)
    is_cond = lob["fr_kind"] == frs.CONDUCTOR
    return tuple(
        torch.where(is_cond, _fr_conductor_ch(cos_i, lob[f"et{c}"], lob[f"k{c}"]),
               fr) for c in "rgb")


def _d_ndf(distrib, alpha, whz):
    """Isotropic microfacet.d."""
    c2 = whz * whz
    t2 = torch.clamp_min(1.0 - c2, 0.0) / torch.clamp_min(c2, 1e-30)
    c4 = c2 * c2
    a2 = alpha * alpha
    denom = torch.clamp_min(PI_F * a2 * c4, 1e-30)
    et2 = t2 / a2
    d_beck = torch.exp(-et2) / denom
    e1 = 1.0 + et2
    d_tr = 1.0 / torch.clamp_min(e1 * e1 * denom, 1e-30)
    d = torch.where(distrib == mfm.BECKMANN, d_beck, d_tr)
    return torch.where(c4 < 1e-32, 0.0, d)


def _lambda_iso(distrib, alpha, wz):
    """Isotropic microfacet._lambda."""
    c2 = wz * wz
    t2 = torch.clamp_min(1.0 - c2, 0.0) / torch.clamp_min(c2, 1e-30)
    abs_tan = torch.sqrt(torch.clamp_min(t2, 0.0))
    a = 1.0 / torch.clamp_min(alpha * abs_tan, 1e-30)
    lam_b = torch.where(a >= 1.6, 0.0,
                   (1.0 - 1.259 * a + 0.396 * a * a)
                   / torch.clamp_min(3.535 * a + 2.181 * a * a, 1e-30))
    lam_t = 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * t2))
    return torch.where(distrib == mfm.BECKMANN, lam_b, lam_t)


def _pow5(x):
    return (x * x) * (x * x) * x


def _make_eval(lob, wol, has):
    """lobes.eval_lobe + lobes.pdf_lobe of one slot: eval_pdf(wil) ->
    (f_r, f_g, f_b, pdf). LAMBERT and isotropic MICROFACET for K3; the
    shade kernel K4 (accel/fused_wave.py) also reaches OREN_NAYAR (A, B in
    alpha, alpha2) and FRESNEL_BLEND (Rs in spc_*)."""
    wolx, woly, wolz = wol
    kind = lob["kind"]

    def eval_pdf(wilx, wily, wilz):
        zero = torch.zeros_like(wolz)
        f = [zero, zero, zero]
        pdf = zero
        same = wolz * wilz >= 0.0
        cos_pdf = torch.abs(wilz) * INV_PI
        alb = (lob["alb_r"], lob["alb_g"], lob["alb_b"])
        if has(lb.LAMBERT):
            sel = (kind == lb.LAMBERT) & same
            f = [torch.where(sel, a * INV_PI, fc) for a, fc in zip(alb, f)]
            pdf = torch.where(sel, cos_pdf, pdf)
        if has(lb.OREN_NAYAR):
            sin_i = torch.sqrt(torch.clamp_min(1.0 - wilz * wilz, 0.0))
            sin_o = torch.sqrt(torch.clamp_min(1.0 - wolz * wolz, 0.0))
            hyp_i = torch.clamp_min(torch.sqrt(wilx * wilx + wily * wily),
                                    1e-20)
            hyp_o = torch.clamp_min(torch.sqrt(wolx * wolx + woly * woly),
                                    1e-20)
            cos_dphi = (wilx * wolx + wily * woly) / (hyp_i * hyp_o)
            d_cos = torch.clamp_min(cos_dphi, 0.0)
            aci, aco = torch.abs(wilz), torch.abs(wolz)
            steeper = aci > aco
            sin_a = torch.where(steeper, sin_o, sin_i)
            tan_b = torch.where(steeper, sin_i / torch.clamp_min(aci, 1e-20),
                                sin_o / torch.clamp_min(aco, 1e-20))
            factor = lob["alpha"] + lob["alpha2"] * d_cos * sin_a * tan_b
            sel = (kind == lb.OREN_NAYAR) & same
            f = [torch.where(sel, a * INV_PI * factor, fc)
                 for a, fc in zip(alb, f)]
            pdf = torch.where(sel, cos_pdf, pdf)
        if has(lb.MICROFACET, lb.FRESNEL_BLEND):
            mx, my, mz = wolx + wilx, woly + wily, wolz + wilz
            m2 = mx * mx + my * my + mz * mz
            okm = m2 > 1e-16
            minv = torch.rsqrt(torch.clamp_min(m2, 1e-30))
            whx, why, whz = mx * minv, my * minv, mz * minv
            alpha, distrib = lob["alpha"], lob["distrib"]
            dval = _d_ndf(distrib, alpha, whz)
            # pdf: D(wh) |cos theta_h| / (4 wo.wh) with the raw wh.
            dot_oh = wolx * whx + woly * why + wolz * whz
            p_mf = dval * torch.abs(whz) * _weak_recip(4.0 * dot_oh)
            p_mf = torch.where(same & okm, torch.clamp_min(p_mf, 0.0), 0.0)
        if has(lb.MICROFACET):
            g = 1.0 / (1.0 + _lambda_iso(distrib, alpha, wolz)
                       + _lambda_iso(distrib, alpha, wilz))
            # Fresnel at wi.wh with wh face-forwarded to +z.
            zsgn = torch.where(whz < 0.0, -1.0, 1.0)
            cos_ih = (wilx * whx + wily * why + wilz * whz) * zsgn
            frc = _fresnel_rgb(lob, cos_ih)
            inv_den = _weak_recip(4.0 * torch.abs(wolz) * torch.abs(wilz))
            scale = torch.where(okm & same, dval * g * inv_den, 0.0)
            sel = kind == lb.MICROFACET
            f = [torch.where(sel, a * scale * c, fc)
                 for a, c, fc in zip(alb, frc, f)]
            pdf = torch.where(sel, p_mf, pdf)
        if has(lb.FRESNEL_BLEND):
            # Ashikhmin-Shirley.
            aci, aco = torch.abs(wilz), torch.abs(wolz)
            dterm = (28.0 / 23.0 * INV_PI) * (
                1.0 - _pow5(1.0 - 0.5 * aci)) * (1.0 - _pow5(1.0 - 0.5 * aco))
            iw = wilx * whx + wily * why + wilz * whz
            sch = _pow5(1.0 - iw)
            dfac = dval * _weak_recip(4.0 * torch.abs(iw)
                                      * torch.maximum(aci, aco))
            sel = (kind == lb.FRESNEL_BLEND) & okm & same
            spc = (lob["spc_r"], lob["spc_g"], lob["spc_b"])
            f = [torch.where(sel, dterm * a * (1.0 - sp)
                             + dfac * (sp + sch * (1.0 - sp)), fc)
                 for a, sp, fc in zip(alb, spc, f)]
            pdf = torch.where(kind == lb.FRESNEL_BLEND,
                              torch.where(same & okm, 0.5 * (cos_pdf + p_mf),
                                          0.0), pdf)
        return f[0], f[1], f[2], pdf

    return eval_pdf


def _sample_lobe(lob, wol, su0, su1, eval_pdf, has):
    """lobes.sample_lobe for the kinds of K3 and K4, on the remapped pair
    (su0, su1) the mixture hands the chosen lobe. Returns (f_r, f_g, f_b,
    wix, wiy, wiz, pdf-or-pmf, is_delta); f is without the cosine."""
    wolx, woly, wolz = wol
    kind = lob["kind"]
    # Cosine hemisphere (Lambert, Oren-Nayar and the empty slot).
    ddx, ddy = fk._concentric_disk(su0 * 2.0 - 1.0, su1 * 2.0 - 1.0)
    ddz = torch.sqrt(torch.clamp_min(1.0 - ddx * ddx - ddy * ddy, 0.0))
    flip = torch.where(wolz < 0.0, -1.0, 1.0)
    wix, wiy, wiz = ddx * flip, ddy * flip, ddz * flip

    def sample_wh(u, v):
        """Isotropic microfacet.sample_wh, face-forwarded to wo."""
        phi = 2.0 * PI_F * v
        a2 = torch.clamp_min(lob["alpha"] * lob["alpha"], 1e-30)
        log_s = torch.log(torch.clamp_min(1.0 - u, 1e-30))
        tan2_b = -log_s * a2
        tan2_t = u / torch.clamp_min(1.0 - u, 1e-30) * a2
        tan2 = torch.where(lob["distrib"] == mfm.BECKMANN, tan2_b, tan2_t)
        cos_t = 1.0 / torch.sqrt(1.0 + tan2)
        sin_t = cos_t * torch.sqrt(torch.clamp_min(tan2, 0.0))
        whx = sin_t * torch.cos(phi)
        why = sin_t * torch.sin(phi)
        whz = cos_t
        sgn = torch.where(whx * wolx + why * woly + whz * wolz < 0.0, -1.0,
                          1.0)
        return whx * sgn, why * sgn, whz * sgn

    if has(lb.MICROFACET):
        whx, why, whz = sample_wh(su0, su1)
        doh = wolx * whx + woly * why + wolz * whz
        sel = kind == lb.MICROFACET
        wix = torch.where(sel, 2.0 * doh * whx - wolx, wix)
        wiy = torch.where(sel, 2.0 * doh * why - woly, wiy)
        wiz = torch.where(sel, 2.0 * doh * whz - wolz, wiz)

    if has(lb.FRESNEL_BLEND):
        # Two strategies split on su0: cosine hemisphere below 0.5, a
        # reflected microfacet normal above.
        fb_diffuse = su0 < 0.5
        u_lo = torch.clamp_max(su0 * 2.0, 1.0 - 1e-7)
        u_hi = torch.remainder(su0 * 2.0, 1.0)
        cdx, cdy = fk._concentric_disk(u_lo * 2.0 - 1.0, su1 * 2.0 - 1.0)
        cdz = torch.sqrt(torch.clamp_min(1.0 - cdx * cdx - cdy * cdy, 0.0))
        fwhx, fwhy, fwhz = sample_wh(u_hi, su1)
        fdoh = wolx * fwhx + woly * fwhy + wolz * fwhz
        sel = kind == lb.FRESNEL_BLEND
        wix = torch.where(sel, torch.where(fb_diffuse, cdx * flip,
                                           2.0 * fdoh * fwhx - wolx), wix)
        wiy = torch.where(sel, torch.where(fb_diffuse, cdy * flip,
                                           2.0 * fdoh * fwhy - woly), wiy)
        wiz = torch.where(sel, torch.where(fb_diffuse, cdz * flip,
                                           2.0 * fdoh * fwhz - wolz), wiz)

    if has(lb.SPEC_MIRROR):
        sel = kind == lb.SPEC_MIRROR
        wix, wiy, wiz = (torch.where(sel, -wolx, wix), torch.where(sel, -woly, wiy),
                         torch.where(sel, wolz, wiz))

    tir = torch.zeros_like(wolz, dtype=torch.bool)
    if has(lb.SPEC_TRANSMIT, lb.SPEC_DIELECTRIC):
        # Refract across local z; total internal reflection -> mirror.
        e0, e1 = lob["eta0"], lob["eta1"]
        entering = wolz > 0.0
        ei = torch.where(entering, e0, e1)
        et = torch.where(entering, e1, e0)
        nzs = torch.where(entering, 1.0, -1.0)
        ratio = ei / et
        cos_i = wolz * nzs
        sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
        sin2_o = sin2_i * ratio * ratio
        tir = sin2_o >= 1.0
        cos_o = torch.sqrt(torch.clamp_min(1.0 - sin2_o, 0.0))
        tx_ = torch.where(tir, -wolx, -ratio * wolx)
        ty_ = torch.where(tir, -woly, -ratio * woly)
        tz_ = torch.where(tir, wolz, -ratio * wolz + (ratio * cos_i - cos_o) * nzs)
        sel = kind == lb.SPEC_TRANSMIT
        wix, wiy, wiz = (torch.where(sel, tx_, wix), torch.where(sel, ty_, wiy),
                         torch.where(sel, tz_, wiz))

    if has(lb.SPEC_DIELECTRIC):
        # Reflect with probability R(wo), else refract; chosen on su1.
        r_coeff = _fr_dielectric(wolz, lob["eta0"], lob["eta1"])
        refl = su1 < r_coeff
        sel = kind == lb.SPEC_DIELECTRIC
        wix = torch.where(sel, torch.where(refl, -wolx, tx_), wix)
        wiy = torch.where(sel, torch.where(refl, -woly, ty_), wiy)
        wiz = torch.where(sel, torch.where(refl, wolz, tz_), wiz)

    f_r, f_g, f_b, pdf = eval_pdf(wix, wiy, wiz)
    if has(lb.MICROFACET, lb.FRESNEL_BLEND):
        # Below-horizon microfacet / FresnelBlend-specular samples are
        # rejected.
        reject = (kind == lb.MICROFACET) & (wolz * wiz < 0.0)
        if has(lb.FRESNEL_BLEND):
            reject = reject | ((kind == lb.FRESNEL_BLEND) & ~fb_diffuse
                               & (wolz * wiz < 0.0))
        f_r, f_g, f_b, pdf = (torch.where(reject, 0.0, x)
                              for x in (f_r, f_g, f_b, pdf))

    is_delta = ((kind == lb.SPEC_MIRROR) | (kind == lb.SPEC_DIELECTRIC)
                | (kind == lb.SPEC_TRANSMIT))
    if has(lb.SPEC_MIRROR, lb.SPEC_DIELECTRIC, lb.SPEC_TRANSMIT):
        inv_ci = _weak_recip(torch.abs(wiz))
        pmf = torch.ones_like(wolz)
        alb = (lob["alb_r"], lob["alb_g"], lob["alb_b"])
        f = [f_r, f_g, f_b]
        if has(lb.SPEC_MIRROR):
            frc = _fresnel_rgb(lob, wiz)
            sel = kind == lb.SPEC_MIRROR
            f = [torch.where(sel, c * a * inv_ci, fc)
                 for c, a, fc in zip(frc, alb, f)]
        if has(lb.SPEC_TRANSMIT, lb.SPEC_DIELECTRIC):
            r_wi = _fr_dielectric(wiz, lob["eta0"], lob["eta1"])
            ftr = [torch.where(tir, 0.0, (1.0 - r_wi) * a * inv_ci) for a in alb]
            sel = kind == lb.SPEC_TRANSMIT
            f = [torch.where(sel, t, fc) for t, fc in zip(ftr, f)]
        if has(lb.SPEC_DIELECTRIC):
            sel = kind == lb.SPEC_DIELECTRIC
            f = [torch.where(sel, torch.where(refl, r_coeff * a * inv_ci, t), fc)
                 for a, t, fc in zip(alb, ftr, f)]
            pmf = torch.where(sel, torch.where(refl, r_coeff, 1.0 - r_coeff), pmf)
        f_r, f_g, f_b = f
        pdf = torch.where(is_delta, pmf, pdf)

    none = kind == lb.NONE
    f_r, f_g, f_b, pdf = (torch.where(none, 0.0, x) for x in (f_r, f_g, f_b, pdf))
    return f_r, f_g, f_b, wix, wiy, wiz, pdf, is_delta


def _env_eval(tab, wx, wy, wz):
    """lights.eval_env along (possibly unnormalized) directions."""
    e = tab.env
    if tab.env_kind == lt.ENV_NONE:
        z = torch.zeros_like(wx)
        return z, z, z
    if tab.env_kind == lt.ENV_CONST:
        one = torch.ones_like(wx)
        return one * e[0], one * e[1], one * e[2]
    dlen = torch.rsqrt(torch.clamp_min(wx * wx + wy * wy + wz * wz, 1e-30))
    yy = wy * dlen
    if tab.env_kind == lt.ENV_GRADIENT:
        t = (yy + 1.0) * 0.5
        return tuple(e[i] * t + e[i + 3] * (1.0 - t) for i in range(3))
    # ENV_DUSK. acos stands in for the TPU kernel's polynomial _acos (Mosaic
    # has no acos lowering).
    tilt = torch.acos(torch.clamp(yy, -1.0, 1.0))
    t = tilt * (1.0 / (PI_F * 0.25))
    above = tilt > PI_F * 0.25
    ground = tilt <= 0.0
    return tuple(
        torch.where(ground, 0.2, torch.where(above, e[i], e[i] * t + e[i + 3] * (1.0 - t)))
        for i in range(3))


def _lobe_planes(got, base):
    """The 16 columns of one slot as named per-lane planes."""
    names = ("alb_r", "alb_g", "alb_b", "kind", "alpha", "distrib", "fr_kind",
             "eta0", "eta1", "etr", "etg", "etb", "kr", "kg", "kb", "tex")
    lob = {n: got[:, base + j] for j, n in enumerate(names)}
    for n in ("kind", "distrib", "fr_kind", "tex"):
        lob[n] = lob[n].to(torch.int32)
    return lob


def _overlay_texture(tab, lob, px, py, pz):
    """textures.eval_texture on the hit position, over the slot albedo."""
    tid = lob["tex"]
    ok = (tid >= 0) & (tid < tab.n_texs)
    row = tab.texs[torch.clamp(tid, 0, tab.n_texs - 1).to(torch.int64)]
    gt = [torch.where(ok, row[:, j], 0.0) for j in range(TEX_COLS)]
    tkind = gt[0].to(torch.int32)
    c = [gt[1], gt[2], gt[3]]
    if TEX_CHECKER in tab.tex_kinds:
        sines = torch.sin(10.0 * px) * torch.sin(10.0 * py) * torch.sin(
            10.0 * pz)
        sel = (tkind == TEX_CHECKER) & (sines < 0.0)
        c = [torch.where(sel, gt[4 + i], c[i]) for i in range(3)]
    if TEX_PERLIN in tab.tex_kinds:
        m = tex.marble(px, py, pz, gt[7])
        sel = tkind == TEX_PERLIN
        c = [torch.where(sel, m, ci) for ci in c]
    use = tid >= 0
    for i, n in enumerate(("alb_r", "alb_g", "alb_b")):
        lob[n] = torch.where(use, c[i], lob[n])


def _occluded(tab, ox, oy, oz, dx, dy, dz, t_max):
    t, _ = tk.sweep_reference(tab.bank, tab.counts, ox, oy, oz, dx, dy, dz,
                              t_max)
    return t < BIG


def _row(table, idx, ok, n_cols):
    """Per-lane rows of a small table: zeros where `ok` is false."""
    r = table[torch.clamp(idx, 0, table.shape[0] - 1).to(torch.int64)]
    return [torch.where(ok, r[:, j], 0.0) for j in range(n_cols)]


def _hit_detail(tab, hit, pid, px, py, pz, rdx, rdy, rdz):
    """Sphere/quad/triangle/disk hit detail of the winning bank row:
    (p, n, dpdu, mat_id)."""
    n_sph, n_quad, n_tri, _ = tab.counts
    zero = torch.zeros_like(px)
    gp = _row(tab.bank, pid, hit, 14)
    nx, ny, nz = zero, zero, zero + 1.0
    tx, ty, tz = zero + 1.0, zero, zero
    mat_id = torch.where(hit, gp[13].to(torch.int32), -1)
    q0, t0 = n_sph, n_sph + n_quad
    d0 = t0 + n_tri
    sel_sph = hit & (pid < q0)
    sel_quad = hit & (pid >= q0) & (pid < t0)
    sel_tri = hit & (pid >= t0) & (pid < d0)
    sel_disk = hit & (pid >= d0)

    def put(sel, vals, cur):
        return [torch.where(sel, v, c) for v, c in zip(vals, cur)]

    if tab.counts[0]:
        cx, cy, cz, r = gp[0], gp[1], gp[2], gp[3]
        gx, gy, gz = px - cx, py - cy, pz - cz
        inv = torch.rsqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-30))
        ux, uy, uz = gx * inv, gy * inv, gz * inv
        h2 = ux * ux + uy * uy
        hinv = torch.rsqrt(torch.clamp_min(h2, 1e-30))
        dx_ = torch.where(h2 < 1e-12, 1.0, -uy * hinv)
        dy_ = torch.where(h2 < 1e-12, 0.0, ux * hinv)
        sgn = torch.where(ux * rdx + uy * rdy + uz * rdz > 0.0, -1.0, 1.0)
        r_out = r * 1.00001
        nx, ny, nz = put(sel_sph, (sgn * ux, sgn * uy, sgn * uz), (nx, ny, nz))
        tx, ty, tz = put(sel_sph, (dx_, dy_, zero), (tx, ty, tz))
        px, py, pz = put(sel_sph, (cx + ux * r_out, cy + uy * r_out,
                                   cz + uz * r_out), (px, py, pz))
    if tab.counts[1]:
        qox, qoy, qoz = gp[0], gp[1], gp[2]
        eux, euy, euz = gp[3], gp[4], gp[5]
        evx, evy, evz = gp[6], gp[7], gp[8]
        qnx, qny, qnz = gp[9], gp[10], gp[11]
        inv_n2 = 1.0 / torch.clamp_min(gp[12], 1e-30)
        hx, hy, hz = px - qox, py - qoy, pz - qoz
        cx_ = hy * evz - hz * evy
        cy_ = hz * evx - hx * evz
        cz_ = hx * evy - hy * evx
        uu = (cx_ * qnx + cy_ * qny + cz_ * qnz) * inv_n2
        cx_ = euy * hz - euz * hy
        cy_ = euz * hx - eux * hz
        cz_ = eux * hy - euy * hx
        vv = (cx_ * qnx + cy_ * qny + cz_ * qnz) * inv_n2
        inv = torch.rsqrt(torch.clamp_min(qnx * qnx + qny * qny + qnz * qnz,
                                          1e-30))
        ux, uy, uz = qnx * inv, qny * inv, qnz * inv
        sgn = torch.where(ux * rdx + uy * rdy + uz * rdz > 0.0, -1.0, 1.0)
        nx, ny, nz = put(sel_quad, (sgn * ux, sgn * uy, sgn * uz),
                         (nx, ny, nz))
        tx, ty, tz = put(sel_quad, (eux, euy, euz), (tx, ty, tz))
        px, py, pz = put(sel_quad, (qox + uu * eux + vv * evx,
                                    qoy + uu * euy + vv * evy,
                                    qoz + uu * euz + vv * evz), (px, py, pz))
    if tab.counts[2]:
        p0x, p0y, p0z = gp[0], gp[1], gp[2]
        p1x, p1y, p1z = gp[3], gp[4], gp[5]
        p2x, p2y, p2z = gp[6], gp[7], gp[8]
        gnx, gny, gnz = gp[9], gp[10], gp[11]

        def edge(ax, ay, az, bx_, by_, bz_):
            ex, ey, ez = px - ax, py - ay, pz - az
            fx, fy, fz = px - bx_, py - by_, pz - bz_
            return ((ey * fz - ez * fy) * gnx + (ez * fx - ex * fz) * gny
                    + (ex * fy - ey * fx) * gnz)

        b2 = edge(p0x, p0y, p0z, p1x, p1y, p1z)
        b0 = edge(p1x, p1y, p1z, p2x, p2y, p2z)
        b1 = edge(p2x, p2y, p2z, p0x, p0y, p0z)
        total = b0 + b1 + b2
        total = torch.where(total == 0.0, 1.0, total)
        b0, b1, b2 = b0 / total, b1 / total, b2 / total
        sgn = torch.where(gnx * rdx + gny * rdy + gnz * rdz > 0.0, -1.0, 1.0)
        nx, ny, nz = put(sel_tri, (sgn * gnx, sgn * gny, sgn * gnz),
                         (nx, ny, nz))
        tx, ty, tz = put(sel_tri, (p1x - p0x, p1y - p0y, p1z - p0z),
                         (tx, ty, tz))
        px, py, pz = put(sel_tri, (b0 * p0x + b1 * p1x + b2 * p2x,
                                   b0 * p0y + b1 * p1y + b2 * p2y,
                                   b0 * p0z + b1 * p1z + b2 * p2z),
                         (px, py, pz))
    if tab.counts[3]:
        dcx, dcy, dcz = gp[0], gp[1], gp[2]
        dnx, dny, dnz = gp[3], gp[4], gp[5]
        cpx, cpy, cpz = px - dcx, py - dcy, pz - dcz
        proj = cpx * dnx + cpy * dny + cpz * dnz
        cpx, cpy, cpz = cpx - proj * dnx, cpy - proj * dny, cpz - proj * dnz
        sgn = torch.where(dnx * rdx + dny * rdy + dnz * rdz > 0.0, -1.0, 1.0)
        fnx, fny, fnz = sgn * dnx, sgn * dny, sgn * dnz
        tgx = fny * cpz - fnz * cpy
        tgy = fnz * cpx - fnx * cpz
        tgz = fnx * cpy - fny * cpx
        tinv = torch.rsqrt(torch.clamp_min(tgx * tgx + tgy * tgy + tgz * tgz,
                                           1e-30))
        nx, ny, nz = put(sel_disk, (fnx, fny, fnz), (nx, ny, nz))
        tx, ty, tz = put(sel_disk, (tgx * tinv, tgy * tinv, tgz * tinv),
                         (tx, ty, tz))
        px, py, pz = put(sel_disk, (dcx + cpx, dcy + cpy, dcz + cpz),
                         (px, py, pz))
    return (px, py, pz), (nx, ny, nz), (tx, ty, tz), mat_id


def _shading_frame(n, t, d):
    """vecmath.orthonormal_frame(normal n, dpdu t) on planes: (to_local,
    to_world, wo in the local frame) for ray direction d."""
    nx, ny, nz = n
    tx, ty, tz = t
    bx = ny * tz - nz * ty
    by = nz * tx - nx * tz
    bz = nx * ty - ny * tx
    good = bx * bx + by * by + bz * bz > 1e-12
    sD = torch.where(nz >= 0.0, 1.0, -1.0)
    aD = -1.0 / (sD + nz)
    bD = nx * ny * aD
    atx = 1.0 + sD * nx * nx * aD
    aty = sD * bD
    atz = -sD * nx
    bx = torch.where(good, bx, ny * atz - nz * aty)
    by = torch.where(good, by, nz * atx - nx * atz)
    bz = torch.where(good, bz, nx * aty - ny * atx)
    binv = torch.rsqrt(torch.clamp_min(bx * bx + by * by + bz * bz, 1e-30))
    bx, by, bz = bx * binv, by * binv, bz * binv
    fx_ = by * nz - bz * ny
    fy_ = bz * nx - bx * nz
    fz_ = bx * ny - by * nx

    def to_local(wx, wy, wz):
        lx = wx * fx_ + wy * fy_ + wz * fz_
        ly = wx * bx + wy * by + wz * bz
        lz = wx * nx + wy * ny + wz * nz
        inv = torch.rsqrt(torch.clamp_min(lx * lx + ly * ly + lz * lz, 1e-30))
        return lx * inv, ly * inv, lz * inv

    def to_world(lx, ly, lz):
        return (lx * fx_ + ly * bx + lz * nx, lx * fy_ + ly * by + lz * ny,
                lx * fz_ + ly * bz + lz * nz)

    dx, dy, dz = d
    winv = torch.rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-30))
    return to_local, to_world, to_local(-dx * winv, -dy * winv, -dz * winv)


class _AreaLight:
    """The chosen area light of each lane: its shape constants, a sampled
    point, and the per-shape query along a direction (pdf_at +
    intersect_shape). Every branch is the TPU kernel's, in its order."""

    def __init__(self, tab, a_idx, p, u_l0, u_l1):
        self.tab = tab
        self.p = p
        px, py, pz = p
        has = lambda k: k in tab.light_shapes  # noqa: E731
        self.has = has
        ok = torch.ones_like(a_idx, dtype=torch.bool)
        (lkf, l0x, l0y, l0z, l1x, l1y, l1z, l2x, l2y, l2z, lsc, ler, leg,
         leb) = _row(tab.lights, a_idx, ok, LIGHT_COLS)
        self.lkind = lkind = lkf.to(torch.int32)
        self.l0 = (l0x, l0y, l0z)
        self.l1 = (l1x, l1y, l1z)
        self.l2 = (l2x, l2y, l2z)
        self.lsc = lsc
        self.le = (ler, leg, leb)
        # shape area
        c12x = l1y * l2z - l1z * l2y
        c12y = l1z * l2x - l1x * l2z
        c12z = l1x * l2y - l1y * l2x
        self.c12 = (c12x, c12y, c12z)
        self.ln2 = ln2 = torch.clamp_min(c12x * c12x + c12y * c12y
                                         + c12z * c12z, 1e-30)
        area = torch.ones_like(px)
        if has(ss.QUAD):
            area = torch.where(lkind == ss.QUAD, torch.sqrt(ln2), area)
        if has(ss.SPHERE):
            area = torch.where(lkind == ss.SPHERE, 4.0 * PI_F * lsc * lsc, area)
        if has(ss.DISK):
            area = torch.where(lkind == ss.DISK,
                          PI_F * (l2x * l2x + l2y * l2y + l2z * l2z), area)
        tax, tay, taz = l0x - l1x, l0y - l1y, l0z - l1z
        tbx, tby, tbz = l2x - l1x, l2y - l1y, l2z - l1z
        tnx = tay * tbz - taz * tby
        tny = taz * tbx - tax * tbz
        tnz = tax * tby - tay * tbx
        self.tn = (tnx, tny, tnz)
        self.tn2 = tn2 = torch.clamp_min(tnx * tnx + tny * tny + tnz * tnz,
                                         1e-30)
        if has(ss.TRIANGLE):
            area = torch.where(lkind == ss.TRIANGLE, 0.5 * torch.sqrt(tn2), area)
        self.area = area

        # A point on the shape and the (raw) light normal there.
        zero = torch.zeros_like(px)
        pt = [zero, zero, zero]
        ln = [zero, zero, zero + 1.0]
        if has(ss.QUAD):
            sel = lkind == ss.QUAD
            ilq = torch.rsqrt(ln2)
            pt = [torch.where(sel, a + u_l0 * b + u_l1 * c, o)
                  for a, b, c, o in zip(self.l0, self.l1, self.l2, pt)]
            ln = [torch.where(sel, c * ilq, o) for c, o in zip(self.c12, ln)]
        if has(ss.TRIANGLE):
            sel = lkind == ss.TRIANGLE
            over = (u_l0 + u_l1) > 1.0
            tu = torch.where(over, 1.0 - u_l1, u_l0)
            tv = torch.where(over, 1.0 - u_l0, u_l1)
            itq = torch.rsqrt(tn2)
            pt = [torch.where(sel, a + tu * (b - a) + tv * (c - a), o)
                  for a, b, c, o in zip(self.l0, self.l1, self.l2, pt)]
            ln = [torch.where(sel, t * itq, o) for t, o in zip(self.tn, ln)]
        if has(ss.DISK):
            sel = lkind == ss.DISK
            cdx, cdy = fk._concentric_disk(u_l0 * 2.0 - 1.0, u_l1 * 2.0 - 1.0)
            pt = [torch.where(sel, a + cdx * c + cdy * r, o)
                  for a, c, r, o in zip(self.l0, self.l2, self.c12, pt)]
            ln = [torch.where(sel, b, o) for b, o in zip(self.l1, ln)]
        if has(ss.SPHERE):
            # Cone sampling from outside, uniform from inside.
            sel = lkind == ss.SPHERE
            wcx, wcy, wcz = l0x - px, l0y - py, l0z - pz
            dc2 = wcx * wcx + wcy * wcy + wcz * wcz
            r2l = lsc * lsc
            inside_s = dc2 < r2l
            zc = 2.0 * u_l1 - 1.0
            szc = torch.sqrt(torch.clamp_min(1.0 - zc * zc, 0.0))
            th = 2.0 * PI_F * u_l0
            iu = (szc * torch.cos(th), szc * torch.sin(th), zc)
            sin2_tm = r2l / torch.clamp_min(dc2, 1e-30)
            cos_tm = torch.sqrt(torch.clamp_min(1.0 - sin2_tm, 0.0))
            cos_tc = (1.0 - u_l0) + u_l0 * cos_tm
            sin2_tc = torch.clamp_min(1.0 - cos_tc * cos_tc, 0.0)
            phi_c = u_l1 * 2.0 * PI_F
            dcl = torch.sqrt(torch.clamp_min(dc2, 1e-30))
            ds_ = dcl * cos_tc - torch.sqrt(torch.clamp_min(
                r2l - dc2 * sin2_tc, 0.0))
            cos_al = (dc2 + r2l - ds_ * ds_) / torch.clamp_min(
                2.0 * dcl * lsc, 1e-30)
            sin_al = torch.sqrt(torch.clamp_min(1.0 - cos_al * cos_al, 0.0))
            # Frame around unit -wc (sphere center -> shading point), the
            # Duff basis of vecmath.make_coord_system.
            idc = torch.rsqrt(torch.clamp_min(dc2, 1e-30))
            ttx, tty, ttz = -wcx * idc, -wcy * idc, -wcz * idc
            sgn_ = torch.where(ttz >= 0.0, 1.0, -1.0)
            aD_ = -1.0 / (sgn_ + ttz)
            bD_ = ttx * tty * aD_
            b1 = (1.0 + sgn_ * ttx * ttx * aD_, sgn_ * bD_, -sgn_ * ttx)
            b2 = (bD_, sgn_ + tty * tty * aD_, -tty)
            nax = sin_al * torch.cos(phi_c)
            nay = sin_al * torch.sin(phi_c)
            on = [nax * a + nay * b + cos_al * t
                  for a, b, t in zip(b1, b2, (ttx, tty, ttz))]
            ns = [torch.where(inside_s, i, o) for i, o in zip(iu, on)]
            pt = [torch.where(sel, c + n * lsc, o)
                  for c, n, o in zip(self.l0, ns, pt)]
            ln = [torch.where(sel, n, o) for n, o in zip(ns, ln)]
        self.pt = pt
        self.ln = ln

    def query(self, wx_, wy_, wz_):
        """(hit, t, solid-angle pdf) of the chosen shape along a unit
        direction from the shading point; the pdf is zero when the
        re-intersection misses, even for a sampled point."""
        px, py, pz = self.p
        l0x, l0y, l0z = self.l0
        l1x, l1y, l1z = self.l1
        l2x, l2y, l2z = self.l2
        lkind, has = self.lkind, self.has
        okq = torch.zeros_like(lkind, dtype=torch.bool)
        tq = torch.zeros_like(px)
        cosq = torch.ones_like(px)

        def plane_hit(nx_, ny_, nz_):
            den = wx_ * nx_ + wy_ * ny_ + wz_ * nz_
            den_s = torch.where(den == 0.0, 1.0, den)
            tt = ((l0x - px) * nx_ + (l0y - py) * ny_
                  + (l0z - pz) * nz_) / den_s
            return den, tt

        def put(sel, ok_, tt, den):
            return (torch.where(sel, ok_, okq), torch.where(sel, tt, tq),
                    torch.where(sel, torch.abs(den), cosq))

        if has(ss.QUAD):
            sel = lkind == ss.QUAD
            ilq = torch.rsqrt(self.ln2)
            c12x, c12y, c12z = self.c12
            den, tt = plane_hit(c12x * ilq, c12y * ilq, c12z * ilq)
            hxq = px + tt * wx_ - l0x
            hyq = py + tt * wy_ - l0y
            hzq = pz + tt * wz_ - l0z
            cqx = hyq * l2z - hzq * l2y
            cqy = hzq * l2x - hxq * l2z
            cqz = hxq * l2y - hyq * l2x
            uu = (cqx * c12x + cqy * c12y + cqz * c12z) / self.ln2
            cqx = l1y * hzq - l1z * hyq
            cqy = l1z * hxq - l1x * hzq
            cqz = l1x * hyq - l1y * hxq
            vv = (cqx * c12x + cqy * c12y + cqz * c12z) / self.ln2
            ok_ = ((den != 0.0) & (tt >= T_MIN) & (uu >= 0.0) & (uu <= 1.0)
                   & (vv >= 0.0) & (vv <= 1.0))
            okq, tq, cosq = put(sel, ok_, tt, den)
        if has(ss.TRIANGLE):
            sel = lkind == ss.TRIANGLE
            itq = torch.rsqrt(self.tn2)
            tnx, tny, tnz = self.tn
            unx, uny, unz = tnx * itq, tny * itq, tnz * itq
            den, tt = plane_hit(unx, uny, unz)
            hx_, hy_, hz_ = px + tt * wx_, py + tt * wy_, pz + tt * wz_

            def tedge(ax, ay, az, bx_, by_, bz_):
                ex, ey, ez = hx_ - ax, hy_ - ay, hz_ - az
                gx, gy, gz = hx_ - bx_, hy_ - by_, hz_ - bz_
                return ((ey * gz - ez * gy) * unx + (ez * gx - ex * gz) * uny
                        + (ex * gy - ey * gx) * unz)

            tb2 = tedge(l0x, l0y, l0z, l1x, l1y, l1z)
            tb0 = tedge(l1x, l1y, l1z, l2x, l2y, l2z)
            tb1 = tedge(l2x, l2y, l2z, l0x, l0y, l0z)
            ins = (((tb0 > 0) & (tb1 > 0) & (tb2 > 0))
                   | ((tb0 < 0) & (tb1 < 0) & (tb2 < 0)))
            okq, tq, cosq = put(sel, (den != 0.0) & (tt >= T_MIN) & ins, tt,
                                den)
        if has(ss.DISK):
            # Raw normal p1, radius^2 = |p2|^2.
            sel = lkind == ss.DISK
            den, tt = plane_hit(l1x, l1y, l1z)
            hx_ = px + tt * wx_ - l0x
            hy_ = py + tt * wy_ - l0y
            hz_ = pz + tt * wz_ - l0z
            r2d = l2x * l2x + l2y * l2y + l2z * l2z
            ins = hx_ * hx_ + hy_ * hy_ + hz_ * hz_ <= r2d
            okq, tq, cosq = put(sel, (den != 0.0) & (tt >= T_MIN) & ins, tt,
                                den)
        pdfq = torch.where(okq, (tq * tq) / torch.clamp_min(cosq * self.area,
                                                        1e-30), 0.0)
        if has(ss.SPHERE):
            # Any-root hit; cone / uniform pdf (independent of the hit).
            sel = lkind == ss.SPHERE
            lsc = self.lsc
            fx_s, fy_s, fz_s = px - l0x, py - l0y, pz - l0z
            a_s = wx_ * wx_ + wy_ * wy_ + wz_ * wz_
            bp = -(fx_s * wx_ + fy_s * wy_ + fz_s * wz_)
            inv_a = 1.0 / torch.clamp_min(a_s, 1e-30)
            mx_ = fx_s + bp * inv_a * wx_
            my_ = fy_s + bp * inv_a * wy_
            mz_ = fz_s + bp * inv_a * wz_
            r2l = lsc * lsc
            dlt = r2l - (mx_ * mx_ + my_ * my_ + mz_ * mz_)
            c_s = fx_s * fx_s + fy_s * fy_s + fz_s * fz_s - r2l
            q_s = bp + torch.where(bp >= 0.0, 1.0, -1.0) * torch.sqrt(
                torch.clamp_min(dlt * a_s, 0.0))
            q_sf = torch.where(q_s == 0.0, 1.0, q_s)
            t0_ = c_s / q_sf
            t1_ = q_s * inv_a
            tlo = torch.minimum(t0_, t1_)
            thi = torch.maximum(t0_, t1_)
            ok_lo = tlo >= T_MIN
            ts = torch.where(ok_lo, tlo, thi)
            ok_ = (dlt >= 0.0) & (q_s != 0.0) & (ok_lo | (thi >= T_MIN))
            okq = torch.where(sel, ok_, okq)
            tq = torch.where(sel, ts, tq)
            wcx_, wcy_, wcz_ = l0x - px, l0y - py, l0z - pz
            dc2_ = wcx_ * wcx_ + wcy_ * wcy_ + wcz_ * wcz_
            ins_s = dc2_ < r2l
            s2tm = r2l / torch.clamp_min(dc2_, 1e-30)
            ctm = torch.sqrt(torch.clamp_min(1.0 - s2tm, 0.0))
            idc_ = torch.rsqrt(torch.clamp_min(dc2_, 1e-30))
            cone = 1.0 / torch.clamp_min(2.0 * PI_F * (1.0 - ctm), 1e-30)
            cdir = (wcx_ * wx_ + wcy_ * wy_ + wcz_ * wz_) * idc_
            pdf_sph = torch.where(ins_s, 1.0 / torch.clamp_min(self.area, 1e-30),
                             torch.where(cdir > ctm, cone, 0.0))
            pdfq = torch.where(sel, pdf_sph, pdfq)
        return okq, tq, pdfq


def bounce2_reference(tab: SingleLobeTables, fin, alive_in, spec_in, pix,
                      samp, *, seed, bounce, bounce_is_first, rr_active,
                      rng="pcg"):
    """Plain version of K3: one bounce over N lanes.

    fin [9,N] float32: origin xyz, dir xyz, beta rgb; alive_in, spec_in
    (the previous bounce sampled a delta lobe), pix, samp [N] int32.
    Returns (fout [12,N]: radiance delta rgb, next origin xyz, next dir
    xyz, next beta rgb; alive_out [N] int32; spec_out [N] int32; traced-ray
    count, an int64 scalar: alive lanes, plus 2 x the lanes alive after the
    hit when the scene has lights). A dead lane passes its origin, dir and
    beta through with zero radiance."""
    ox, oy, oz, dx, dy, dz, br, bg, bb = fin
    beta = (br, bg, bb)
    live = alive_in > 0
    prev_spec = spec_in > 0
    has = lambda *ks: any(k in tab.present_kinds for k in ks)  # noqa: E731
    pixu = pix.to(torch.int64) & smp.MASK32
    smpu = samp.to(torch.int64) & smp.MASK32

    def u1(dim, lane=0):
        return fk._u1(seed, pixu, smpu, bounce, dim, lane, rng)

    zero = torch.zeros_like(ox)
    n_rays = live.sum()

    # ---- closest hit + hit detail ----
    t, pid = tk.sweep_reference(tab.bank, tab.counts, ox, oy, oz, dx, dy, dz,
                                torch.full_like(ox, INF))
    hit = t < BIG
    t_safe = torch.where(hit, t, 1.0)
    p, n, tg, mat_id = _hit_detail(
        tab, hit, pid, ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz,
        dx, dy, dz)
    px, py, pz = p
    nx, ny, nz = n
    to_local, to_world, wol = _shading_frame(n, tg, (dx, dy, dz))

    # ---- material row (one indexed load) + procedural textures ----
    n_mats = tab.mats.shape[0]
    got = torch.stack(_row(tab.mats, mat_id, (mat_id >= 0) & (mat_id < n_mats),
                           tab.mats.shape[1]), dim=1)
    emi = (got[:, 0], got[:, 1], got[:, 2])
    l0 = _lobe_planes(got, 3)
    l1 = _lobe_planes(got, 3 + SLOT_COLS) if tab.two_slots else None
    if tab.n_texs:
        _overlay_texture(tab, l0, px, py, pz)
        if tab.two_slots:
            _overlay_texture(tab, l1, px, py, pz)

    eval0 = _make_eval(l0, wol, has)
    eval1 = _make_eval(l1, wol, has) if tab.two_slots else None
    if tab.two_slots:
        n_active = ((l0["kind"] != lb.NONE).to(torch.int32)
                    + (l1["kind"] != lb.NONE).to(torch.int32))
        n_active_f = torch.clamp_min(n_active, 1).to(torch.float32)

    def eval_pdf(wilx, wily, wilz):
        """Mixture eval: sum of f over slots, pdf = sum pdf / n_active."""
        f_r, f_g, f_b, pdf = eval0(wilx, wily, wilz)
        if tab.two_slots:
            f1r, f1g, f1b, p1 = eval1(wilx, wily, wilz)
            f_r, f_g, f_b = f_r + f1r, f_g + f1g, f_b + f1b
            pdf = (pdf + p1) / n_active_f
        return f_r, f_g, f_b, pdf

    def sample_mix(u0, u1_):
        """bsdf.sample_bsdf: uniform lobe pick on u0, remap, sample the
        chosen lobe with (u1, remapped u0), tally the other slot."""
        if not tab.two_slots:
            return _sample_lobe(l0, wol, u1_, u0, eval0, has)
        chosen = torch.minimum((u0 * n_active_f).to(torch.int32),
                               torch.clamp_min(n_active - 1, 0))
        u_remap = torch.remainder(u0 * n_active_f, 1.0)
        pick0 = chosen == 0
        lc = {k: torch.where(pick0, l0[k], l1[k]) for k in l0}
        (f_r, f_g, f_b, wix, wiy, wiz, p_c, is_delta) = _sample_lobe(
            lc, wol, u1_, u_remap, _make_eval(lc, wol, has), has)
        f0r, f0g, f0b, p0 = eval0(wix, wiy, wiz)
        f1r, f1g, f1b, p1 = eval1(wix, wiy, wiz)
        f_r = f_r + torch.where(pick0, f1r, f0r)
        f_g = f_g + torch.where(pick0, f1g, f0g)
        f_b = f_b + torch.where(pick0, f1b, f0b)
        pdf = (p_c + torch.where(pick0, p1, p0)) / n_active_f
        none = n_active == 0
        f_r, f_g, f_b, pdf = (torch.where(none, 0.0, x)
                              for x in (f_r, f_g, f_b, pdf))
        return f_r, f_g, f_b, wix, wiy, wiz, pdf, is_delta

    # ---- emission / env on camera and post-delta segments ----
    env = _env_eval(tab, dx, dy, dz)
    count_emit = live if bounce_is_first else (live & prev_spec)
    rad = [torch.where(count_emit, b * torch.where(hit, e, v), 0.0)
           for b, e, v in zip(beta, emi, env)]
    alive = live & hit

    # ---- NEE: one light among delta + area + env ----
    n_lights = tab.n_lights
    n_delta, n_area = tab.n_delta, tab.n_area
    has_env = tab.env_kind != lt.ENV_NONE
    if n_lights > 0:
        u_sel = u1(smp.DIM_LIGHT_SELECT)
        u_l0 = u1(smp.DIM_LIGHT_UV, 0)
        u_l1 = u1(smp.DIM_LIGHT_UV, 1)
        u_s0 = u1(smp.DIM_SCATTER_UV, 0)
        u_s1 = u1(smp.DIM_SCATTER_UV, 1)
        chosen = torch.clamp_max((u_sel * n_lights).to(torch.int32),
                                 n_lights - 1)
        arm_delta = chosen < n_delta
        arm_area = (chosen >= n_delta) & (chosen < n_delta + n_area)
        arm_env = chosen >= n_delta + n_area

        # -------- light-sampled arm (delta + area) --------
        li = [zero, zero, zero]
        wl = [zero, zero, zero + 1.0]
        tgt = [zero, zero, zero]
        pdf_l = zero + 1.0
        if n_delta > 0:
            ok = torch.ones_like(live)
            dk, dpx, dpy, dpz, dcr, dcg, dcb, _ = _row(
                tab.delta, torch.clamp(chosen, 0, n_delta - 1), ok,
                DELTA_COLS)
            is_point = dk < 0.5  # POINT = 0
            tlx, tly, tlz = dpx - px, dpy - py, dpz - pz
            d2p = torch.clamp_min(tlx * tlx + tly * tly + tlz * tlz, 1e-30)
            ipd = torch.rsqrt(d2p)
            w_rad = tab.env[6]
            dinv = torch.rsqrt(torch.clamp_min(
                dpx * dpx + dpy * dpy + dpz * dpz, 1e-30))
            li = [torch.where(arm_delta, torch.where(is_point, c / d2p, c), o)
                  for c, o in zip((dcr, dcg, dcb), li)]
            wl = [torch.where(arm_delta, torch.where(is_point, tl * ipd, -dp * dinv), o)
                  for tl, dp, o in zip((tlx, tly, tlz), (dpx, dpy, dpz), wl)]
            tgt = [torch.where(arm_delta, torch.where(is_point, dp, pp - 2.0 * w_rad * dp),
                          o)
                   for dp, pp, o in zip((dpx, dpy, dpz), p, tgt)]
        if n_area > 0:
            area = _AreaLight(tab, torch.clamp(chosen - n_delta, 0,
                                               n_area - 1), p, u_l0, u_l1)
            tl = [a - b for a, b in zip(area.pt, p)]
            d2a = torch.clamp_min(tl[0] * tl[0] + tl[1] * tl[1]
                                  + tl[2] * tl[2], 1e-20)
            ia = torch.rsqrt(d2a)
            aw = [x * ia for x in tl]
            # One-sided emission on the sampled arm.
            cos_la = -(area.ln[0] * aw[0] + area.ln[1] * aw[1]
                       + area.ln[2] * aw[2])
            facing = cos_la > 0.0
            _, _, pdfa = area.query(*aw)
            li = [torch.where(arm_area, torch.where(facing, e, 0.0), o)
                  for e, o in zip(area.le, li)]
            wl = [torch.where(arm_area, a, o) for a, o in zip(aw, wl)]
            tgt = [torch.where(arm_area, a, o) for a, o in zip(area.pt, tgt)]
            pdf_l = torch.where(arm_area, pdfa, pdf_l)

        if n_delta + n_area > 0:
            fe_r, fe_g, fe_b, pdf_sc = eval_pdf(*to_local(*wl))
            # eval_bsdf zeroes f when wo is tangent.
            wo_tangent = wol[2] == 0.0
            fe = [torch.where(wo_tangent, 0.0, f) for f in (fe_r, fe_g, fe_b)]
            cos_s = torch.abs(nx * wl[0] + ny * wl[1] + nz * wl[2])
            sdx, sdy, sdz = tgt[0] - px, tgt[1] - py, tgt[2] - pz
            side = torch.where(sdx * nx + sdy * ny + sdz * nz >= 0.0, 1.0, -1.0)
            occ1 = _occluded(
                tab, px + side * nx * SPAWN_EPS, py + side * ny * SPAWN_EPS,
                pz + side * nz * SPAWN_EPS, sdx, sdy, sdz,
                torch.full_like(ox, 1.0 - 1e-3))
            weight = torch.where(arm_delta, 1.0, pdf_l * pdf_l / torch.clamp_min(
                pdf_l * pdf_l + pdf_sc * pdf_sc, 1e-30))
            li_any = (li[0] > 0.0) | (li[1] > 0.0) | (li[2] > 0.0)
            valid = (arm_delta | arm_area) & ~occ1 & (pdf_l > 0.0) & li_any
            c = torch.where(valid, cos_s * weight * _weak_recip(pdf_l), 0.0)
            rad = [r + torch.where(alive, b * f * l * c * n_lights, 0.0)
                   for r, b, f, l in zip(rad, beta, fe, li)]

        # -------- BSDF-sampled arm (area MIS + env) --------
        if n_area > 0 or has_env:
            (sf_r, sf_g, sf_b, s_wlx, s_wly, s_wlz, s_pdf,
             s_delta) = sample_mix(u_s0, u_s1)
            w2x, w2y, w2z = to_world(s_wlx, s_wly, s_wlz)
            cos2a = torch.abs(w2x * nx + w2y * ny + w2z * nz)
            f2 = (sf_r * cos2a, sf_g * cos2a, sf_b * cos2a)
            if n_area > 0:
                hit_l, t_hit, pdf_l2 = area.query(w2x, w2y, w2z)
            else:
                hit_l = torch.zeros_like(live)
                t_hit = zero
                pdf_l2 = zero
            # Shared shadow batch: to the light point on the area arm (t_max
            # 1 - 1e-3), unbounded along wi on the env arm.
            dir2 = [torch.where(arm_env, w, t_hit * w) for w in (w2x, w2y, w2z)]
            tmax2 = torch.where(arm_env, INF, torch.full_like(ox, 1.0 - 1e-3))
            side2 = torch.where(dir2[0] * nx + dir2[1] * ny + dir2[2] * nz >= 0.0,
                           1.0, -1.0)
            occ2 = _occluded(
                tab, px + side2 * nx * SPAWN_EPS, py + side2 * ny * SPAWN_EPS,
                pz + side2 * nz * SPAWN_EPS, *dir2, tmax2)
            if n_area > 0:
                w_b = s_pdf * s_pdf / torch.clamp_min(
                    s_pdf * s_pdf + pdf_l2 * pdf_l2, 1e-30)
                f_any = (f2[0] > 0.0) | (f2[1] > 0.0) | (f2[2] > 0.0)
                # Delta-sampled directions are left to the
                # emission-after-specular rule.
                valid_b = (arm_area & hit_l & ~s_delta & ~occ2
                           & (s_pdf > 0.0) & (pdf_l2 > 0.0) & f_any)
                cb_ = torch.where(valid_b, w_b * _weak_recip(s_pdf), 0.0)
                rad = [r + torch.where(alive, b * f * e * cb_ * n_lights, 0.0)
                       for r, b, f, e in zip(rad, beta, f2, area.le)]
            if has_env:
                er2 = _env_eval(tab, w2x, w2y, w2z)
                valid_e = arm_env & ~s_delta & ~occ2 & (s_pdf > 0.0)
                ce_ = torch.where(valid_e, _weak_recip(s_pdf), 0.0)
                rad = [r + torch.where(alive, b * f * e * ce_ * n_lights, 0.0)
                       for r, b, f, e in zip(rad, beta, f2, er2)]
        n_rays = n_rays + 2 * alive.sum()

    # ---- BSDF sample for the next direction ----
    u_b0 = u1(smp.DIM_BSDF_UV, 0)
    u_b1 = u1(smp.DIM_BSDF_UV, 1)
    (bf_r, bf_g, bf_b, b_wlx, b_wly, b_wlz, b_pdf, b_delta) = sample_mix(
        u_b0, u_b1)
    wnx, wny, wnz = to_world(b_wlx, b_wly, b_wlz)
    cosn = torch.abs(wnx * nx + wny * ny + wnz * nz)
    f_any = (bf_r > 0.0) | (bf_g > 0.0) | (bf_b > 0.0)
    alive = alive & (b_pdf > 0.0) & f_any
    mult = cosn * _weak_recip(b_pdf)
    nb = [torch.where(alive, b * f * mult, b)
          for b, f in zip(beta, (bf_r, bf_g, bf_b))]
    if rr_active:
        lum = 0.21267127 * nb[0] + 0.71515972 * nb[1] + 0.07216883 * nb[2]
        q = torch.clamp_min(1.0 - lum, 0.05)
        alive = alive & ~(u1(smp.DIM_RUSSIAN_ROULETTE) < q)
        scale = torch.where(alive, 1.0 / torch.clamp_min(1.0 - q, 1e-6), 1.0)
        nb = [b * scale for b in nb]

    side = torch.where(wnx * nx + wny * ny + wnz * nz >= 0.0, 1.0, -1.0)
    out = (*rad, px + side * nx * SPAWN_EPS, py + side * ny * SPAWN_EPS,
           pz + side * nz * SPAWN_EPS, wnx, wny, wnz, *nb)
    passthrough = (zero, zero, zero, ox, oy, oz, dx, dy, dz, br, bg, bb)
    fout = torch.stack([torch.where(live, a, b) for a, b in zip(out, passthrough)])
    spec_out = alive & b_delta
    return fout, alive.to(torch.int32), spec_out.to(torch.int32), n_rays


# ------------------------------ CUDA kernel -------------------------------


def _check_lanes(tab, fin, ints, count):
    dev = tab.bank.device
    n = fin.shape[1] if fin.dim() == 2 else -1
    ok = (fin.dtype == torch.float32 and fin.dim() == 2
          and fin.shape[0] == N_IN and fin.is_contiguous()
          and fin.device == dev)
    for a in ints:
        ok = ok and (a.dtype == torch.int32 and a.shape == (n,)
                     and a.is_contiguous() and a.device == dev)
    ok = ok and (count.dtype == torch.int64 and count.shape == (1,)
                 and count.device == dev)
    for t in (tab.mats, tab.texs, tab.lights, tab.delta, tab.env):
        ok = ok and (t.dtype == torch.float32 and t.device == dev
                     and t.is_contiguous())
    if not ok:
        raise ValueError(
            "single-lobe bounce wants contiguous tensors on the bank's "
            "device: fin float32 [9,N]; alive, spec, pix, samp int32 [N]; "
            "count int64 [1]; float32 tables")


def bounce2(tab: SingleLobeTables, fin, alive, spec, pix, samp, count, *,
            seed, bounce, bounce_is_first, rr_active, rng="pcg"):
    """One bounce: returns (fout [12,N], alive_out [N], spec_out [N]) and
    adds the bounce's traced-ray count to `count` (int64 [1]). CUDA tensors
    launch K3, CPU tensors take bounce2_reference."""
    global LAUNCHES
    kind = fin.device.type
    if kind == "cpu":
        fout, alive_out, spec_out, n_rays = bounce2_reference(
            tab, fin, alive, spec, pix, samp, seed=seed, bounce=bounce,
            bounce_is_first=bounce_is_first, rr_active=rr_active, rng=rng)
        count += n_rays
        return fout, alive_out, spec_out
    if kind != "cuda":
        raise ValueError(f"no single-lobe bounce for device {fin.device}")
    tk._check_bank(tab.bank, tab.counts)
    _check_lanes(tab, fin, (alive, spec, pix, samp), count)
    if tab.env_kind not in (lt.ENV_NONE, lt.ENV_CONST, lt.ENV_GRADIENT,
                            lt.ENV_DUSK):
        raise ValueError(f"env kind {tab.env_kind} is not single-lobe "
                         "eligible")
    n = fin.shape[1]
    fout = torch.empty((N_OUT, n), dtype=torch.float32, device=fin.device)
    alive_out = torch.empty(n, dtype=torch.int32, device=fin.device)
    spec_out = torch.empty(n, dtype=torch.int32, device=fin.device)
    if n == 0:
        return fout, alive_out, spec_out
    seed_c = int(seed) & smp.MASK32
    seed_c = seed_c - (1 << 32) if seed_c >= (1 << 31) else seed_c
    stream = torch.cuda.current_stream(fin.device).cuda_stream
    rc = kernels.lib().pbrs_fused_single_lobe(
        tab.bank.data_ptr(), *tab.counts,
        tab.mats.data_ptr(), tab.mats.shape[0], tab.mats.shape[1],
        tab.texs.data_ptr(), tab.n_texs, _mask(tab.tex_kinds),
        tab.lights.data_ptr(), tab.n_area, tab.delta.data_ptr(),
        tab.n_delta, tab.env.data_ptr(), tab.env_kind, int(tab.two_slots),
        fk.RNG_CODES[rng], seed_c, int(bounce), int(bool(bounce_is_first)), int(bool(rr_active)),
        fin.data_ptr(), alive.data_ptr(), spec.data_ptr(), pix.data_ptr(),
        samp.data_ptr(), n, fout.data_ptr(), alive_out.data_ptr(),
        spec_out.data_ptr(), count.data_ptr(), stream)
    kernels.check(rc, "fused_single_lobe")
    LAUNCHES += 1
    return fout, alive_out, spec_out


class FusedSingleLobeIntegrator:
    """Runs the single-lobe bounce (the scene must pass
    scene_supports_single_lobe). One launch per bounce; the loop stays on
    the host."""

    def __init__(self, scene):
        self.scene = scene
        self.tables = SingleLobeTables.from_scene(scene)

    def render_samples(self, sampler, pixel_idx, sample_idx, max_depth=5,
                       msaa=2, rr_start=3):
        """(radiance [N,3], traced-ray count) for a (pixel, sample) batch."""
        rng = fk.rng_kind(sampler)
        rays = wavefront.camera_rays(self.scene, sampler, pixel_idx,
                                     sample_idx, msaa)
        n = rays.n
        dev = rays.origin.device
        fin = torch.cat([rays.origin.T, rays.dir.T,
                         torch.ones(3, n, device=dev)]).contiguous()
        alive = torch.ones(n, dtype=torch.int32, device=dev)
        spec = torch.zeros(n, dtype=torch.int32, device=dev)
        pix = pixel_idx.to(torch.int32).contiguous()
        samp = torch.as_tensor(sample_idx, dtype=torch.int32,
                               device=dev).expand(n).contiguous()
        radiance = torch.zeros(3, n, device=dev)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        for b in range(max_depth):
            fout, alive, spec = bounce2(
                self.tables, fin, alive, spec, pix, samp, count,
                seed=sampler.seed, bounce=b, bounce_is_first=(b == 0),
                rr_active=(b > rr_start), rng=rng)
            radiance = radiance + fout[0:3]
            fin = fout[3:]  # next origin, dir, beta: a contiguous view
        return radiance.T, count[0]
