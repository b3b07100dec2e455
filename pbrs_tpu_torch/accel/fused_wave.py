"""The shade-only bounce with the trace outside it (kernel K4). Mirrors
pbrs_tpu/accel/fused_wave.py: ``scene_supports_wave`` /
``scene_supports_wave_folded``, ``_shade_kernel`` (two-arm or folded NEE,
PCG or Sobol' draws), ``FusedWaveIntegrator.render_samples`` (masked,
or compacted to a shrink schedule) and the Fourier override.

A bounce traces its closest hit through the scene's tracer (K1 / K5 /
instance groups, accel/dispatch.py), evaluates the hit detail, the image /
procedural textures of the textured slots, the environment along the ray
and, for an importance-sampled image environment, the env-light sample
outside the kernel; then one launch of K4 shades every lane: L-slot lobe
mixtures over the eight kinds, emission on camera and post-delta segments,
the BSDF sample, NEE over one light among delta + area + env with both MIS
arms, and Russian roulette. K4 emits two shadow queries with their pending
contributions instead of tracing them; one occlusion launch over both
batches and the apply step finish the bounce. Folded, the BSDF arm shares
the continuation sample: K4 emits one shadow query and a pending
contribution that the next bounce's closest hit resolves.

``shade_reference`` is K4 as a tensor program; ``shade`` launches the CUDA
kernel (``csrc/fused_wave.cu``) for CUDA tensors and takes the plain
version for CPU tensors. The TPU kernel's one-hot / masked row gathers and
its bf16 3-split material banks are not ported: a lane reads its material,
light and delta rows with one indexed load each. The kernel regroups each
block's lanes by shading class (``WaveTables.mat_class``) before shading
them; which thread shades a lane changes nothing a lane computes.

A lane that enters dead passes through on its own: zeros, its incoming
direction and beta. (The TPU kernel passes lanes through only when its
whole 64 x 128-lane block is dead and shades the dead lanes of a live
block; the apply step reads nothing of a dead lane that differs.)

Fourier lanes (a material with a FOURIER lobe) are shaded outside K4 by
the general path's own functions on the same counter draws
(``_fourier_override``): their NEE occlusion runs through the scene's
tracer, their two shadow queries are disarmed, and their results are
written over K4's output planes. K4 sees a FOURIER slot as active and
matching no kind, so the other lanes of a launch keep their values.
Two-arm only, as in the JAX package.

Given a shrink schedule, ``render_samples`` runs each bounce on the lanes
that ``integrators/wavefront.compact_step`` keeps, to a measured static
schedule, and banks each lane's contributions onto its original row in
the masked loop's order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels, profiling
from ..bxdf import bsdf as bsdf_mod
from ..bxdf import lobes as lb
from ..core import sampler as smp
from ..core import vecmath as vm
from ..geometry import ray as ray_mod
from ..integrators import nee
from ..integrators import wavefront
from ..lights import env_sampling as es
from ..lights import lights as lt
from ..materials import table as mat_mod
from ..textures import textures as tex
from . import dispatch as trace_dispatch
from . import fused_kernel as fk
from .fused_single_lobe import (_AreaLight, _make_eval, _np, _row,
                                _sample_lobe, _shading_frame, _weak_recip,
                                light_banks)

INV_PI = 1.0 / math.pi
SPAWN_EPS = ray_mod.SPAWN_EPS
INF = float("inf")
SHADOW_T = 1.0 - 1e-3
# Per-slot columns of the material bank: alb(3), spec(3), kind, alpha,
# alpha2, distrib, fr_kind, eta(2), eta_t(3), k(3), tex_id -> 20.
SLOT_COLS_W = 20
DELTA_COLS = 8  # delta bank [D, 8]: kind, position, color, unused
MAX_MATS = 512
MAX_DELTA = 16
MAX_SLOTS = 5  # materials/table.py MAX_LOBES
MAX_CLASSES = 32  # csrc/fused_wave.cu: shading classes a block sorts into
# Input planes: N_BASE floats (dir, hit position, normal, dpdu, env
# radiance), 3 per textured slot, ENV_IS_PLANES for an importance-sampled
# env (sampled direction, radiance, pdf), then beta rgb; int planes
# mat_id, hit, alive, spec, pixel, sample.
N_BASE, ENV_IS_PLANES, N_INT = 15, 7, 6
# Output planes: radiance(3); shadow 1 dir(3), t_max, side, coefficient(3);
# shadow 2 dir(3), t_max, side, area coefficient(3); env coefficient(3),
# BSDF pdf; next dir(3), side; beta(3) -- then int alive, spec.
N_OUT = 30

_WAVE_KINDS = {
    lb.NONE, lb.LAMBERT, lb.OREN_NAYAR, lb.MICROFACET, lb.SPEC_MIRROR,
    lb.SPEC_DIELECTRIC, lb.SPEC_TRANSMIT, lb.FRESNEL_BLEND,
}

# Kernel launches since the last reset.
LAUNCHES = 0


def scene_supports_wave(scene) -> bool:
    """Eligibility: every lobe kind in the supported set (FOURIER where
    the scene has its table: those lanes are shaded outside the kernel),
    isotropic microfacet / FresnelBlend, banks within the kernel's bounds.
    Geometry, instancing, textures and the environment are
    unrestricted."""
    mt = scene.materials
    km = _np(mt.kind)
    kinds = set(km.reshape(-1).tolist())
    if kinds - _WAVE_KINDS - {lb.FOURIER}:
        return False
    if lb.FOURIER in kinds and mt.fourier is None:
        return False
    alpha = _np(mt.alpha)
    for s in range(km.shape[1]):
        rows = (km[:, s] == lb.MICROFACET) | (km[:, s] == lb.FRESNEL_BLEND)
        if rows.any() and not np.allclose(alpha[rows, s, 0],
                                          alpha[rows, s, 1]):
            return False
    return km.shape[0] <= MAX_MATS and scene.delta_lights.count <= MAX_DELTA


def scene_supports_wave_folded(scene) -> bool:
    """Folded eligibility: wave-eligible and no FOURIER lobe (the Fourier
    override is two-arm only)."""
    return scene_supports_wave(scene) and lb.FOURIER not in set(
        _np(scene.materials.kind).reshape(-1).tolist())


@dataclass
class WaveTables:
    """The scene as K4 reads it, plus its static switches (the TPU kernel's
    static arguments; launch arguments on the card)."""

    mats: torch.Tensor  # [M, 3 + 20 * n_slots]: emission, slot columns
    lights: torch.Tensor  # [max(A,1), 14]
    delta: torch.Tensor  # [max(D,1), 8]
    world_radius: float
    n_area: int
    n_delta: int
    n_slots: int
    textured_slots: tuple
    has_env: bool
    env_is: bool
    present_kinds: tuple
    light_shapes: tuple
    tex_id: torch.Tensor  # [M, L] int32 texture ids for the outside eval
    mat_class: torch.Tensor  # [M + 1] int32 shading class of each row
    n_classes: int

    @property
    def n_lights(self):
        return self.n_delta + self.n_area + int(self.has_env)

    @property
    def n_in(self):
        return (N_BASE + 3 * len(self.textured_slots)
                + (ENV_IS_PLANES if self.env_is else 0) + 3)

    @staticmethod
    def from_scene(scene) -> "WaveTables":
        """The host bank packing of FusedWaveIntegrator.__init__."""
        dev = scene.geom.quad_origin.device
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.float32), device=dev)
        mt = scene.materials
        km = _np(mt.kind)
        # Trim the slot axis to the widest material present.
        n_slots = 1
        for s in range(km.shape[1]):
            if (km[:, s] != lb.NONE).any():
                n_slots = s + 1

        def slot_cols(s):
            return np.concatenate([
                _np(mt.albedo)[:, s, :], _np(mt.specular)[:, s, :],
                km[:, s, None].astype(np.float32),
                _np(mt.alpha)[:, s, 0, None], _np(mt.alpha)[:, s, 1, None],
                _np(mt.distrib)[:, s, None].astype(np.float32),
                _np(mt.fr_kind)[:, s, None].astype(np.float32),
                _np(mt.eta)[:, s, :], _np(mt.eta_t)[:, s, :],
                _np(mt.k)[:, s, :],
                _np(mt.tex_id)[:, s, None].astype(np.float32),
            ], axis=1).astype(np.float32)

        mats = np.concatenate([_np(mt.emission).astype(np.float32)]
                              + [slot_cols(s) for s in range(n_slots)], axis=1)
        used = set(km[:, :n_slots].reshape(-1).tolist())
        mat_class, n_classes = shading_classes(km[:, :n_slots])
        lights, light_shapes, delta = light_banks(scene)
        dl = scene.delta_lights
        has_env = scene.env.kind != lt.ENV_NONE
        return WaveTables(
            mats=f32(mats), lights=f32(lights), delta=f32(delta),
            world_radius=float(_np(dl.world_radius)),
            n_area=scene.area_lights.count, n_delta=dl.count, n_slots=n_slots,
            textured_slots=tuple(mt.textured_slots[:n_slots]),
            has_env=has_env,
            env_is=has_env and getattr(scene.env, "dist", None) is not None,
            present_kinds=tuple(sorted(used - {lb.NONE})),
            light_shapes=light_shapes,
            tex_id=torch.as_tensor(_np(mt.tex_id), dtype=torch.int32,
                                   device=dev),
            mat_class=torch.as_tensor(mat_class, device=dev),
            n_classes=n_classes)


def shading_classes(kinds):
    """(class [M + 1] int32, class count) of the material rows' lobe-kind
    tuples [M, L], then of a missed lane (all slots NONE): rows with equal
    kinds share a class, numbered in order of first appearance; classes past
    MAX_CLASSES - 1 share the last. K4 sorts a block's lanes by class, so a
    warp runs one row kind's branches."""
    ids = {}
    rows = [tuple(r) for r in np.asarray(kinds).tolist()]
    out = [min(ids.setdefault(r, len(ids)), MAX_CLASSES - 1)
           for r in rows + [(lb.NONE,) * np.asarray(kinds).shape[1]]]
    return np.asarray(out, np.int32), min(len(ids), MAX_CLASSES)


# ----------------------------- plain version --------------------------------


def _slot_planes(got, base):
    """The 20 columns of one slot as named per-lane planes."""
    names = ("alb_r", "alb_g", "alb_b", "spc_r", "spc_g", "spc_b", "kind",
             "alpha", "alpha2", "distrib", "fr_kind", "eta0", "eta1", "etr",
             "etg", "etb", "kr", "kg", "kb", "tex")
    lob = {n: got[:, base + j] for j, n in enumerate(names)}
    for n in ("kind", "distrib", "fr_kind"):
        lob[n] = lob[n].to(torch.int32)
    return lob


def shade_reference(tab: WaveTables, fin, iin, *, seed, bounce, first,
                    rr_on, rng="pcg", folded=False):
    """Plain version of K4 over N lanes.

    fin [tab.n_in, N] float32 (see N_BASE), iin [6, N] int32 (mat_id, hit,
    alive, spec, pixel, sample). Returns (fout [30, N] float32, iout [2, N]
    int32: alive, spec) in the TPU kernel's plane order, and the bounce's
    shadow-ray count (an int64 scalar: 2 per lane alive after its hit when
    the scene has lights, 1 when folded).

    folded: the path's own continuation sample is the NEE BSDF arm's
    sample; no second shadow query is written (s2 direction and side stay
    0) and s2t carries the distance to the chosen area light along the
    continuation ray where an area pending is owed."""
    rdx, rdy, rdz, px, py, pz, nx, ny, nz, tx, ty, tz = fin[:12]
    env_in = fin[12:15]
    n_tex = 3 * len(tab.textured_slots)
    tex_in = fin[N_BASE:N_BASE + n_tex]
    env_is_in = fin[N_BASE + n_tex:N_BASE + n_tex
                    + (ENV_IS_PLANES if tab.env_is else 0)]
    beta = tuple(fin[-3:])
    mat_id, hit_i, alive_i, spec_i, pix, samp = iin
    hit = hit_i > 0
    alive = alive_i > 0
    prev_spec = spec_i > 0
    has = lambda *ks: any(k in tab.present_kinds for k in ks)  # noqa: E731
    pixu = pix.to(torch.int64) & smp.MASK32
    smpu = samp.to(torch.int64) & smp.MASK32

    def u1(dim, lane=0):
        return fk._u1(seed, pixu, smpu, bounce, dim, lane, rng)

    zero = torch.zeros_like(rdx)

    to_local, to_world, wol = _shading_frame((nx, ny, nz), (tx, ty, tz),
                                             (rdx, rdy, rdz))

    # ---- material row (one indexed load), texture overlays ----
    n_mats = tab.mats.shape[0]
    safe_mat = torch.where(hit, mat_id, -1)
    got = torch.stack(_row(tab.mats, safe_mat,
                           (safe_mat >= 0) & (safe_mat < n_mats),
                           tab.mats.shape[1]), dim=1)
    emi = (got[:, 0], got[:, 1], got[:, 2])
    slots = [_slot_planes(got, 3 + s * SLOT_COLS_W)
             for s in range(tab.n_slots)]
    for i, s in enumerate(tab.textured_slots):
        use = slots[s]["tex"] >= 0.0
        for c, name in enumerate(("alb_r", "alb_g", "alb_b")):
            slots[s][name] = torch.where(use, tex_in[3 * i + c],
                                         slots[s][name])
    n_active = torch.zeros_like(mat_id)
    for s in range(tab.n_slots):
        n_active = n_active + (slots[s]["kind"] != lb.NONE).to(torch.int32)
    n_active_f = torch.clamp_min(n_active, 1).to(torch.float32)
    evals = [_make_eval(sl, wol, has) for sl in slots]

    def eval_pdf(wilx, wily, wilz):
        """Mixture: sum of f, sum of pdfs / n_active."""
        f_r, f_g, f_b, pdf = evals[0](wilx, wily, wilz)
        for e in evals[1:]:
            fr2, fg2, fb2, p2 = e(wilx, wily, wilz)
            f_r, f_g, f_b, pdf = f_r + fr2, f_g + fg2, f_b + fb2, pdf + p2
        if tab.n_slots > 1:
            pdf = pdf / n_active_f
        return f_r, f_g, f_b, pdf

    def sample_mix(u0, u1_):
        """bsdf.sample_bsdf: a uniform pick among the slots on u0, remapped;
        the chosen slot samples, the other active slots are tallied at its
        direction (a delta pick keeps its own f / pmf)."""
        if tab.n_slots == 1:
            return _sample_lobe(slots[0], wol, u1_, u0, evals[0], has)
        chosen = torch.minimum((u0 * n_active_f).to(torch.int32),
                               torch.clamp_min(n_active - 1, 0))
        u_remap = torch.remainder(u0 * n_active_f, 1.0)
        lc = dict(slots[0])
        for sl in range(1, tab.n_slots):
            sel = chosen == sl
            lc = {k: torch.where(sel, slots[sl][k], lc[k]) for k in lc}
        (f_r, f_g, f_b, wix, wiy, wiz, p_c, is_delta) = _sample_lobe(
            lc, wol, u1_, u_remap, _make_eval(lc, wol, has), has)
        f_sum = [zero, zero, zero]
        p_sum = zero
        for sl in range(tab.n_slots):
            mask = (chosen != sl) & (slots[sl]["kind"] != lb.NONE)
            fr2, fg2, fb2, p2 = evals[sl](wix, wiy, wiz)
            f_sum = [a + torch.where(mask, b, 0.0)
                     for a, b in zip(f_sum, (fr2, fg2, fb2))]
            p_sum = p_sum + torch.where(mask, p2, 0.0)
        f = [torch.where(is_delta, a, a + b)
             for a, b in zip((f_r, f_g, f_b), f_sum)]
        pdf = torch.where(is_delta, p_c, p_c + p_sum) / n_active_f
        none = n_active == 0
        f_r, f_g, f_b, pdf = (torch.where(none, 0.0, x) for x in (*f, pdf))
        return f_r, f_g, f_b, wix, wiy, wiz, pdf, is_delta

    out = {k: zero for k in ("s1d0", "s1d1", "s1d2", "s1t", "s1side", "c1r",
                             "c1g", "c1b", "s2d0", "s2d1", "s2d2", "s2t",
                             "s2side", "c2r", "c2g", "c2b", "ecr", "ecg",
                             "ecb", "spdf")}

    # ---- emission / env on camera and post-delta segments ----
    count_emit = alive & (prev_spec | bool(first))
    rad = [torch.where(count_emit, b * torch.where(hit, e, v), 0.0)
           for b, e, v in zip(beta, emi, env_in)]
    alive = alive & hit
    n_shadow = ((1 if folded else 2) * alive.sum() if tab.n_lights > 0
                else zero.sum().long())

    # ---- BSDF sample for the next direction ----
    (bf_r, bf_g, bf_b, b_wlx, b_wly, b_wlz, b_pdf, b_delta) = sample_mix(
        u1(smp.DIM_BSDF_UV, 0), u1(smp.DIM_BSDF_UV, 1))
    wnx, wny, wnz = to_world(b_wlx, b_wly, b_wlz)

    # ---- NEE: one light among delta + area + env ----
    n_lights, n_delta, n_area = tab.n_lights, tab.n_delta, tab.n_area
    if n_lights > 0:
        u_sel = u1(smp.DIM_LIGHT_SELECT)
        u_l0 = u1(smp.DIM_LIGHT_UV, 0)
        u_l1 = u1(smp.DIM_LIGHT_UV, 1)
        chosen = torch.clamp_max((u_sel * n_lights).to(torch.int32),
                                 n_lights - 1)
        arm_delta = chosen < n_delta
        arm_area = (chosen >= n_delta) & (chosen < n_delta + n_area)
        arm_env = chosen >= n_delta + n_area
        p = (px, py, pz)
        li = [zero, zero, zero]
        wl = [zero, zero, zero + 1.0]
        tgt = [zero, zero, zero]
        pdf_l = zero + 1.0
        if n_delta > 0:
            ok = torch.ones_like(hit)
            dk, dpx, dpy, dpz, dcr, dcg, dcb, _ = _row(
                tab.delta, torch.clamp(chosen, 0, n_delta - 1), ok,
                DELTA_COLS)
            is_point = dk < 0.5  # POINT = 0
            tl = (dpx - px, dpy - py, dpz - pz)
            d2p = torch.clamp_min(tl[0] * tl[0] + tl[1] * tl[1]
                                  + tl[2] * tl[2], 1e-30)
            ipd = torch.rsqrt(d2p)
            dinv = torch.rsqrt(torch.clamp_min(
                dpx * dpx + dpy * dpy + dpz * dpz, 1e-30))
            dp = (dpx, dpy, dpz)
            li = [torch.where(arm_delta, torch.where(is_point, c / d2p, c), o)
                  for c, o in zip((dcr, dcg, dcb), li)]
            wl = [torch.where(arm_delta,
                              torch.where(is_point, t * ipd, -d * dinv), o)
                  for t, d, o in zip(tl, dp, wl)]
            tgt = [torch.where(arm_delta, torch.where(
                is_point, d, q - 2.0 * tab.world_radius * d), o)
                   for d, q, o in zip(dp, p, tgt)]
        if n_area > 0:
            area = _AreaLight(tab, torch.clamp(chosen - n_delta, 0,
                                               n_area - 1), p, u_l0, u_l1)
            tl = [a - b for a, b in zip(area.pt, p)]
            d2a = torch.clamp_min(tl[0] * tl[0] + tl[1] * tl[1]
                                  + tl[2] * tl[2], 1e-20)
            ia = torch.rsqrt(d2a)
            aw = [x * ia for x in tl]
            # One-sided emission.
            cos_la = -(area.ln[0] * aw[0] + area.ln[1] * aw[1]
                       + area.ln[2] * aw[2])
            facing = cos_la > 0.0
            _, _, pdfa = area.query(*aw)
            li = [torch.where(arm_area, torch.where(facing, e, 0.0), o)
                  for e, o in zip(area.le, li)]
            wl = [torch.where(arm_area, a, o) for a, o in zip(aw, wl)]
            tgt = [torch.where(arm_area, a, o) for a, o in zip(area.pt, tgt)]
            pdf_l = torch.where(arm_area, pdfa, pdf_l)
        if tab.env_is:
            # The importance-sampled env arm, drawn outside from the same
            # DIM_LIGHT_UV stream: direction, radiance, solid-angle pdf.
            (esx, esy, esz, ier, ieg, ieb, iepdf) = env_is_in
            li = [torch.where(arm_env, e, o)
                  for e, o in zip((ier, ieg, ieb), li)]
            wl = [torch.where(arm_env, e, o)
                  for e, o in zip((esx, esy, esz), wl)]
            pdf_l = torch.where(arm_env, iepdf, pdf_l)

        if n_delta + n_area > 0 or tab.env_is:
            fe_r, fe_g, fe_b, pdf_sc = eval_pdf(*to_local(*wl))
            wo_tangent = wol[2] == 0.0
            fe = [torch.where(wo_tangent, 0.0, f) for f in (fe_r, fe_g, fe_b)]
            cos_s = torch.abs(nx * wl[0] + ny * wl[1] + nz * wl[2])
            # Shadow query 1: target - position (t_max 1 - 1e-3), or the
            # unbounded env direction on env-IS lanes.
            sd = [tgt[0] - px, tgt[1] - py, tgt[2] - pz]
            if tab.env_is:
                sd = [torch.where(arm_env, w, s) for w, s in zip(wl, sd)]
            side = torch.where(sd[0] * nx + sd[1] * ny + sd[2] * nz >= 0.0,
                               1.0, -1.0)
            weight = torch.where(
                arm_delta, 1.0, pdf_l * pdf_l / torch.clamp_min(
                    pdf_l * pdf_l + pdf_sc * pdf_sc, 1e-30))
            li_any = (li[0] > 0.0) | (li[1] > 0.0) | (li[2] > 0.0)
            arm_sampled = arm_delta | arm_area
            if tab.env_is:
                arm_sampled = arm_sampled | arm_env
            valid = arm_sampled & (pdf_l > 0.0) & li_any & alive
            c = torch.where(valid, cos_s * weight * _weak_recip(pdf_l), 0.0)
            s1t = torch.where(valid, SHADOW_T, 0.0)
            if tab.env_is:
                s1t = torch.where(valid & arm_env, INF, s1t)
            out.update(s1d0=sd[0], s1d1=sd[1], s1d2=sd[2], s1t=s1t,
                       s1side=side)
            for ch, b, f, l_ in zip("rgb", beta, fe, li):
                out["c1" + ch] = torch.where(alive, b * f * l_ * c * n_lights,
                                             0.0)

        # -------- BSDF-sampled arm (area MIS + env) --------
        if n_area > 0 or tab.has_env:
            if folded:
                # The continuation sample is the arm's; the next bounce's
                # closest hit resolves its visibility.
                sf_r, sf_g, sf_b, s_pdf, s_delta = (bf_r, bf_g, bf_b, b_pdf,
                                                    b_delta)
                w2 = (wnx, wny, wnz)
            else:
                (sf_r, sf_g, sf_b, s_wlx, s_wly, s_wlz, s_pdf,
                 s_delta) = sample_mix(u1(smp.DIM_SCATTER_UV, 0),
                                       u1(smp.DIM_SCATTER_UV, 1))
                w2 = to_world(s_wlx, s_wly, s_wlz)
            cos2a = torch.abs(w2[0] * nx + w2[1] * ny + w2[2] * nz)
            f2 = (sf_r * cos2a, sf_g * cos2a, sf_b * cos2a)
            if n_area > 0:
                hit_l, t_hit, pdf_l2 = area.query(*w2)
            else:
                hit_l = torch.zeros_like(hit)
                t_hit = pdf_l2 = zero
            f_any = (f2[0] > 0.0) | (f2[1] > 0.0) | (f2[2] > 0.0)
            valid_b = torch.zeros_like(hit)
            if n_area > 0:
                w_b = s_pdf * s_pdf / torch.clamp_min(
                    s_pdf * s_pdf + pdf_l2 * pdf_l2, 1e-30)
                # Delta-sampled directions are left to the
                # emission-after-specular rule.
                valid_b = (arm_area & hit_l & ~s_delta & (s_pdf > 0.0)
                           & (pdf_l2 > 0.0) & f_any & alive)
                cb_ = torch.where(valid_b, w_b * _weak_recip(s_pdf), 0.0)
                for ch, b, f, e in zip("rgb", beta, f2, area.le):
                    out["c2" + ch] = torch.where(
                        alive, b * f * e * cb_ * n_lights, 0.0)
            valid_e = torch.zeros_like(hit)
            if tab.has_env:
                # The env radiance (and its MIS weight under env-IS)
                # applies outside: emit beta * f2 / s_pdf * n_lights and
                # the BSDF pdf.
                valid_e = arm_env & ~s_delta & (s_pdf > 0.0) & alive
                ce_ = torch.where(valid_e, _weak_recip(s_pdf), 0.0)
                for ch, b, f in zip("rgb", beta, f2):
                    out["ec" + ch] = torch.where(alive, b * f * ce_ * n_lights,
                                                 0.0)
                out["spdf"] = torch.where(valid_e, s_pdf, 0.0)
            if folded:
                out["s2t"] = torch.where(valid_b, t_hit, 0.0)
            else:
                dir2 = [torch.where(arm_env, w, t_hit * w) for w in w2]
                side2 = torch.where(dir2[0] * nx + dir2[1] * ny
                                    + dir2[2] * nz >= 0.0, 1.0, -1.0)
                out.update(s2d0=dir2[0], s2d1=dir2[1], s2d2=dir2[2],
                           s2t=torch.where(valid_e, INF, torch.where(
                               valid_b, SHADOW_T, 0.0)), s2side=side2)

    # ---- continuation: throughput update, Russian roulette ----
    cosn = torch.abs(wnx * nx + wny * ny + wnz * nz)
    f_any = (bf_r > 0.0) | (bf_g > 0.0) | (bf_b > 0.0)
    alive = alive & (b_pdf > 0.0) & f_any
    mult = cosn * _weak_recip(b_pdf)
    nb = [torch.where(alive, b * f * mult, b)
          for b, f in zip(beta, (bf_r, bf_g, bf_b))]
    if rr_on:
        lum = 0.21267127 * nb[0] + 0.71515972 * nb[1] + 0.07216883 * nb[2]
        q = torch.clamp_min(1.0 - lum, 0.05)
        alive = alive & ~(u1(smp.DIM_RUSSIAN_ROULETTE) < q)
        scale = torch.where(alive, 1.0 / torch.clamp_min(1.0 - q, 1e-6), 1.0)
        nb = [b * scale for b in nb]
    nside = torch.where(wnx * nx + wny * ny + wnz * nz >= 0.0, 1.0, -1.0)
    planes = (*rad, out["s1d0"], out["s1d1"], out["s1d2"], out["s1t"],
              out["s1side"], out["c1r"], out["c1g"], out["c1b"], out["s2d0"],
              out["s2d1"], out["s2d2"], out["s2t"], out["s2side"], out["c2r"],
              out["c2g"], out["c2b"], out["ecr"], out["ecg"], out["ecb"],
              out["spdf"], wnx, wny, wnz, nside, *nb)
    # A lane that enters dead passes through: zeros, its incoming dir and
    # beta.
    live = alive_i > 0
    through = [zero] * 23 + [rdx, rdy, rdz, zero, *beta]
    fout = torch.stack([torch.where(live, a, b)
                        for a, b in zip(planes, through)])
    iout = torch.stack([alive.to(torch.int32),
                        (alive & b_delta).to(torch.int32)])
    return fout, iout, n_shadow


# ------------------------------ CUDA kernel -------------------------------


def _check(tab, fin, iin, count):
    dev = tab.mats.device
    n = fin.shape[1] if fin.dim() == 2 else -1
    ok = (fin.dtype == torch.float32 and fin.dim() == 2
          and fin.shape[0] == tab.n_in and fin.is_contiguous()
          and fin.device == dev and iin.dtype == torch.int32
          and tuple(iin.shape) == (N_INT, n) and iin.is_contiguous()
          and iin.device == dev and count.dtype == torch.int64
          and tuple(count.shape) == (1,) and count.device == dev)
    for t in (tab.mats, tab.lights, tab.delta):
        ok = ok and (t.dtype == torch.float32 and t.device == dev
                     and t.is_contiguous())
    ok = ok and (tab.mat_class.dtype == torch.int32
                 and tab.mat_class.device == dev
                 and tuple(tab.mat_class.shape) == (tab.mats.shape[0] + 1,))
    if not ok:
        raise ValueError(
            f"shade wants contiguous tensors on the tables' device: fin "
            f"float32 [{tab.n_in}, N], iin int32 [{N_INT}, N], count int64 "
            "[1], float32 tables, int32 mat_class [M + 1]")
    if not 1 <= tab.n_slots <= MAX_SLOTS:
        raise ValueError(f"{tab.n_slots} lobe slots; K4 takes 1-{MAX_SLOTS}")


def _tex_slot_mask(tab):
    return sum(1 << s for s in tab.textured_slots)


def shade(tab: WaveTables, fin, iin, count, *, seed, bounce, first, rr_on,
          rng="pcg", folded=False):
    """One shade pass: returns (fout [30, N], iout [2, N]) and adds the
    bounce's shadow-ray count to `count` (int64 [1]). CUDA tensors launch
    K4, CPU tensors take shade_reference."""
    global LAUNCHES
    kind = fin.device.type
    if kind == "cpu":
        fout, iout, n_shadow = shade_reference(
            tab, fin, iin, seed=seed, bounce=bounce, first=first, rr_on=rr_on,
            rng=rng, folded=folded)
        count += n_shadow
        return fout, iout
    if kind != "cuda":
        raise ValueError(f"no shade kernel for device {fin.device}")
    _check(tab, fin, iin, count)
    n = fin.shape[1]
    fout = torch.empty((N_OUT, n), dtype=torch.float32, device=fin.device)
    iout = torch.empty((2, n), dtype=torch.int32, device=fin.device)
    if n == 0:
        return fout, iout
    seed_c = int(seed) & smp.MASK32
    seed_c = seed_c - (1 << 32) if seed_c >= (1 << 31) else seed_c
    stream = torch.cuda.current_stream(fin.device).cuda_stream
    rc = kernels.lib().pbrs_fused_wave(
        tab.mats.data_ptr(), tab.mats.shape[0], tab.mats.shape[1],
        tab.n_slots, tab.mat_class.data_ptr(), tab.n_classes,
        tab.lights.data_ptr(), tab.n_area,
        tab.delta.data_ptr(), tab.n_delta, tab.world_radius,
        int(tab.has_env), int(tab.env_is), _tex_slot_mask(tab),
        fk.RNG_CODES[rng], int(bool(folded)), seed_c, int(bounce),
        int(bool(first)), int(bool(rr_on)), fin.data_ptr(), fin.shape[0],
        iin.data_ptr(), n, fout.data_ptr(), iout.data_ptr(),
        count.data_ptr(), stream)
    kernels.check(rc, "fused_wave")
    LAUNCHES += 1
    return fout, iout


KERNEL_INFO = ("registers", "local_bytes", "warps_per_sm", "smem_bytes",
               "threads", "window", "staged_planes")


def kernel_info(tab: WaveTables) -> dict:
    """The K4 kernel that launches on these tables, as built and as it fits
    an SM of the current card: registers and local memory (spill and stack)
    bytes a thread, resident warps an SM, dynamic shared memory a block,
    threads a block, lanes a block regroups and output planes it stages in
    shared memory (KERNEL_INFO). CUDA only."""
    import ctypes

    info = (ctypes.c_int * len(KERNEL_INFO))()
    rc = kernels.lib().pbrs_fused_wave_info(
        tab.n_slots, tab.mats.shape[0], tab.mats.shape[1],
        ctypes.cast(info, ctypes.c_void_p))
    kernels.check(rc, "fused_wave_info")
    return dict(zip(KERNEL_INFO, info))


def _pend_contrib(pend, hit, env_here, p_env):
    """A folded pending resolved against this bounce's closest hit: the env
    leg pays where the ray escaped, the area leg where nothing closer than
    the chosen light was hit. With p_env (env-IS) the env leg's MIS weight
    applies here; the BSDF pdf rides the env lanes' t_light."""
    coeff, t_light, is_env = pend["coeff"], pend["t_light"], pend["is_env"]
    vis_area = hit.t >= t_light * (1.0 - 1e-3)
    okp = torch.where(is_env, ~hit.hit, (t_light > 0.0) & vis_area)
    env_term = coeff * env_here
    if p_env is not None:
        w_e = t_light * t_light / torch.clamp_min(
            t_light * t_light + p_env * p_env, 1e-30)
        env_term = env_term * torch.where(is_env, w_e, 1.0)[:, None]
    pc = torch.where(is_env[:, None], env_term, coeff)
    return torch.where(okp[:, None], pc, 0.0)


# ---------------------------- the bounce loop -------------------------------


class FusedWaveIntegrator:
    """The wave bounce loop (the scene must pass scene_supports_wave, and
    scene_supports_wave_folded when folded): per bounce, a closest-hit
    trace through dispatch, the outside evaluations, one K4 launch, one
    occlusion launch for the shadow batches and the apply step. The loop
    stays on the host.

    folded: PBRT's one-sample fold of NEE. The BSDF-sampled MIS arm rides
    the continuation ray, so a bounce traces one shadow batch, and its
    pending contribution is resolved by the next bounce's closest hit (one
    epilogue trace resolves the last bounce's).

    trace_fns: the scene's (intersect_fn, occlude_fn) built already
    (``dispatch.make_trace_fns(scene, True)``), in place of a tracer of its
    own."""

    def __init__(self, scene, bvh_threshold: int | None = None,
                 folded: bool = False, trace_fns=None):
        if folded and not scene_supports_wave_folded(scene):
            raise ValueError(
                "wave folded NEE does not support Fourier materials; use "
                "folded=False or the general path")
        self.scene = scene
        self.folded = bool(folded)
        self.tables = WaveTables.from_scene(scene)
        self.has_fourier = lb.FOURIER in self.tables.present_kinds
        self.intersect_fn, self.occlude_fn = (
            trace_fns or trace_dispatch.make_trace_fns(scene, True,
                                                      bvh_threshold))

    def _env(self, dirs):
        """(env radiance, distribution pdf or None) along dirs: folded
        env-IS takes both from one texel lookup."""
        env = self.scene.env
        if self.folded and self.tables.env_is:
            return es.eval_env_pdf(env, dirs)
        return lt.eval_env(env, dirs), None

    def _shade_pass(self, sampler, rays, pix, samp, beta, alive, spec,
                    bounce, rr_start, count):
        """A bounce up to its apply step: the closest hit, the outside
        evaluations, one K4 launch and the Fourier override. beta [3, N]
        planes, pix / samp / alive / spec int32 [N]. Returns (hit, env
        radiance, env pdf or None, fout, iout); K4 adds the shadow-ray
        count to `count`."""
        scene, tab = self.scene, self.tables
        hit = self.intersect_fn(rays)
        env_here, p_env = self._env(rays.dir)
        planes = [rays.dir.T, hit.pos.T, hit.normal.T, hit.dpdu.T,
                  env_here.T]
        safe = torch.clamp_min(hit.mat_id, 0).to(torch.int64)
        for s in tab.textured_slots:
            planes.append(tex.eval_texture(
                scene.textures, tab.tex_id[:, s][safe], hit.uv, hit.pos).T)
        if tab.env_is:
            u_light = sampler.u2(pix, samp, bounce, smp.DIM_LIGHT_UV)
            e_dir, e_rad, e_pdf = es.sample_env(scene.env.dist, u_light)
            planes += [e_dir.T, e_rad.T, e_pdf[None]]
        fin = torch.cat(planes + [beta]).contiguous()
        iin = torch.stack([hit.mat_id.to(torch.int32),
                           hit.hit.to(torch.int32), alive, spec, pix,
                           samp]).contiguous()
        fout, iout = shade(tab, fin, iin, count, seed=sampler.seed,
                           bounce=bounce, first=bounce == 0,
                           rr_on=bounce > rr_start, rng=fk.rng_kind(sampler),
                           folded=self.folded)
        if self.has_fourier:
            fout, iout = self._fourier_override(
                sampler, hit, pix, samp, bounce, beta.T, alive > 0, rr_start,
                fout, iout)
        return hit, env_here, p_env, fout, iout

    def _fourier_override(self, sampler, hit, pix, samp, bounce, beta3,
                          alive, rr_start, fout, iout):
        """Lanes whose material carries a FOURIER lobe, shaded outside K4 by
        the general path's functions (bsdf.sample_bsdf,
        nee.uniform_sample_one_light, whose occlusion traces through the
        scene's tracer) on the same counter draws, and written over K4's
        planes: radiance plus their NEE, both shadow queries disarmed
        (t_max 0, coefficients 0), the continuation, beta after roulette,
        alive and spec. Returns (fout, iout)."""
        scene = self.scene
        lobes, _ = mat_mod.shading_at(scene.materials, scene.textures,
                                      hit.mat_id, hit.uv, hit.pos)
        fmask = (lobes.kind == lb.FOURIER).any(dim=-1) & hit.hit
        alive_hit = alive & hit.hit
        gate = fmask & alive_hit
        frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
        u_bsdf = sampler.u2(pix, samp, bounce, smp.DIM_BSDF_UV)
        f, wi, pdf, is_delta = bsdf_mod.sample_bsdf(lobes, frame, hit.wo,
                                                    u_bsdf)
        l_direct = torch.zeros_like(wi)
        if scene.num_lights > 0:
            l_direct = nee.uniform_sample_one_light(
                scene, lobes, frame, hit.pos, hit.normal, hit.wo,
                sampler.u1(pix, samp, bounce, smp.DIM_LIGHT_SELECT),
                sampler.u2(pix, samp, bounce, smp.DIM_LIGHT_UV),
                sampler.u2(pix, samp, bounce, smp.DIM_SCATTER_UV),
                occlude_fn=self.occlude_fn, alive=gate)
        cos_term = torch.abs(vm.dot(wi, frame.n))
        step_ok = (pdf > 0.0) & ((f[..., 0] > 0.0) | (f[..., 1] > 0.0)
                                 | (f[..., 2] > 0.0))
        alive_f = alive_hit & step_ok
        beta_f = torch.where(
            alive_f[..., None],
            beta3 * f * (cos_term * vm.weak_recip(pdf))[..., None], beta3)
        if bounce > rr_start:
            q = torch.clamp_min(1.0 - vm.luminance(beta_f), 0.05)
            u_rr = sampler.u1(pix, samp, bounce, smp.DIM_RUSSIAN_ROULETTE)
            alive_f = alive_f & ~(u_rr < q)
            beta_f = beta_f * torch.where(
                alive_f, 1.0 / torch.clamp_min(1.0 - q, 1e-6), 1.0)[..., None]
        side = torch.where(vm.dot(wi, hit.normal) >= 0.0, 1.0, -1.0)
        contrib = torch.where(gate[..., None], beta3 * l_direct, 0.0)
        new = fout.clone()
        new[0:3] = fout[0:3] + contrib.T
        # Shadow queries disarmed: s1 t_max and c1, s2 t_max, c2, the env
        # coefficient and the BSDF pdf.
        for k in (6, 8, 9, 10, 14, 16, 17, 18, 19, 20, 21, 22):
            new[k] = 0.0
        new[23:26] = wi.T
        new[26] = side
        new[27:30] = beta_f.T
        fout = torch.where(fmask, new, fout)
        iout = torch.where(fmask, torch.stack([
            alive_f.to(torch.int32), (alive_f & is_delta).to(torch.int32)]),
            iout)
        return fout, iout

    def render_samples(self, sampler, pixel_idx, sample_idx, max_depth=5,
                       msaa=2, rr_start=3, schedule=None, resort=False):
        """(radiance [N,3], traced-ray count) for a (pixel, sample) batch:
        rays with a live extent at each closest hit, plus a shadow ray per
        lane alive after its hit for each shadow batch (2, or 1 folded)
        when the scene has lights, summed on the device.

        schedule (per-bounce lane capacities, schedule[0] >= N; the batch
        must tile into wavefront.COMPACT_BLOCK blocks) compacts the lanes
        between bounces (``wavefront.compact_step``), so K4 and the
        tracers launch on the reduced lane count. Each lane banks its
        contributions onto its original row in the masked loop's order, so
        with every block kept (p = 1) its radiance and the count are the
        masked loop's. resort sorts the lanes' blocks spatially at each
        bounce from the second on where nothing shrinks (schedule None
        keeps all N lanes), as pbrs_tpu/accel/fused_wave.py:1555-1558
        does."""
        fk.rng_kind(sampler)  # a sampler K4 cannot draw raises here
        scene = self.scene
        rays = wavefront.camera_rays(scene, sampler, pixel_idx, sample_idx,
                                     msaa)
        n = rays.n
        dev = rays.origin.device
        pix = pixel_idx.to(torch.int32)
        samp = torch.full((n,), int(sample_idx), dtype=torch.int32,
                          device=dev)
        beta = torch.ones(3, n, device=dev)
        alive = torch.ones(n, dtype=torch.int32, device=dev)
        spec = torch.zeros(n, dtype=torch.int32, device=dev)
        radiance = torch.zeros(n, 3, device=dev)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        pend = None
        orig, bank = None, wavefront._add
        for bounce in range(max_depth):
            with profiling.span("pbrs.bounce"):
                if schedule is not None or resort:
                    (rays, beta3, pix, samp, orig, spec_b, alive_b, pend,
                     bank) = wavefront.compact_step(
                        schedule, bounce, n, sampler, rays, beta.T, pix,
                        samp, orig, spec > 0, alive > 0, pend, bank, resort)
                    beta = beta3.T.contiguous()
                    alive = alive_b.to(torch.int32)
                    spec = spec_b.to(torch.int32)
                profiling.count_lanes(alive, rays.n)
                count += (rays.t_max > 0.0).sum()
                hit, env_here, p_env, fout, iout = self._shade_pass(
                    sampler, rays, pix, samp, beta, alive, spec, bounce,
                    rr_start, count)
                t_next = torch.where(iout[0] > 0, INF, 0.0)
                if self.folded:
                    radiance, pend, t_next = self._apply_folded(
                        radiance, hit, fout, env_here, p_env, pend, t_next,
                        bank)
                else:
                    radiance = self._apply(radiance, hit, fout, bank)
                rays = self._next_rays(hit, fout, t_next)
                beta = fout[27:30]
                alive, spec = iout[0], iout[1]
        if self.folded and pend is not None:
            radiance = self._epilogue(pend, rays, radiance, count, bank)
        return radiance, count[0]

    def _next_rays(self, hit, fout, t_next):
        return ray_mod.RayBatch(
            origin=hit.pos + fout[26][:, None] * hit.normal * SPAWN_EPS,
            dir=fout[23:26].T, t_max=t_next)

    def _epilogue(self, pend, rays, radiance, count, bank):
        """One bounded closest hit resolves the last bounce's pending."""
        pend_valid = pend["is_env"] | (pend["t_light"] > 0.0)
        e_tmax = torch.where(pend["is_env"], rays.t_max,
                             pend["t_light"] * (1.0 + 1e-3))
        rays = rays.replace(t_max=torch.where(pend_valid, e_tmax, 0.0))
        count += (rays.t_max > 0.0).sum()
        hit = self.intersect_fn(rays)
        env_here, p_env = self._env(rays.dir)
        return bank(radiance, _pend_contrib(pend, hit, env_here, p_env))

    def _shadow_origin(self, hit, side):
        return hit.pos + side[:, None] * hit.normal * SPAWN_EPS

    def _apply(self, radiance, hit, fout, bank):
        """radiance + this bounce's: emission, c1 unless shadow 1 is
        occluded, c2 + env coefficient x env radiance unless shadow 2 is,
        each added by `bank` in that order; both shadow batches go through
        one occlusion launch."""
        scene = self.scene
        n = hit.pos.shape[0]
        d1, d2 = fout[3:6].T, fout[11:14].T
        t1, t2 = fout[6], fout[14]
        occ = self.occlude_fn(ray_mod.RayBatch(
            origin=torch.cat([self._shadow_origin(hit, fout[7]),
                              self._shadow_origin(hit, fout[15])]),
            dir=torch.cat([d1, d2]), t_max=torch.cat([t1, t2])))
        occ1 = occ[:n] & (t1 > 0.0)
        occ2 = occ[n:] & (t2 > 0.0)
        ec = fout[19:22].T
        if self.tables.env_is:
            # MIS against the env distribution on the BSDF-sampled arm.
            env2, p_e = es.eval_env_pdf(scene.env, d2)
            p_b = fout[22]
            w_e = p_b * p_b / torch.clamp_min(p_b * p_b + p_e * p_e, 1e-30)
            ec = ec * torch.where(p_b > 0.0, w_e, 0.0)[:, None]
        else:
            env2 = lt.eval_env(scene.env, d2)
        radiance = bank(radiance, fout[0:3].T)
        radiance = bank(radiance, torch.where(occ1[:, None], 0.0,
                                              fout[8:11].T))
        return bank(radiance, torch.where(occ2[:, None], 0.0,
                                          fout[16:19].T + ec * env2))

    def _apply_folded(self, radiance, hit, fout, env_here, p_env, pend,
                      t_next, bank):
        """The folded apply step: resolve the previous bounce's pending
        against this hit, add emission and c1 unless shadow 1 (one
        occlusion launch) is occluded, each by `bank`; return the radiance,
        this bounce's pending (the area coefficient c2 with the light's
        distance in s2t, or the env coefficient with the BSDF pdf in
        t_light under env-IS) and the next rays' extents (a dead lane owing
        a pending keeps one bounded resolution segment)."""
        if pend is not None:
            radiance = bank(radiance,
                            _pend_contrib(pend, hit, env_here, p_env))
        t1 = fout[6]
        occ1 = self.occlude_fn(ray_mod.RayBatch(
            origin=self._shadow_origin(hit, fout[7]), dir=fout[3:6].T,
            t_max=t1)) & (t1 > 0.0)
        radiance = bank(radiance, fout[0:3].T)
        radiance = bank(radiance, torch.where(occ1[:, None], 0.0,
                                              fout[8:11].T))
        t_light = fout[14]
        is_env = (fout[22] > 0.0 if self.tables.has_env
                  else torch.zeros_like(t_light, dtype=torch.bool))
        if self.tables.env_is:
            t_light = torch.where(is_env, fout[22], t_light)
        pend = {"coeff": fout[16:19].T + fout[19:22].T, "t_light": t_light,
                "is_env": is_env}
        owed = torch.where(is_env, INF, torch.where(
            t_light > 0.0, t_light * (1.0 + 1e-3), 0.0))
        return radiance, pend, torch.where(t_next > 0.0, t_next, owed)
