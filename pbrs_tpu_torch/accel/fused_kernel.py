"""Fused per-bounce megakernel for diffuse table scenes (kernel K2).
Mirrors pbrs_tpu/accel/fused_kernel.py: ``scene_supports_fused``,
``rng_kind``, ``_bounce_kernel`` and ``FusedDiffuseIntegrator``.

One launch runs a whole wavefront bounce: closest hit over the primitive
bank, sphere/quad hit detail, shading frame, albedo/emission fetch, the
environment, one-light quad NEE with MIS and both shadow sweeps, cosine
BSDF sampling, Russian roulette and the next-ray spawn. The CUDA kernel
(``csrc/fused_bounce.cu``) runs one thread per lane; ``bounce_reference``
is the same bounce as a tensor program, op for op. ``bounce`` takes the
kernel for CUDA tensors and the plain version for CPU tensors.

The sampler stream is PCG or Owen-scrambled Sobol', drawn in-kernel
bit-identically to ``core.sampler.PCGSampler`` / ``SobolSampler``
(``_u1``); a threefry sampler takes the general wavefront.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..bxdf import lobes as lb
from ..core import sampler as smp
from ..geometry import ray as ray_mod
from ..integrators import wavefront
from ..lights import lights as lt
from ..lights import sample_shape as ss
from . import trace_kernel as tk

T_MIN = ray_mod.T_MIN
BIG = tk.BIG
INF = float("inf")
SPAWN_EPS = ray_mod.SPAWN_EPS
INV_PI = 1.0 / math.pi
N_IN, N_OUT = 9, 12  # float planes in / out (see bounce_reference)

# Kernel launches since the last reset.
LAUNCHES = 0


def scene_supports_fused(scene) -> bool:
    """Eligibility: Lambert-only solid materials, quad area lights, a
    none/const/gradient environment, spheres and quads only."""
    mt = scene.materials
    if tuple(mt.present_kinds) not in ((lb.LAMBERT,), ()):
        return False
    if mt.textured_slots:
        return False
    if scene.delta_lights.count > 0:
        return False
    al = scene.area_lights
    if al.count > 0:
        kinds = set(al.shape_kind[:al.count].tolist())
        if kinds - {ss.QUAD}:
            return False
    if scene.env.kind not in (lt.ENV_NONE, lt.ENV_CONST, lt.ENV_GRADIENT):
        return False
    if mt.kind.shape[0] > 64:
        return False
    # The detail pass covers spheres and quads only: a real (non-degenerate)
    # triangle or disk takes the general path.
    geom = scene.geom
    tri_n = np.cross((geom.tri_p0 - geom.tri_p1).cpu().numpy(),
                     (geom.tri_p2 - geom.tri_p1).cpu().numpy())
    if (np.linalg.norm(tri_n, axis=-1) > 0).any():
        return False
    if (np.linalg.norm(geom.disk_radial.cpu().numpy(), axis=-1) > 0).any():
        return False
    return True


# The kernels' `rng` launch argument.
RNG_CODES = {"pcg": 0, "sobol": 1}


def rng_kind(sampler) -> str:
    """The in-kernel stream for a sampler: "pcg" or "sobol"."""
    if isinstance(sampler, smp.SobolSampler):
        return "sobol"
    if isinstance(sampler, smp.PCGSampler):
        return "pcg"
    raise TypeError(
        f"the fused kernels reproduce the PCG / Sobol' streams in-kernel; "
        f"{type(sampler).__name__} must use the general wavefront")


def _u1(seed, pix, samp, bounce, dim, lane=0, rng="pcg"):
    """The in-kernel uniform draw. rng "pcg" is PCGSampler.u1(..., lane);
    rng "sobol" keys both Sobol' hashes with lane 0 and takes Sobol'
    dimension `lane`: lane 0 is SobolSampler.u1 and u2's first component,
    lane 1 u2's second."""
    if rng == "pcg":
        bits = smp.hash_u32(seed, pix, samp, bounce * 16 + dim, lane)
    else:
        bits = smp.sobol_bits(seed, pix, samp, bounce, dim, 0, lane)
    return smp.uniform_from_u32(bits)


@dataclass
class FusedTables:
    """The scene as the bounce kernel reads it."""

    bank: torch.Tensor  # [P,16] prim bank, column 13 = material id
    counts: tuple  # bank rows per family (spheres, quads, tris, disks)
    mats: torch.Tensor  # [M,6] albedo rgb + emission rgb
    lights: torch.Tensor  # [max(A,1),12] quad origin/u/v + emit rgb
    env: torch.Tensor  # [6] env color a (top/const) + color b (bottom)
    n_area: int
    env_kind: int

    @staticmethod
    def from_scene(scene) -> "FusedTables":
        geom = scene.geom
        bank, counts = tk.prim_scalars(geom)
        bank[:, 13] = torch.cat([geom.sph_mat, geom.quad_mat, geom.tri_mat,
                                 geom.disk_mat]).to(torch.float32)
        mt = scene.materials
        mats = torch.cat([mt.albedo[:, 0, :], mt.emission], dim=1)
        al = scene.area_lights
        n_area = al.count
        if n_area:
            lights = torch.cat([al.p0[:n_area], al.p1[:n_area],
                                al.p2[:n_area], al.emit[:n_area]], dim=1)
        else:
            lights = torch.zeros(1, 12, device=bank.device)
        env = torch.cat([scene.env.color_a, scene.env.color_b])
        return FusedTables(bank.contiguous(), counts,
                           mats.to(torch.float32).contiguous(),
                           lights.to(torch.float32).contiguous(),
                           env.to(torch.float32).contiguous(), n_area,
                           scene.env.kind)

    @property
    def n_lights(self):
        return self.n_area + (1 if self.env_kind != lt.ENV_NONE else 0)


# ------------------------------ plain version -----------------------------


def _concentric_disk(x, y):
    """Uniform unit-disk map on [-1,1]^2 (Shirley-Chiu)."""
    big = torch.abs(x) > torch.abs(y)
    r = torch.where(big, x, y)
    xs = torch.where(x == 0.0, 1.0, x)
    ys = torch.where(y == 0.0, 1.0, y)
    theta = torch.where(big, (math.pi / 4.0) * (y / xs),
                        (math.pi / 2.0) - (math.pi / 4.0) * (x / ys))
    px = r * torch.cos(theta)
    py = r * torch.sin(theta)
    deg = (x == 0.0) & (y == 0.0)
    return torch.where(deg, 0.0, px), torch.where(deg, 0.0, py)


def _env_along(tab, x, y, z):
    """Environment radiance along direction planes."""
    e = tab.env
    if tab.env_kind == lt.ENV_GRADIENT:
        dl = torch.rsqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
        yy = (y * dl + 1.0) * 0.5
        return tuple(e[i] * yy + e[i + 3] * (1.0 - yy) for i in range(3))
    if tab.env_kind == lt.ENV_CONST:
        return tuple(torch.ones_like(x) * e[i] for i in range(3))
    return (torch.zeros_like(x),) * 3


def _occluded(tab, ox, oy, oz, dx, dy, dz, t_max):
    t, _ = tk.sweep_reference(tab.bank, tab.counts, ox, oy, oz, dx, dy, dz,
                              t_max)
    return t < BIG


def bounce_reference(tab: FusedTables, fin, alive_in, pix, samp, *, seed,
                     bounce, bounce_is_first, rr_active, rng="pcg"):
    """Plain version of K2: one bounce over N lanes.

    fin [9,N] float32: origin xyz, dir xyz, beta rgb; alive_in, pix, samp
    [N] int32. Returns (fout [12,N]: radiance delta rgb, next origin xyz,
    next dir xyz, next beta rgb; alive_out [N] int32; traced-ray count, an
    int64 scalar: alive lanes, plus 2 x the lanes alive after the hit when
    the scene has lights). A dead lane passes its origin, dir and beta
    through with zero radiance."""
    ox, oy, oz, dx, dy, dz, br, bg, bb = fin
    live = alive_in > 0
    rox, roy, roz, rdx, rdy, rdz = ox, oy, oz, dx, dy, dz
    pixu = pix.to(torch.int64) & smp.MASK32
    smpu = samp.to(torch.int64) & smp.MASK32

    def u1(dim, lane=0):
        return _u1(seed, pixu, smpu, bounce, dim, lane, rng)

    zero = torch.zeros_like(rox)
    n_rays = live.sum()

    # ---- closest hit + sphere/quad detail ----
    t, pid = tk.sweep_reference(tab.bank, tab.counts, rox, roy, roz, rdx,
                                rdy, rdz, torch.full_like(rox, INF))
    hit = t < BIG
    t_safe = torch.where(hit, t, 1.0)
    px = rox + t_safe * rdx
    py = roy + t_safe * rdy
    pz = roz + t_safe * rdz
    n_sph, n_quad = tab.counts[0], tab.counts[1]
    is_sph = (pid >= 0) & (pid < n_sph)
    is_quad = (pid >= n_sph) & (pid < n_sph + n_quad)
    row = tab.bank[torch.clamp_min(pid, 0)]
    col = lambda j: row[:, j]  # noqa: E731

    cx, cy, cz, r = col(0), col(1), col(2), col(3)
    gx, gy, gz = px - cx, py - cy, pz - cz
    inv = torch.rsqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-30))
    sux, suy, suz = gx * inv, gy * inv, gz * inv
    h2 = sux * sux + suy * suy
    hinv = torch.rsqrt(torch.clamp_min(h2, 1e-30))
    s_tx = torch.where(h2 < 1e-12, 1.0, -suy * hinv)
    s_ty = torch.where(h2 < 1e-12, 0.0, sux * hinv)
    s_s = torch.where(sux * rdx + suy * rdy + suz * rdz > 0.0, -1.0, 1.0)
    r_out = r * 1.00001

    qnx, qny, qnz = col(9), col(10), col(11)
    qinv = torch.rsqrt(torch.clamp_min(qnx * qnx + qny * qny + qnz * qnz,
                                       1e-30))
    qux, quy, quz = qnx * qinv, qny * qinv, qnz * qinv
    q_s = torch.where(qux * rdx + quy * rdy + quz * rdz > 0.0, -1.0, 1.0)

    def pick(sph_val, quad_val, default):
        return torch.where(is_sph, sph_val,
                           torch.where(is_quad, quad_val, default))

    nx = pick(s_s * sux, q_s * qux, 0.0)
    ny = pick(s_s * suy, q_s * quy, 0.0)
    nz = pick(s_s * suz, q_s * quz, 1.0)
    tx = pick(s_tx, col(3), 1.0)
    ty = pick(s_ty, col(4), 0.0)
    tz = pick(zero, col(5), 0.0)
    px = torch.where(is_sph, cx + sux * r_out, px)
    py = torch.where(is_sph, cy + suy * r_out, py)
    pz = torch.where(is_sph, cz + suz * r_out, pz)
    mat_id = torch.where(is_sph | is_quad, col(13).to(torch.int32), -1)

    # ---- shading frame (orthonormal_frame with the Duff fallback) ----
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

    # ---- material fetch (albedo + emission) ----
    n_mats = tab.mats.shape[0]
    m_ok = (mat_id >= 0) & (mat_id < n_mats)
    mrow = tab.mats[torch.clamp(mat_id, 0, n_mats - 1).to(torch.int64)]
    alb_r, alb_g, alb_b, emi_r, emi_g, emi_b = (
        torch.where(m_ok, mrow[:, j], 0.0) for j in range(6))

    rad_r, rad_g, rad_b = zero, zero, zero
    if bounce_is_first:
        # Emission only on camera segments (no delta lobes here).
        env_r, env_g, env_b = _env_along(tab, rdx, rdy, rdz)
        rad_r = rad_r + torch.where(live, br * torch.where(hit, emi_r, env_r),
                                    0.0)
        rad_g = rad_g + torch.where(live, bg * torch.where(hit, emi_g, env_g),
                                    0.0)
        rad_b = rad_b + torch.where(live, bb * torch.where(hit, emi_b, env_b),
                                    0.0)

    alive = live & hit

    # ---- NEE: one light among n_area (+ env) ----
    n_lights = tab.n_lights
    if n_lights > 0:
        u_sel = u1(smp.DIM_LIGHT_SELECT)
        u_l0 = u1(smp.DIM_LIGHT_UV, 0)
        u_l1 = u1(smp.DIM_LIGHT_UV, 1)
        u_s0 = u1(smp.DIM_SCATTER_UV, 0)
        u_s1 = u1(smp.DIM_SCATTER_UV, 1)
        chosen = torch.clamp_max((u_sel * n_lights).to(torch.int32),
                                 n_lights - 1)
        arm_area = chosen < tab.n_area
        arm_env = ~arm_area
        a_max = tab.lights.shape[0] - 1
        lrow = tab.lights[torch.clamp(chosen, 0, a_max).to(torch.int64)]
        (lqx, lqy, lqz, lux, luy, luz, lvx, lvy, lvz, ler, leg, leb) = (
            torch.where(arm_area, lrow[:, j], 0.0) for j in range(12))

        lnx = luy * lvz - luz * lvy
        lny = luz * lvx - lux * lvz
        lnz = lux * lvy - luy * lvx
        ln2 = torch.clamp_min(lnx * lnx + lny * lny + lnz * lnz, 1e-30)
        area = torch.sqrt(ln2)
        inv_ln = torch.rsqrt(ln2)
        lnx_u, lny_u, lnz_u = lnx * inv_ln, lny * inv_ln, lnz * inv_ln

        # ---- light-sampled arm ----
        ptx = lqx + u_l0 * lux + u_l1 * lvx
        pty = lqy + u_l0 * luy + u_l1 * lvy
        ptz = lqz + u_l0 * luz + u_l1 * lvz
        wlx, wly, wlz = ptx - px, pty - py, ptz - pz
        d2 = torch.clamp_min(wlx * wlx + wly * wly + wlz * wlz, 1e-20)
        inv_d = torch.rsqrt(d2)
        wix, wiy, wiz = wlx * inv_d, wly * inv_d, wlz * inv_d
        cos_l = -(lnx_u * wix + lny_u * wiy + lnz_u * wiz)
        facing = cos_l > 0.0
        pdf_l = d2 / torch.clamp_min(torch.abs(cos_l) * area, 1e-20)
        cos_s = nx * wix + ny * wiy + nz * wiz
        fl = torch.clamp_min(cos_s, 0.0) * INV_PI
        pdf_scatter = torch.clamp_min(cos_s, 0.0) * INV_PI
        side = torch.where(cos_s >= 0.0, 1.0, -1.0)
        sox = px + side * nx * SPAWN_EPS
        soy = py + side * ny * SPAWN_EPS
        soz = pz + side * nz * SPAWN_EPS
        occ1 = _occluded(tab, sox, soy, soz, ptx - sox, pty - soy, ptz - soz,
                         torch.full_like(rox, 1.0 - 1e-3))
        w_l = pdf_l * pdf_l / torch.clamp_min(
            pdf_l * pdf_l + pdf_scatter * pdf_scatter, 1e-30)
        valid_l = arm_area & facing & ~occ1 & (pdf_l > 0.0)
        contrib = torch.where(valid_l, fl * w_l / pdf_l, 0.0)
        rad_r = rad_r + torch.where(
            alive, br * alb_r * contrib * ler * n_lights, 0.0)
        rad_g = rad_g + torch.where(
            alive, bg * alb_g * contrib * leg * n_lights, 0.0)
        rad_b = rad_b + torch.where(
            alive, bb * alb_b * contrib * leb * n_lights, 0.0)

        # ---- BSDF-sampled arm (area MIS + env) ----
        ddx, ddy = _concentric_disk(u_s1 * 2.0 - 1.0, u_s0 * 2.0 - 1.0)
        ddz = torch.sqrt(torch.clamp_min(1.0 - ddx * ddx - ddy * ddy, 0.0))
        w2x = ddx * fx_ + ddy * bx + ddz * nx
        w2y = ddx * fy_ + ddy * by + ddz * ny
        w2z = ddx * fz_ + ddy * bz + ddz * nz
        cos2 = torch.clamp_min(ddz, 0.0)
        pdf2 = cos2 * INV_PI
        f2 = cos2 * INV_PI

        denom = w2x * lnx_u + w2y * lny_u + w2z * lnz_u
        denom_s = torch.where(denom == 0.0, 1.0, denom)
        sgn = torch.where(cos2 >= 0, 1.0, -1.0)
        s2ox = px + sgn * nx * SPAWN_EPS
        s2oy = py + sgn * ny * SPAWN_EPS
        s2oz = pz + sgn * nz * SPAWN_EPS
        t_hit = ((lqx - s2ox) * lnx_u + (lqy - s2oy) * lny_u
                 + (lqz - s2oz) * lnz_u) / denom_s
        hxq = s2ox + t_hit * w2x - lqx
        hyq = s2oy + t_hit * w2y - lqy
        hzq = s2oz + t_hit * w2z - lqz
        cqx = hyq * lvz - hzq * lvy
        cqy = hzq * lvx - hxq * lvz
        cqz = hxq * lvy - hyq * lvx
        uu = (cqx * lnx + cqy * lny + cqz * lnz) / ln2
        cqx = luy * hzq - luz * hyq
        cqy = luz * hxq - lux * hzq
        cqz = lux * hyq - luy * hxq
        vv = (cqx * lnx + cqy * lny + cqz * lnz) / ln2
        hit_l = ((denom != 0.0) & (t_hit >= T_MIN) & (uu >= 0.0) & (uu <= 1.0)
                 & (vv >= 0.0) & (vv <= 1.0))
        pdf_l2 = (t_hit * t_hit) * (w2x * w2x + w2y * w2y + w2z * w2z) \
            / torch.clamp_min(torch.abs(lnx_u * w2x + lny_u * w2y
                                        + lnz_u * w2z) * area, 1e-20)
        # Bounded to the light point on the area arm, unbounded for env.
        tmax2 = torch.where(arm_area & hit_l, t_hit * (1.0 - 1e-3), INF)
        occ2 = _occluded(tab, s2ox, s2oy, s2oz, w2x, w2y, w2z, tmax2)
        w_b = pdf2 * pdf2 / torch.clamp_min(pdf2 * pdf2 + pdf_l2 * pdf_l2,
                                            1e-30)
        valid_b = arm_area & hit_l & ~occ2 & (pdf2 > 0.0) & (pdf_l2 > 0.0)
        contrib_b = torch.where(
            valid_b, f2 * w_b / torch.clamp_min(pdf2, 1e-20), 0.0)
        rad_r = rad_r + torch.where(
            alive, br * alb_r * contrib_b * ler * n_lights, 0.0)
        rad_g = rad_g + torch.where(
            alive, bg * alb_g * contrib_b * leg * n_lights, 0.0)
        rad_b = rad_b + torch.where(
            alive, bb * alb_b * contrib_b * leb * n_lights, 0.0)

        if tab.env_kind != lt.ENV_NONE:
            er2, eg2, eb2 = _env_along(tab, w2x, w2y, w2z)
            valid_e = arm_env & ~occ2 & (pdf2 > 0.0)
            contrib_e = torch.where(
                valid_e, f2 / torch.clamp_min(pdf2, 1e-20), 0.0)
            rad_r = rad_r + torch.where(
                alive, br * alb_r * contrib_e * er2 * n_lights, 0.0)
            rad_g = rad_g + torch.where(
                alive, bg * alb_g * contrib_e * eg2 * n_lights, 0.0)
            rad_b = rad_b + torch.where(
                alive, bb * alb_b * contrib_e * eb2 * n_lights, 0.0)

        n_rays = n_rays + 2 * alive.sum()

    # ---- BSDF sample for the next direction (cosine hemisphere) ----
    u_b0 = u1(smp.DIM_BSDF_UV, 0)
    u_b1 = u1(smp.DIM_BSDF_UV, 1)
    ddx, ddy = _concentric_disk(u_b1 * 2.0 - 1.0, u_b0 * 2.0 - 1.0)
    ddz = torch.sqrt(torch.clamp_min(1.0 - ddx * ddx - ddy * ddy, 0.0))
    wnx = ddx * fx_ + ddy * bx + ddz * nx
    wny = ddx * fy_ + ddy * by + ddz * ny
    wnz = ddx * fz_ + ddy * bz + ddz * nz
    # Throughput f*cos/pdf = albedo; zero-albedo or emissive-only lanes die.
    nonzero = (alb_r > 0.0) | (alb_g > 0.0) | (alb_b > 0.0)
    alive = alive & nonzero & (mat_id >= 0) & (ddz > 0.0)
    nbr = torch.where(alive, br * alb_r, br)
    nbg = torch.where(alive, bg * alb_g, bg)
    nbb = torch.where(alive, bb * alb_b, bb)

    if rr_active:
        lum = 0.21267127 * nbr + 0.71515972 * nbg + 0.07216883 * nbb
        q = torch.clamp_min(1.0 - lum, 0.05)
        alive = alive & ~(u1(smp.DIM_RUSSIAN_ROULETTE) < q)
        scale = torch.where(alive, 1.0 / torch.clamp_min(1.0 - q, 1e-6), 1.0)
        nbr, nbg, nbb = nbr * scale, nbg * scale, nbb * scale

    side = torch.where(wnx * nx + wny * ny + wnz * nz >= 0.0, 1.0, -1.0)
    out = (rad_r, rad_g, rad_b,
           px + side * nx * SPAWN_EPS, py + side * ny * SPAWN_EPS,
           pz + side * nz * SPAWN_EPS, wnx, wny, wnz, nbr, nbg, nbb)
    passthrough = (zero, zero, zero, ox, oy, oz, dx, dy, dz, br, bg, bb)
    fout = torch.stack([torch.where(live, a, b)
                        for a, b in zip(out, passthrough)])
    return fout, alive.to(torch.int32), n_rays


# ------------------------------ CUDA kernel -------------------------------


def _check_lanes(tab, fin, alive, pix, samp, count):
    dev = tab.bank.device
    n = fin.shape[1] if fin.dim() == 2 else -1
    ok = (fin.dtype == torch.float32 and fin.dim() == 2
          and fin.shape[0] == N_IN and fin.is_contiguous())
    for a in (alive, pix, samp):
        ok = ok and (a.dtype == torch.int32 and a.shape == (n,)
                     and a.is_contiguous() and a.device == dev)
    ok = ok and count.dtype == torch.int64 and count.shape == (1,)
    for tsr in (fin, count, tab.mats, tab.lights, tab.env):
        ok = ok and tsr.device == dev and tsr.is_contiguous()
    ok = ok and all(x.dtype == torch.float32
                    for x in (tab.mats, tab.lights, tab.env))
    if not ok:
        raise ValueError(
            "fused bounce wants contiguous tensors on the bank's device: fin "
            "float32 [9,N]; alive, pix, samp int32 [N]; count int64 [1]; "
            "float32 tables")


def bounce(tab: FusedTables, fin, alive, pix, samp, count, *, seed, bounce,
           bounce_is_first, rr_active, rng="pcg"):
    """One bounce: returns (fout [12,N], alive_out [N] int32) and adds the
    bounce's traced-ray count to `count` (int64 [1]). CUDA tensors launch
    K2, CPU tensors take bounce_reference."""
    global LAUNCHES
    kind = fin.device.type
    if kind == "cpu":
        fout, alive_out, n_rays = bounce_reference(
            tab, fin, alive, pix, samp, seed=seed, bounce=bounce,
            bounce_is_first=bounce_is_first, rr_active=rr_active, rng=rng)
        count += n_rays
        return fout, alive_out
    if kind != "cuda":
        raise ValueError(f"no fused bounce for device {fin.device}")
    tk._check_bank(tab.bank, tab.counts)
    _check_lanes(tab, fin, alive, pix, samp, count)
    if tab.env_kind not in (lt.ENV_NONE, lt.ENV_CONST, lt.ENV_GRADIENT):
        raise ValueError(f"env kind {tab.env_kind} is not fused-eligible")
    n = fin.shape[1]
    fout = torch.empty((N_OUT, n), dtype=torch.float32, device=fin.device)
    alive_out = torch.empty(n, dtype=torch.int32, device=fin.device)
    if n == 0:
        return fout, alive_out
    seed_c = int(seed) & smp.MASK32
    seed_c = seed_c - (1 << 32) if seed_c >= (1 << 31) else seed_c
    stream = torch.cuda.current_stream(fin.device).cuda_stream
    rc = kernels.lib().pbrs_fused_bounce(
        tab.bank.data_ptr(), *tab.counts, tab.mats.data_ptr(),
        tab.mats.shape[0], tab.lights.data_ptr(), tab.n_area,
        tab.env.data_ptr(), tab.env_kind, RNG_CODES[rng], seed_c,
        int(bounce), int(bool(bounce_is_first)), int(bool(rr_active)),
        fin.data_ptr(), alive.data_ptr(), pix.data_ptr(), samp.data_ptr(), n,
        fout.data_ptr(), alive_out.data_ptr(), count.data_ptr(), stream)
    kernels.check(rc, "fused_bounce")
    LAUNCHES += 1
    return fout, alive_out


class FusedDiffuseIntegrator:
    """Runs the fused bounce (the scene must pass
    scene_supports_fused). One launch per bounce; the loop stays on the
    host."""

    def __init__(self, scene):
        self.scene = scene
        self.tables = FusedTables.from_scene(scene)

    def render_samples(self, sampler, pixel_idx, sample_idx, max_depth=5,
                       msaa=2, rr_start=3):
        """(radiance [N,3], traced-ray count) for a (pixel, sample) batch."""
        rng = rng_kind(sampler)
        rays = wavefront.camera_rays(self.scene, sampler, pixel_idx,
                                     sample_idx, msaa)
        n = rays.n
        dev = rays.origin.device
        fin = torch.cat([rays.origin.T, rays.dir.T,
                         torch.ones(3, n, device=dev)]).contiguous()
        alive = torch.ones(n, dtype=torch.int32, device=dev)
        pix = pixel_idx.to(torch.int32).contiguous()
        samp = torch.as_tensor(sample_idx, dtype=torch.int32,
                               device=dev).expand(n).contiguous()
        radiance = torch.zeros(3, n, device=dev)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        for b in range(max_depth):
            fout, alive = bounce(
                self.tables, fin, alive, pix, samp, count, seed=sampler.seed,
                bounce=b, bounce_is_first=(b == 0), rr_active=(b > rr_start),
                rng=rng)
            radiance = radiance + fout[0:3]
            fin = fout[3:]  # next origin, dir, beta: a contiguous view
        return radiance.T, count[0]
