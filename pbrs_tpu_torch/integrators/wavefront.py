"""Wavefront path integrator (the general path). Mirrors
pbrs_tpu/integrators/wavefront.py: camera rays with filter importance
sampling, the masked ``path_radiance`` loop with two-arm or folded NEE or
BSDF sampling alone (``use_nee=False``) and the ``--debug_checks`` audit,
and ``render_samples`` (compaction is not ported yet).

Every bounce runs intersect -> shading (textures overlaid) -> emission on
camera and post-delta segments -> NEE -> BSDF sample -> Russian roulette
on all lanes, with terminated lanes masked; the bounce loop is a Python
loop over whole-batch tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bxdf import bsdf as bsdf_mod
from ..core import filters as flt
from ..core import sampler as smp
from ..core import vecmath as vm
from ..geometry import camera as cam_mod
from ..geometry import ray as ray_mod
from ..lights import env_sampling as es
from ..lights import lights as lt
from ..materials import table as mat_mod
from . import debug_audit as aud_mod
from . import nee


def camera_rays(scene, sampler, pixel_idx, sample_idx, msaa,
                filter_table=None):
    """Camera ray batch with stratified per-sample jitter, warped through
    a reconstruction filter's inverse CDF when one is given."""
    rays, _ = camera_rays_weighted(scene, sampler, pixel_idx, sample_idx,
                                   msaa, filter_table)
    return rays


def camera_rays_weighted(scene, sampler, pixel_idx, sample_idx, msaa,
                         filter_table=None):
    """(rays, weight): weight is None without a filter or for a
    non-negative one, else each sample's signed filter weight [N]
    (weighted filter importance sampling, core/filters.py)."""
    row, col = cam_mod.pixel_coords(scene.camera, pixel_idx)
    dx, dy = smp.stratified_jitter(sampler, pixel_idx, sample_idx, msaa)
    weight = None
    if filter_table is not None:
        ox, wx = flt.sample_filter_offset(filter_table, dx)
        oy, wy = flt.sample_filter_offset(filter_table, dy)
        dx = 0.5 + ox
        dy = 0.5 + oy
        if wx is not None:
            weight = wx * wy
    rays = cam_mod.shoot_rays(scene.camera, row, col,
                              torch.stack([dx, dy], dim=-1))
    return rays, weight


def morton_pixel_order(width, height):
    """Pixel ids in Morton (Z-curve) order (host-side NumPy)."""
    w2 = 1 << int(np.ceil(np.log2(max(width, 1))))
    h2 = 1 << int(np.ceil(np.log2(max(height, 1))))
    s = max(w2, h2)
    xs, ys = np.meshgrid(np.arange(s, dtype=np.int64),
                         np.arange(s, dtype=np.int64), indexing="xy")

    def part1by1(v):
        v = (v | (v << 16)) & 0x0000FFFF0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
        v = (v | (v << 2)) & 0x3333333333333333
        v = (v | (v << 1)) & 0x5555555555555555
        return v

    code = part1by1(xs.reshape(-1)) | (part1by1(ys.reshape(-1)) << 1)
    order = np.argsort(code, kind="stable")
    xs, ys = xs.reshape(-1)[order], ys.reshape(-1)[order]
    keep = (xs < width) & (ys < height)
    return (ys[keep] * width + xs[keep]).astype(np.int32)


def _resolve_pending(pending, hit, env, p_env=None):
    """The previous bounce's folded BSDF-arm contribution, resolved by this
    bounce's closest hit: the env leg pays where the ray escaped, the area
    leg where nothing closer than the chosen light was hit. p_env (env-IS):
    the distribution pdf along this bounce's rays, for the env leg's
    deferred MIS weight (the BSDF pdf rides t_light there)."""
    coeff, t_light, is_env = (pending["coeff"], pending["t_light"],
                              pending["is_env"])
    vis_area = hit.t >= t_light * (1.0 - 1e-3)
    pend_valid = is_env | (t_light > 0.0)
    env_term = coeff * env
    if p_env is not None:
        w_e = nee._power2_heuristic(t_light, p_env)
        env_term = env_term * torch.where(is_env, w_e, 1.0)[..., None]
    contrib = torch.where(is_env[..., None], env_term, coeff)
    ok = pend_valid & torch.where(is_env, ~hit.hit, vis_area)
    return torch.where(ok[..., None], contrib, 0.0)


def _make_env_evaluator(scene, folded):
    """(env rgb, distribution pdf or None) along directions: folded env-IS
    takes both from one texel lookup."""
    if folded and scene.env.dist is not None:
        return lambda dirs: es.eval_env_pdf(scene.env, dirs)
    return lambda dirs: (lt.eval_env(scene.env, dirs), None)


def path_radiance(scene, rays, sampler, pixel_idx, sample_idx, intersect_fn,
                  occlude_fn, max_depth=5, rr_start=3, nee_mode="twoarm",
                  use_nee=True, audit=False):
    """(radiance [N,3], traced-ray count) along camera rays: closest hit,
    emission on camera segments, one-light NEE with MIS, BSDF sampling,
    Russian roulette after `rr_start`. The count (an int64 scalar) is the
    rays with a live extent at each closest hit plus one shadow ray per
    alive lane for each shadow batch.

    use_nee=False is the brute-force estimator (validation): no NEE,
    emission counted on every segment; it converges to the NEE image.
    audit=True adds a third result, the [K] violation counts of
    debug_audit.py summed over the bounces.

    nee_mode "twoarm" traces a shadow ray for each MIS arm; "folded" shares
    the path's own BSDF sample with the BSDF arm and resolves its
    visibility from the next bounce's closest hit (one shadow batch a
    bounce). A lane that dies owing a pending keeps a segment bounded at
    the pending light for one more trace; one epilogue trace resolves the
    last bounce's."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    folded = nee_mode == "folded" and use_nee and scene.num_lights > 0
    env_eval = _make_env_evaluator(scene, folded)
    radiance = torch.zeros(n, 3, device=dev)
    beta = torch.ones(n, 3, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular = torch.zeros(n, dtype=torch.bool, device=dev)
    ray_count = torch.zeros((), dtype=torch.int64, device=dev)
    pend = None
    counts = aud_mod.zero_counts(dev) if audit else None

    for bounce in range(max_depth):
        alive_in, in_rays = alive, rays
        ray_count = ray_count + (rays.t_max > 0.0).sum()
        hit = intersect_fn(rays)
        lobes, emit = mat_mod.shading_at(scene.materials, scene.textures,
                                         hit.mat_id, hit.uv, hit.pos)
        # Emission counts on camera segments and after delta bounces.
        env, p_env = env_eval(rays.dir)
        direct_seen = torch.where(hit.hit[..., None], emit, env)
        count_emission = (alive & ((bounce == 0) | specular) if use_nee
                          else alive)
        radiance = radiance + torch.where(count_emission[..., None],
                                          beta * direct_seen, 0.0)
        if pend is not None:
            radiance = radiance + _resolve_pending(pend, hit, env, p_env)
        alive = alive & hit.hit

        frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
        u_bsdf = sampler.u2(pixel_idx, sample_idx, bounce, smp.DIM_BSDF_UV)
        f, wi, pdf, is_delta = bsdf_mod.sample_bsdf(lobes, frame, hit.wo,
                                                    u_bsdf)

        if use_nee and scene.num_lights > 0:
            u_sel = sampler.u1(pixel_idx, sample_idx, bounce,
                               smp.DIM_LIGHT_SELECT)
            u_light = sampler.u2(pixel_idx, sample_idx, bounce,
                                 smp.DIM_LIGHT_UV)
            u_scatter = sampler.u2(pixel_idx, sample_idx, bounce,
                                   smp.DIM_SCATTER_UV)
            if folded:
                l_direct, new_pend = nee.uniform_sample_one_light(
                    scene, lobes, frame, hit.pos, hit.normal, hit.wo, u_sel,
                    u_light, u_scatter, occlude_fn=occlude_fn, alive=alive,
                    path_sample=(f, wi, pdf, is_delta))
                pend = {"coeff": torch.where(alive[..., None],
                                             beta * new_pend["coeff"], 0.0),
                        "t_light": torch.where(alive, new_pend["t_light"],
                                               0.0),
                        "is_env": alive & new_pend["is_env"]}
                # One shadow batch per alive lane (the light-sampled arm).
                ray_count = ray_count + alive.sum()
            else:
                l_direct = nee.uniform_sample_one_light(
                    scene, lobes, frame, hit.pos, hit.normal, hit.wo, u_sel,
                    u_light, u_scatter, occlude_fn=occlude_fn, alive=alive)
                # Two shadow batches per alive lane (light + BSDF arms).
                ray_count = ray_count + 2 * alive.sum()
            radiance = radiance + torch.where(alive[..., None],
                                              beta * l_direct, 0.0)

        cos_term = torch.abs(vm.dot(wi, frame.n))
        step_ok = (pdf > 0.0) & ((f[..., 0] > 0.0) | (f[..., 1] > 0.0)
                                 | (f[..., 2] > 0.0))
        alive = alive & step_ok
        beta = torch.where(alive[..., None],
                           beta * f * (cos_term * vm.weak_recip(pdf))[..., None],
                           beta)
        rays = ray_mod.spawn(hit.pos, hit.normal, wi)

        # Russian roulette.
        if bounce > rr_start:
            q = torch.clamp_min(1.0 - vm.luminance(beta), 0.05)
            u_rr = sampler.u1(pixel_idx, sample_idx, bounce,
                              smp.DIM_RUSSIAN_ROULETTE)
            alive = alive & ~(u_rr < q)
            rr_scale = torch.where(alive, 1.0 / torch.clamp_min(1.0 - q, 1e-6),
                                   1.0)
            beta = beta * rr_scale[..., None]
        specular = is_delta
        # Dead lanes get t_max=0 so tracers can skip them; folded, a dead
        # lane owing a pending keeps the extent it needs for one more
        # trace.
        t_dead = torch.zeros_like(rays.t_max)
        if folded:
            t_dead = _owed_extent(pend, rays.t_max)
        rays = rays.replace(t_max=torch.where(alive, rays.t_max, t_dead))
        if audit:
            counts = counts + aud_mod.audit_bounce(
                in_rays, hit, frame, radiance, beta, f, wi, pdf, alive_in,
                lobes=lobes, emit=emit)

    if folded:
        # Epilogue: one closest hit bounded to what is owed resolves the
        # last bounce's pending.
        rays = rays.replace(t_max=_owed_extent(pend, rays.t_max))
        ray_count = ray_count + (rays.t_max > 0.0).sum()
        hit = intersect_fn(rays)
        env, p_env = env_eval(rays.dir)
        radiance = radiance + _resolve_pending(pend, hit, env, p_env)
    if audit:
        return radiance, ray_count, counts
    return radiance, ray_count


def _owed_extent(pend, t_max):
    """The extent a pending needs: the full one for an env leg, just past
    the chosen light for an area leg, none otherwise."""
    pend_valid = pend["is_env"] | (pend["t_light"] > 0.0)
    owed = torch.where(pend["is_env"], t_max,
                       pend["t_light"] * (1.0 + 1e-3))
    return torch.where(pend_valid, owed, 0.0)


def render_samples(scene, sampler, pixel_idx, sample_idx, intersect_fn,
                   occlude_fn, max_depth=5, msaa=2, nee_mode="twoarm",
                   use_nee=True, filter_table=None, audit=False):
    """Camera rays + path integration for a (pixel, sample) batch:
    (radiance [N,3], traced-ray count), plus the audit counts with
    audit=True. A weighted filter scales each sample's radiance by its
    signed filter weight."""
    rays, weight = camera_rays_weighted(scene, sampler, pixel_idx,
                                        sample_idx, msaa, filter_table)
    out = path_radiance(scene, rays, sampler, pixel_idx, sample_idx,
                        intersect_fn, occlude_fn, max_depth=max_depth,
                        nee_mode=nee_mode, use_nee=use_nee, audit=audit)
    if weight is None:
        return out
    return (out[0] * weight[..., None],) + tuple(out[1:])
