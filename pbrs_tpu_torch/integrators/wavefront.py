"""Wavefront path integrator (the general path). Mirrors
pbrs_tpu/integrators/wavefront.py: camera rays without a pixel filter, the
masked two-arm ``path_radiance`` loop and ``render_samples`` (filters,
compaction, folded NEE and the audit are not ported yet).

Every bounce runs intersect -> shading (textures overlaid) -> emission on
camera and post-delta segments -> NEE -> BSDF sample -> Russian roulette
on all lanes, with terminated lanes masked; the bounce loop is a Python
loop over whole-batch tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bxdf import bsdf as bsdf_mod
from ..core import sampler as smp
from ..core import vecmath as vm
from ..geometry import camera as cam_mod
from ..geometry import ray as ray_mod
from ..lights import lights as lt
from ..materials import table as mat_mod
from . import nee


def camera_rays(scene, sampler, pixel_idx, sample_idx, msaa):
    """Camera ray batch with stratified per-sample jitter (box filter)."""
    row, col = cam_mod.pixel_coords(scene.camera, pixel_idx)
    dx, dy = smp.stratified_jitter(sampler, pixel_idx, sample_idx, msaa)
    return cam_mod.shoot_rays(scene.camera, row, col,
                              torch.stack([dx, dy], dim=-1))


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


def path_radiance(scene, rays, sampler, pixel_idx, sample_idx, intersect_fn,
                  occlude_fn, max_depth=5, rr_start=3):
    """(radiance [N,3], traced-ray count) along camera rays: closest hit,
    emission on camera segments, one-light NEE with MIS, BSDF sampling,
    Russian roulette after `rr_start`. The count (an int64 scalar) is alive
    closest-hit rays + two shadow rays per alive lane."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    radiance = torch.zeros(n, 3, device=dev)
    beta = torch.ones(n, 3, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular = torch.zeros(n, dtype=torch.bool, device=dev)
    ray_count = torch.zeros((), dtype=torch.int64, device=dev)

    for bounce in range(max_depth):
        ray_count = ray_count + (rays.t_max > 0.0).sum()
        hit = intersect_fn(rays)
        lobes, emit = mat_mod.shading_at(scene.materials, scene.textures,
                                         hit.mat_id, hit.uv, hit.pos)
        # Emission counts on camera segments and after delta bounces.
        env = lt.eval_env(scene.env, rays.dir)
        direct_seen = torch.where(hit.hit[..., None], emit, env)
        count_emission = alive & ((bounce == 0) | specular)
        radiance = radiance + torch.where(count_emission[..., None],
                                          beta * direct_seen, 0.0)
        alive = alive & hit.hit

        frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
        u_bsdf = sampler.u2(pixel_idx, sample_idx, bounce, smp.DIM_BSDF_UV)
        f, wi, pdf, is_delta = bsdf_mod.sample_bsdf(lobes, frame, hit.wo,
                                                    u_bsdf)

        if scene.num_lights > 0:
            u_sel = sampler.u1(pixel_idx, sample_idx, bounce,
                               smp.DIM_LIGHT_SELECT)
            u_light = sampler.u2(pixel_idx, sample_idx, bounce,
                                 smp.DIM_LIGHT_UV)
            u_scatter = sampler.u2(pixel_idx, sample_idx, bounce,
                                   smp.DIM_SCATTER_UV)
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
        # Dead lanes get t_max=0 so tracers can skip them.
        rays = rays.replace(t_max=torch.where(alive, rays.t_max, 0.0))

    return radiance, ray_count


def render_samples(scene, sampler, pixel_idx, sample_idx, intersect_fn,
                   occlude_fn, max_depth=5, msaa=2):
    """Camera rays + path integration for a (pixel, sample) batch:
    (radiance [N,3], traced-ray count)."""
    rays = camera_rays(scene, sampler, pixel_idx, sample_idx, msaa)
    return path_radiance(scene, rays, sampler, pixel_idx, sample_idx,
                         intersect_fn, occlude_fn, max_depth=max_depth)
