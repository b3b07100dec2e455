"""Persistent wavefront: dead lanes refill with fresh (pixel, sample) tasks.
Mirrors pbrs_tpu/integrators/persistent.py.

A fixed pool of L lanes works through a queue of N (pixel, sample) tasks.
Each iteration advances every lane one bounce; a lane whose path ended
(miss, absorption, Russian roulette, depth) adds its radiance into the
output at its task's row, claims the next unclaimed task (prefix-sum slot
assignment, so tasks go out in a fixed order) and restarts as that task's
camera ray. Every trace and shading launch so runs on the pool's lanes
whatever the spread of path lengths: lane refill (path regeneration).

The estimator is the masked loop's: the same counter-based draws keyed by
(pixel, sample, bounce, dim), the same NEE / MIS / roulette rules, so each
task's radiance equals ``wavefront.render_samples``' up to the order of
float additions. The iteration loop is a host loop over whole-pool tensor
ops; the loop test reads ``torch.any(task >= 0)`` once an iteration, the
only host sync it needs.
"""

from __future__ import annotations

import torch

from ..bxdf import bsdf as bsdf_mod
from ..core import sampler as smp
from ..core import vecmath as vm
from ..geometry import ray as ray_mod
from ..lights import lights as lt
from ..materials import table as mat_mod
from ..shapes import intersect as isect_mod
from . import nee
from .wavefront import camera_rays


def render_tasks_persistent(scene, sampler, pixel_idx, sample_idx,
                            n_lanes=None, max_depth=5, rr_start=3, msaa=2,
                            intersect_fn=None, occlude_fn=None,
                            return_ray_count=False):
    """Integrate N (pixel, sample) tasks, pixel_idx and sample_idx [N] int
    tensors, on a pool of `n_lanes` lanes. Returns the radiance [N, 3] of
    each task (wavefront.render_samples' layout), and with
    return_ray_count its traced-ray count: a float32 scalar summing, each
    iteration, the lanes holding a task plus two shadow rays per lane
    alive after its hit (scenes with lights), as pbrs_tpu's does.

    n_lanes defaults to N (the full pool: refill then never fires and the
    loop is the masked one); fewer lanes keep the pool full on deep paths.
    intersect_fn / occlude_fn default to the broadcast sweep over the
    scene geometry; ``dispatch.make_trace_fns(scene)`` gives the scene's
    tracers (the trace kernels on the card).

    Every iteration advances every lane holding a task, so the loop ends
    within N * max_depth iterations; pbrs_tpu caps it at N * max_depth +
    2. Reaching that cap with a task left would be a fault of the loop,
    and raises."""
    if intersect_fn is None:
        intersect_fn = lambda r: isect_mod.intersect(scene.geom, r)  # noqa: E731
    if occlude_fn is None:
        occlude_fn = lambda r: isect_mod.occluded(scene.geom, r)  # noqa: E731
    dev = pixel_idx.device
    n_tasks = pixel_idx.shape[0]
    n_lanes = min(n_tasks if n_lanes is None else n_lanes, n_tasks)

    def lane_pix(task):
        t = torch.clamp(task, 0, n_tasks - 1).to(torch.int64)
        return pixel_idx[t], sample_idx[t]

    def task_ray(task):
        pix, samp = lane_pix(task)
        return camera_rays(scene, sampler, pix, samp, msaa)

    # Lane state: task id (-1 = retired), per-lane bounce, ray, beta,
    # radiance accumulator, specular flag.
    task = torch.arange(n_lanes, dtype=torch.int32, device=dev)
    bounce = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    rays = task_ray(task)
    beta = torch.ones(n_lanes, 3, device=dev)
    rad = torch.zeros(n_lanes, 3, device=dev)
    specular = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    out = torch.zeros(n_tasks, 3, device=dev)
    next_task = torch.tensor(n_lanes, dtype=torch.int32, device=dev)
    ray_count = torch.zeros((), device=dev)
    step_cap = n_tasks * max_depth + 2
    nstep = 0

    while bool(torch.any(task >= 0)):
        if nstep == step_cap:
            raise RuntimeError(f"persistent loop reached its cap of "
                               f"{step_cap} iterations with tasks left")
        active = task >= 0
        pix, samp = lane_pix(task)
        ray_count = ray_count + active.to(torch.float32).sum()

        hit = intersect_fn(rays)
        lobes, emit = mat_mod.shading_at(scene.materials, scene.textures,
                                         hit.mat_id, hit.uv, hit.pos)
        env = lt.eval_env(scene.env, rays.dir)
        direct_seen = torch.where(hit.hit[..., None], emit, env)
        count_emission = active & ((bounce == 0) | specular)
        rad = rad + torch.where(count_emission[..., None],
                                beta * direct_seen, 0.0)

        alive = active & hit.hit
        frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
        if scene.num_lights > 0:
            u_sel = sampler.u1(pix, samp, bounce, smp.DIM_LIGHT_SELECT)
            u_light = sampler.u2(pix, samp, bounce, smp.DIM_LIGHT_UV)
            u_scatter = sampler.u2(pix, samp, bounce, smp.DIM_SCATTER_UV)
            l_direct = nee.uniform_sample_one_light(
                scene, lobes, frame, hit.pos, hit.normal, hit.wo, u_sel,
                u_light, u_scatter, occlude_fn=occlude_fn, alive=alive)
            rad = rad + torch.where(alive[..., None], beta * l_direct, 0.0)
            ray_count = ray_count + 2.0 * alive.to(torch.float32).sum()

        u_bsdf = sampler.u2(pix, samp, bounce, smp.DIM_BSDF_UV)
        f, wi, pdf, is_delta = bsdf_mod.sample_bsdf(lobes, frame, hit.wo,
                                                    u_bsdf)
        cos_term = torch.abs(vm.dot(wi, frame.n))
        step_ok = (pdf > 0.0) & ((f[..., 0] > 0.0) | (f[..., 1] > 0.0)
                                 | (f[..., 2] > 0.0))
        alive = alive & step_ok
        beta = torch.where(
            alive[..., None],
            beta * f * (cos_term * vm.weak_recip(pdf))[..., None], beta)
        new_rays = ray_mod.spawn(hit.pos, hit.normal, wi)

        q = torch.clamp_min(1.0 - vm.luminance(beta), 0.05)
        u_rr = sampler.u1(pix, samp, bounce, smp.DIM_RUSSIAN_ROULETTE)
        rr_active = bounce > rr_start
        alive = alive & ~(rr_active & (u_rr < q))
        rr_scale = torch.where(rr_active & alive,
                               1.0 / torch.clamp_min(1.0 - q, 1e-6), 1.0)
        beta = beta * rr_scale[..., None]

        bounce = bounce + 1
        alive = alive & (bounce < max_depth)

        # Retire finished tasks, claim fresh ones.
        finished = active & ~alive
        out = out.index_add(
            0, torch.clamp(task, 0, n_tasks - 1).to(torch.int64),
            torch.where(finished[:, None], rad, 0.0))
        # Prefix-sum slot assignment hands the tasks out in a fixed order.
        fin_i = finished.to(torch.int32)
        new_task = next_task + torch.cumsum(fin_i, 0, dtype=torch.int32) - 1
        has_new = finished & (new_task < n_tasks)
        task = torch.where(alive, task, torch.where(has_new, new_task, -1))
        next_task = torch.clamp_max(next_task + fin_i.sum(dtype=torch.int32),
                                    n_tasks)

        fresh = task_ray(task)
        refill = has_new
        rays = new_rays.replace(
            origin=torch.where(refill[:, None], fresh.origin,
                               new_rays.origin),
            dir=torch.where(refill[:, None], fresh.dir, new_rays.dir),
            t_max=torch.where(task >= 0,
                              torch.where(refill, fresh.t_max,
                                          new_rays.t_max), 0.0))
        bounce = torch.where(refill, 0, bounce)
        beta = torch.where(refill[:, None], 1.0, beta)
        rad = torch.where(refill[:, None], 0.0, rad)
        specular = torch.where(refill, False, is_delta)
        nstep += 1

    if return_ray_count:
        return out, ray_count
    return out
