"""Direct-lighting integrator and the visualizer passes. Mirrors
pbrs_tpu/integrators/direct.py: ``direct_radiance``, ``normal_visualizer``
and ``material_visualizer``.

``direct_radiance`` adds emission and one-light NEE at the first hit and
follows one perfect-specular lobe for up to `depth` segments. As in the
JAX package, the specular chain's throughput takes the |cos| factor that
the original integrator omits (COMPAT.md).
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


def _default_fns(scene, intersect_fn, occlude_fn):
    if intersect_fn is None:
        intersect_fn = lambda r: isect_mod.intersect(scene.geom, r)  # noqa: E731
    if occlude_fn is None:
        occlude_fn = lambda r: isect_mod.occluded(scene.geom, r)  # noqa: E731
    return intersect_fn, occlude_fn


def direct_radiance(scene, rays, sampler, pixel_idx, sample_idx, depth=5,
                    intersect_fn=None, occlude_fn=None):
    """Radiance [N,3]: emission / env and NEE at each hit of a chain that
    follows one perfect-specular lobe, up to `depth` segments."""
    intersect_fn, occlude_fn = _default_fns(scene, intersect_fn, occlude_fn)
    n = rays.origin.shape[0]
    dev = rays.origin.device
    radiance = torch.zeros(n, 3, device=dev)
    beta = torch.ones(n, 3, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)

    for bounce in range(depth):
        hit = intersect_fn(rays)
        env = lt.eval_env(scene.env, rays.dir)
        radiance = radiance + torch.where((alive & ~hit.hit)[..., None],
                                          beta * env, 0.0)
        alive = alive & hit.hit

        lobes, emit = mat_mod.shading_at(scene.materials, scene.textures,
                                         hit.mat_id, hit.uv, hit.pos)
        emissive = ((emit[..., 0] > 0.0) | (emit[..., 1] > 0.0)
                    | (emit[..., 2] > 0.0))
        radiance = radiance + torch.where((alive & emissive)[..., None],
                                          beta * emit, 0.0)
        alive = alive & ~emissive

        frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
        u_sel = sampler.u1(pixel_idx, sample_idx, bounce,
                           smp.DIM_LIGHT_SELECT)
        u_light = sampler.u2(pixel_idx, sample_idx, bounce, smp.DIM_LIGHT_UV)
        u_scatter = sampler.u2(pixel_idx, sample_idx, bounce,
                               smp.DIM_SCATTER_UV)
        if scene.num_lights > 0:
            l_direct = nee.uniform_sample_one_light(
                scene, lobes, frame, hit.pos, hit.normal, hit.wo, u_sel,
                u_light, u_scatter, occlude_fn=occlude_fn, alive=alive)
            radiance = radiance + torch.where(alive[..., None],
                                              beta * l_direct, 0.0)

        if bounce == depth - 1:
            break
        # Follow one perfect-specular lobe, if present.
        f, wi, pmf, has_spec = bsdf_mod.sample_specular(lobes, frame, hit.wo)
        alive = alive & has_spec & (pmf > 0.0)
        cos_term = torch.abs(vm.dot(wi, frame.n))
        beta = torch.where(alive[..., None],
                           beta * f * (cos_term * vm.weak_recip(pmf))[..., None],
                           beta)
        rays = ray_mod.spawn(hit.pos, hit.normal, wi)

    return radiance


def normal_visualizer(scene, rays, intersect_fn=None):
    """(albedo + normal) / 2 at the first hit, the environment on a miss."""
    intersect_fn, _ = _default_fns(scene, intersect_fn, None)
    hit = intersect_fn(rays)
    env = lt.eval_env(scene.env, rays.dir)
    lobes = mat_mod.lobes_at(scene.materials, scene.textures, hit.mat_id,
                             hit.uv, hit.pos)
    shaded = (lobes.albedo[:, 0, :] + hit.normal) * 0.5
    return torch.where(hit.hit[..., None], shaded, env)


_PALETTE = ((232, 207, 59), (124, 188, 126), (30, 68, 176), (15, 142, 205),
            (44, 180, 172), (216, 39, 252), (143, 112, 252), (77, 77, 77),
            (230, 230, 230), (0, 0, 0))


def material_visualizer(scene, rays, intersect_fn=None):
    """A palette color by material id; a miss shows a checkerboard of the
    ray direction."""
    intersect_fn, _ = _default_fns(scene, intersect_fn, None)
    hit = intersect_fn(rays)
    palette = torch.tensor(_PALETTE, dtype=torch.float32,
                           device=rays.dir.device) / 255.0
    idx = torch.where(hit.hit, hit.mat_id % 10, 9).to(torch.int64)
    d = vm.normalize(rays.dir)
    parity = (torch.floor(d[..., 0] * 50.0)
              + torch.floor(d[..., 1] * 50.0)).to(torch.int32) % 2
    bg = torch.where((parity == 0)[..., None], 0.9, 0.7)
    return torch.where(hit.hit[..., None], palette[idx], bg)
