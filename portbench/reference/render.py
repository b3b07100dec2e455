"""The plain reference: any subset of a film's pixels, recomputed.

Every sample of the renderer is keyed by (seed, pixel, sample index), so
the film sum of pixel p over sample indices 0 .. S-1 is a sum of S lanes
that this module renders on their own: camera ray, the masked general
path with two-arm NEE, and the broadcast sweep over every primitive of
the scene (the frozen copy under ``pbrs/``; no kernel, no BVH). Lanes go
in blocks of sample indices over the chosen pixels, and each pixel's sum
is taken in sample order in float32, as the film takes it.

The scene is built here from the configuration's description (a preset
and a camera, or a PBRT file), never taken from the program.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .pbrs.accel import instanced as inst_mod
from .pbrs.core import sampler as smp
from .pbrs.geometry import camera as cam_mod
from .pbrs.integrators import wavefront
from .pbrs.scene import presets
from .pbrs.scene.pbrt import loader
from .pbrs.shapes import intersect as isect_mod

# Broadcast elements ([rays, primitives]) a trace block may hold.
SWEEP_ELEMENTS = 1 << 25
# Lanes a call of the general path takes.
LANE_BLOCK = 1 << 19


def build_scene(desc: dict, root: Path, width: int, height: int):
    """The scene a configuration describes: {"preset": name, "camera":
    {eye, target, up, fov}} at width x height, or {"pbrt": path under the
    checkout}, whose Film line must give width x height."""
    if "preset" in desc:
        scene = presets.PRESETS[desc["preset"]]()
        c = desc["camera"]
        cam = cam_mod.looking_at(cam_mod.make_camera((width, height),
                                                     float(c["fov"])),
                                 c["eye"], c["target"], c["up"])
        return scene.replace(camera=cam)
    scene = loader.build_scene(str(Path(root) / desc["pbrt"]))
    got = (scene.camera.width, scene.camera.height)
    if got != (width, height):
        raise ValueError(f"{desc['pbrt']} renders {got}, the configuration "
                         f"says {(width, height)}")
    return scene


def _blocks(rays, size):
    n = rays.origin.shape[0]
    for a in range(0, n, size):
        yield rays.replace(origin=rays.origin[a:a + size],
                           dir=rays.dir[a:a + size],
                           t_max=rays.t_max[a:a + size])


def _cat_hits(hits):
    return isect_mod.Hit(**{f.name: torch.cat([getattr(h, f.name)
                                               for h in hits])
                            for f in dataclasses.fields(isect_mod.Hit)})


def trace_fns(scene, ray_dtype=None):
    """(intersect_fn, occlude_fn): the broadcast sweep over the scene's
    tables, its flattenable instance groups baked in and the others traced
    instance by instance, in ray blocks that bound the [rays, primitives]
    broadcast. ray_dtype (torch.bfloat16 for the control): every traced
    ray's origin and direction are rounded to it first."""
    geom = scene.geom
    groups = tuple(getattr(scene, "instanced", ()))
    bake = [g for g in groups if inst_mod.flattenable(g)]
    if bake:
        geom = inst_mod.flatten_groups(geom, bake).to(
            geom.quad_origin.device)
    groups = tuple(g for g in groups if not inst_mod.flattenable(g))
    block = max(256, SWEEP_ELEMENTS // max(1, sum(geom.counts)))

    def held(rays):
        if ray_dtype is None:
            return rays
        return rays.replace(origin=rays.origin.to(ray_dtype).float(),
                            dir=rays.dir.to(ray_dtype).float())

    def isect_block(rays):
        hit = isect_mod.intersect(geom, rays)
        for grp in groups:
            t, inst, win = inst_mod.intersect_t_group(grp, rays,
                                                      inst_mod.intersect_t)
            hit = inst_mod.merge_hits(
                hit, inst_mod.hit_from_group(grp, rays, t, inst, win))
        return hit

    def occl_block(rays):
        blocked = isect_mod.occluded(geom, rays)
        for grp in groups:
            blocked = blocked | inst_mod.occluded_group(grp, rays,
                                                        isect_mod.occluded)
        return blocked

    def intersect_fn(rays):
        return _cat_hits([isect_block(b) for b in _blocks(held(rays), block)])

    def occlude_fn(rays):
        return torch.cat([occl_block(b) for b in _blocks(held(rays), block)])

    return intersect_fn, occlude_fn


def film_sums(scene, seed: int, pixels, n_samples: int, max_depth: int,
              msaa: int, device, ray_dtype=None, lane_block=LANE_BLOCK,
              live=None):
    """[K, 3] float32: for each pixel id in `pixels`, the sum of its
    radiance over sample indices 0 .. n_samples - 1 drawn by PCGSampler
    (seed), in sample order, as a film of that many passes holds it.

    live, a list of max_depth numbers, gets the samples alive as each
    bounce begins added to its entry."""
    dev = torch.device(device)
    scene = scene.to(dev)
    sampler = smp.PCGSampler(seed)
    isect_fn, occl_fn = trace_fns(scene, ray_dtype)
    pix = torch.as_tensor(np.asarray(pixels, np.int64), dtype=torch.int32,
                          device=dev)
    k = int(pix.shape[0])
    acc = torch.zeros(k, 3, dtype=torch.float32, device=dev)
    per_call = max(1, lane_block // max(k, 1))
    counted = [0] * max_depth
    for s0 in range(0, n_samples, per_call):
        s1 = min(n_samples, s0 + per_call)
        sid = torch.arange(s0, s1, dtype=torch.int32,
                           device=dev).repeat_interleave(k)
        rad, _ = wavefront.render_samples(scene, sampler, pix.repeat(s1 - s0),
                                          sid, isect_fn, occl_fn,
                                          max_depth=max_depth, msaa=msaa,
                                          live=counted)
        for row in rad.view(s1 - s0, k, 3):
            acc = acc + row
    if live is not None:
        for b, c in enumerate(counted):
            live[b] += int(c)
    return acc.cpu().numpy()
