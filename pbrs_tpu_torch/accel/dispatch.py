"""Trace-backend selection. Mirrors pbrs_tpu/accel/dispatch.py.

With kernels, intersect/occlude go through trace_kernel.Tracer: the flat
bank (K1) and a BVH tracer (K5) for every family above the threshold,
launched for CUDA tensors, their plain versions for CPU tensors. Without,
they are the broadcast sweep of shapes/intersect.py on any device.

Instance groups: the ``flattenable`` ones are baked into the geometry
before the tracer builds its families; the others are traced at trace time
-- masters of at most 64 primitives with the broadcast sweep, larger ones
through a Tracer of their own -- and merged by the closer hit.
"""

from __future__ import annotations

from ..shapes import intersect as isect_mod
from . import instanced as inst_mod
from . import trace_kernel as tk

SMALL_MASTER = 64  # masters up to this many prims take the broadcast sweep


def trace_geometry(scene):
    """(geometry the base tracer takes, the groups left to trace time):
    the scene's tables with its flattenable groups baked in."""
    geom = scene.geom
    groups = tuple(getattr(scene, "instanced", ()))
    bake = [g for g in groups if inst_mod.flattenable(g)]
    if bake:
        geom = inst_mod.flatten_groups(geom, bake).to(geom.quad_origin.device)
    return geom, tuple(g for g in groups if not inst_mod.flattenable(g))


def make_trace_fns(scene, use_kernels: bool = True,
                   bvh_threshold: int | None = None):
    """(intersect_fn, occlude_fn) for the scene geometry, instance groups
    included; bvh_threshold overrides the family size above which K5 takes
    a family."""
    geom, groups = trace_geometry(scene)
    if not use_kernels:
        def base_isect(rays):
            return isect_mod.intersect(geom, rays)

        def base_occl(rays):
            return isect_mod.occluded(geom, rays)
    else:
        tracer = tk.Tracer(geom, bvh_threshold=bvh_threshold)

        def base_isect(rays):
            t, idx = tracer.trace(rays)
            return isect_mod.hit_from_t_idx(geom, rays, t, idx)

        base_occl = tracer.occluded
    if not groups:
        return base_isect, base_occl

    group_fns = []
    for grp in groups:
        if use_kernels and sum(grp.geom.counts) > SMALL_MASTER:
            mtracer = tk.Tracer(grp.geom, bvh_threshold=bvh_threshold)
            t_fn = (lambda tr: lambda _g, r: tr.trace(r))(mtracer)
            o_fn = (lambda tr: lambda _g, r: tr.occluded(r))(mtracer)
        else:
            t_fn, o_fn = inst_mod.intersect_t, isect_mod.occluded
        group_fns.append((grp, t_fn, o_fn))

    def intersect_fn(rays):
        hit = base_isect(rays)
        for grp, t_fn, _ in group_fns:
            t, inst, win = inst_mod.intersect_t_group(grp, rays, t_fn)
            hit = inst_mod.merge_hits(
                hit, inst_mod.hit_from_group(grp, rays, t, inst, win))
        return hit

    def occlude_fn(rays):
        blocked = base_occl(rays)
        for grp, _, o_fn in group_fns:
            blocked = blocked | inst_mod.occluded_group(grp, rays, o_fn)
        return blocked

    return intersect_fn, occlude_fn
