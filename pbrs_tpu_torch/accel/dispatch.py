"""Trace-backend selection. Mirrors pbrs_tpu/accel/dispatch.py (trace-time
instance groups are not ported yet).

With kernels, intersect/occlude go through trace_kernel.Tracer: the flat
bank (K1) and a BVH tracer (K5) for every family above the threshold,
launched for CUDA tensors, their plain versions for CPU tensors. Without,
they are the broadcast sweep of shapes/intersect.py on any device.
"""

from __future__ import annotations

from ..shapes import intersect as isect_mod
from . import trace_kernel as tk


def make_trace_fns(scene, use_kernels: bool = True,
                   bvh_threshold: int | None = None):
    """(intersect_fn, occlude_fn) for the scene geometry; bvh_threshold
    overrides the family size above which K5 takes a family."""
    geom = scene.geom
    if not use_kernels:
        return (lambda rays: isect_mod.intersect(geom, rays),
                lambda rays: isect_mod.occluded(geom, rays))
    tracer = tk.Tracer(geom, bvh_threshold=bvh_threshold)

    def intersect_fn(rays):
        t, idx = tracer.trace(rays)
        return isect_mod.hit_from_t_idx(geom, rays, t, idx)

    return intersect_fn, tracer.occluded
