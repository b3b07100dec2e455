"""Trace-backend selection. Mirrors pbrs_tpu/accel/dispatch.py (trace-time
instance groups are not ported yet).

With kernels, intersect/occlude go through the flat-bank trace
(trace_kernel), which launches K1 for CUDA tensors and runs its plain
version for CPU tensors. Without, they are the broadcast sweep of
shapes/intersect.py on any device.
"""

from __future__ import annotations

from ..shapes import intersect as isect_mod
from . import trace_kernel as tk


def make_trace_fns(scene, use_kernels: bool = True):
    """(intersect_fn, occlude_fn) for the scene geometry."""
    geom = scene.geom
    if not use_kernels:
        return (lambda rays: isect_mod.intersect(geom, rays),
                lambda rays: isect_mod.occluded(geom, rays))
    bank, counts = tk.prim_scalars(geom)

    def intersect_fn(rays):
        t, idx = tk.trace(bank, counts, rays)
        return isect_mod.hit_from_t_idx(geom, rays, t, idx)

    def occlude_fn(rays):
        return tk.occluded(bank, counts, rays)

    return intersect_fn, occlude_fn
