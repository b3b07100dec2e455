"""Entry points: a one-step render check and the multi-rank dry run.
Mirrors __graft_entry__.py.

``entry()`` gives one render step of the flagship scene (the Cornell box
at 64^2, depth 5, msaa 2, NEE + MIS) through the general wavefront and
the scene's tracers; ``dryrun_multichip(n)`` runs one step of the sharded
render over an n-rank dp x sp mesh (sp = 2 when n is even) at tiny shapes
and checks its film. Both run on the card unless asked for the CPU.
"""

from __future__ import annotations

import torch

from . import parallel
from .accel import dispatch as trace_dispatch
from .core import sampler as smp
from .geometry import camera as cam_mod
from .integrators import wavefront
from .scene import presets


def tiny_cornell(size=64):
    """The Cornell box at size^2, seen as __graft_entry__.py sees it."""
    cam = cam_mod.looking_at(cam_mod.make_camera((size, size), 40.0),
                             (278, 278, -800), (278, 278, 0), (0, 1, 0))
    return presets.cornell_box().replace(camera=cam)


def entry(device="cuda"):
    """(fn, example_args): fn(pixel_idx, sample_idx) -> radiance [N, 3] of
    one sample index over the 64^2 Cornell box, depth 5, msaa 2, through
    the general wavefront and the scene's tracers (the trace kernels on
    the card). Raises without a card unless `device` is the CPU."""
    dev = parallel.rank_device(device, 0)
    scene = tiny_cornell(64).to(dev)
    sampler = smp.PCGSampler(0)
    isect_fn, occl_fn = trace_dispatch.make_trace_fns(scene)

    def fn(pixel_idx, sample_idx):
        return wavefront.render_samples(scene, sampler, pixel_idx,
                                        sample_idx, isect_fn, occl_fn,
                                        max_depth=5, msaa=2)[0]

    example_args = (torch.arange(64 * 64, dtype=torch.int32, device=dev), 0)
    return fn, example_args


def _dryrun_rank(dev, n_devices):
    """One sharded render step on this rank; raises unless the film is
    whole and finite. Returns the film's shape."""
    n_sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_dp = n_devices // n_sp
    mesh = parallel.make_mesh(n_dp=n_dp, n_sp=n_sp, device_type=dev.type)
    scene = tiny_cornell(16).to(dev)
    n = 16 * 16
    pad = (-n) % n_dp
    pixel_idx = torch.arange(n + pad, dtype=torch.int32, device=dev) % n
    out = parallel.render_batch_sharded(scene, smp.PCGSampler(0), pixel_idx,
                                        0, n_sp, mesh, max_depth=3, msaa=1)
    if tuple(out.shape) != (n + pad, 3):
        raise RuntimeError(f"sharded film shape {tuple(out.shape)}, "
                           f"expected {(n + pad, 3)}")
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("sharded film holds a non-finite value")
    return tuple(out.shape)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The full sharded render step over an n_devices-rank mesh (pixel
    parallel 'dp' x sample parallel 'sp', the film summed over 'sp') at
    tiny shapes: a 16^2 Cornell box, depth 3, msaa 1, one sample index a
    sp rank. Ranks on the card share it when there are fewer cards (gloo);
    device="cpu" runs them on the CPU. Raises if a rank fails."""
    parallel.run_ranks(_dryrun_rank, n_devices, n_devices, device=device)
