"""Faults planted under the timed path, for the tests that see `correct`
come out false. Each function patches the program in the process that
calls it (a sharded cell's ranks call it by name: a mix's "plant")."""

from __future__ import annotations


def broken(kind: str, fn):
    """fn(pix, s) -> (radiance, count, ...) with the fault `kind`:
    "unchanged" (the pass leaves the film as it was), "half" (half of the
    batch left out, given the mean over the rest) or "altered" (answers
    altered where they are produced: every eighth lane's radiance
    doubled)."""
    import torch

    def run(pix, s, *args, **kw):
        if kind == "half":
            half = pix.shape[0] // 2
            out = fn(pix[:half], s, *args, **kw)
            rad = out[0]
            rest = rad.mean(dim=0, keepdim=True).expand(
                pix.shape[0] - half, 3)
            return (torch.cat([rad, rest]),) + tuple(out[1:])
        out = fn(pix, s, *args, **kw)
        rad = out[0]
        if kind == "unchanged":
            rad = torch.zeros_like(rad)
        elif kind == "altered":
            rad = rad.clone()
            rad[::8] = 2.0 * rad[::8]
        return (rad,) + tuple(out[1:])
    return run


def patch_render(monkeypatch, kind: str):
    """The final-frame path: every integrator render_image builds."""
    from pbrs_tpu_torch import render

    make = render.make_integrator

    def patched(*a, **kw):
        name, fn = make(*a, **kw)
        return name, broken(kind, fn)
    monkeypatch.setattr(render, "make_integrator", patched)


def _patch_samples(kind: str):
    from pbrs_tpu_torch.integrators import wavefront

    real = wavefront.render_samples

    def samples(scene, sampler, pix, s, *a, **kw):
        return broken(kind, lambda p, t: real(scene, sampler, p, t, *a,
                                              **kw))(pix, s)
    wavefront.render_samples = samples


def unchanged():
    _patch_samples("unchanged")


def half():
    _patch_samples("half")


def altered():
    _patch_samples("altered")


def no_exchange():
    """The all_reduce between the ranks left out."""
    import torch.distributed as dist

    dist.all_reduce = lambda tensor, *a, **kw: None
