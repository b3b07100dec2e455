"""Multi-lobe BSDF aggregation in the world frame. Mirrors
pbrs_tpu/bxdf/bsdf.py.

The lobe to sample is picked uniformly among the active slots; the pdf is
the mixture density sum(pdf_l) / n_active.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import vecmath as vm
from . import lobes as lb


@dataclass
class Frame:
    t: torch.Tensor
    b: torch.Tensor
    n: torch.Tensor


def make_frame(normal, dpdu) -> Frame:
    t, b, n = vm.orthonormal_frame(normal, dpdu)
    return Frame(t=t, b=b, n=n)


def world_to_local(frame: Frame, w):
    return vm.normalize(vm.to_local(frame.t, frame.b, frame.n, w))


def local_to_world(frame: Frame, w):
    return vm.to_world(frame.t, frame.b, frame.n, w)


def eval_bsdf(lobes: lb.Lobes, frame: Frame, wo_world, wi_world):
    """Sum of lobe f(wo, wi); zero when wo is tangent to the surface."""
    wo = world_to_local(frame, wo_world)
    wi = world_to_local(frame, wi_world)
    total = torch.zeros_like(wo)
    for l in range(lobes.num_slots):
        total = total + lb.eval_lobe(lb.slot(lobes, l), wo, wi)
    return torch.where((wo[..., 2] == 0.0)[..., None], 0.0, total)


def pdf_bsdf(lobes: lb.Lobes, frame: Frame, wo_world, wi_world):
    """Mixture density sum(pdf_l) / n_active."""
    wo = world_to_local(frame, wo_world)
    wi = world_to_local(frame, wi_world)
    total = torch.zeros_like(wo[..., 0])
    for l in range(lobes.num_slots):
        total = total + lb.pdf_lobe(lb.slot(lobes, l), wo, wi)
    n = lb.num_active(lobes)
    return torch.where(n > 0, total / torch.clamp_min(n, 1), 0.0)


def sample_bsdf(lobes: lb.Lobes, frame: Frame, wo_world, u2):
    """Pick a lobe uniformly, sample it, tally the other lobes.
    Returns (f, wi_world, pdf, is_delta)."""
    wo = world_to_local(frame, wo_world)
    u, v = u2[..., 0], u2[..., 1]
    n = lb.num_active(lobes)
    n_f = torch.clamp_min(n, 1).to(u.dtype)
    chosen = torch.minimum((u * n_f).to(torch.int32), torch.clamp_min(n - 1, 0))
    u_remap = torch.remainder(u * n_f, 1.0)
    # The chosen lobe consumes (v, remapped u). [pbrs_tpu/bxdf/bsdf.py:81]
    rnd2 = torch.stack([v, u_remap], dim=-1)

    f_c, wi, p_c, is_delta = lb.sample_lobe(lb.slot(lobes, chosen), wo, rnd2)

    f_sum = torch.zeros_like(f_c)
    p_sum = torch.zeros_like(p_c)
    for l in range(lobes.num_slots):
        other = lb.slot(lobes, l)
        mask = (chosen != l) & (other.kind != lb.NONE)
        f_sum = f_sum + torch.where(mask[..., None],
                                    lb.eval_lobe(other, wo, wi), 0.0)
        p_sum = p_sum + torch.where(mask, lb.pdf_lobe(other, wo, wi), 0.0)

    f = torch.where(is_delta[..., None], f_c, f_c + f_sum)
    pdf = torch.where(is_delta, p_c, p_c + p_sum) / n_f
    none_active = n == 0
    f = torch.where(none_active[..., None], 0.0, f)
    pdf = torch.where(none_active, 0.0, pdf)
    return f, local_to_world(frame, wi), pdf, is_delta


def sample_specular(lobes: lb.Lobes, frame: Frame, wo_world):
    """Sample the first delta lobe, if any: (f, wi_world, pmf,
    has_specular)."""
    wo = world_to_local(frame, wo_world)
    found = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    f_out = torch.zeros_like(wo)
    wi_out = torch.zeros_like(wo)
    pmf_out = torch.zeros_like(wo[..., 0])
    zeros2 = torch.zeros_like(wo[..., :2])
    for l in range(lobes.num_slots):
        this = lb.slot(lobes, l)
        is_spec = lb.is_delta_kind(this.kind) & ~found
        f, wi, p, _ = lb.sample_lobe(this, wo, zeros2)
        f_out = torch.where(is_spec[..., None], f, f_out)
        wi_out = torch.where(is_spec[..., None], wi, wi_out)
        pmf_out = torch.where(is_spec, p, pmf_out)
        found = found | lb.is_delta_kind(this.kind)
    return f_out, local_to_world(frame, wi_out), pmf_out, found
