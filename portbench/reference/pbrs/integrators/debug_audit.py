"""Render-time invariant audit (--debug_checks). Mirrors
pbrs_tpu/integrators/debug_audit.py.

Each bounce of the general path's loop reduces every invariant to one
lane-mask count; the counts ride the loop as a [K] float32 vector on the
device, and the host reads it once after the render. Counter semantics:
the number of (lane, bounce) pairs that violated the invariant, summed
over bounces. A clean render reports all zeros; the CLI prints the table
and exits non-zero on a violation.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm

# Fixed category order: the loop carries a [K] vector keyed here.
AUDIT_KEYS = (
    "nonfinite_radiance",   # accumulated L has a NaN/inf component
    "negative_radiance",    # accumulated L dipped below -1e-5
    "nonfinite_beta",       # path throughput has a NaN/inf component
    "negative_beta",        # throughput component below -1e-5
    "hit_t_out_of_range",   # reported hit with t <= 0 or t > t_max(1+1e-3)
    "hit_normal_not_unit",  # | |n| - 1 | > 2e-3 on a hit lane
    "frame_not_orthonormal",  # TBN fails |t.n|,|t.b|,|b.n| <= 2e-3
    "nonfinite_hit_pos",    # hit position has a NaN/inf component
    "bsdf_pdf_invalid",     # sampled pdf negative or non-finite
    "bsdf_wi_not_unit",     # sampled direction | |wi| - 1 | > 2e-3
    "nonfinite_f",          # sampled BSDF value has a NaN/inf component
    "nonfinite_material",   # shading_at produced NaN/inf lobe parameters
                            # or emission (the lobe-selection comparisons
                            # turn a NaN into a dead lane: a black image,
                            # not a NaN image)
)

_UNIT_TOL = 2e-3
_ORTHO_TOL = 2e-3
_NEG_TOL = -1e-5


def zero_counts(device=None):
    return torch.zeros(len(AUDIT_KEYS), device=device)


def _count(mask):
    return mask.to(torch.float32).sum()


def _any_nonfinite(x):
    return ~torch.isfinite(x).all(dim=-1)


def audit_bounce(rays, hit, frame, radiance, beta, f, wi, pdf, alive_in,
                 lobes=None, emit=None):
    """One bounce's violation counts, [K] float32. `rays` are the bounce's
    input rays (their t_max bounds the hit), `alive_in` the lanes alive
    entering the bounce (hit checks count only alive lanes that hit);
    f, wi, pdf the BSDF sample at the hit."""
    hit_lane = alive_in & hit.hit
    t_hi = rays.t_max * (1.0 + 1e-3)
    n_len = vm.length(hit.normal)
    wi_len = vm.length(wi)
    tn = torch.abs(vm.dot(frame.t, frame.n))
    tb = torch.abs(vm.dot(frame.t, frame.b))
    bn = torch.abs(vm.dot(frame.b, frame.n))
    counts = [
        _count(_any_nonfinite(radiance)),
        _count((radiance < _NEG_TOL).any(dim=-1)),
        _count(alive_in & _any_nonfinite(beta)),
        _count(alive_in & (beta < _NEG_TOL).any(dim=-1)),
        _count(hit_lane & ((hit.t <= 0.0) | (hit.t > t_hi))),
        _count(hit_lane & (torch.abs(n_len - 1.0) > _UNIT_TOL)),
        _count(hit_lane & ((tn > _ORTHO_TOL) | (tb > _ORTHO_TOL)
                           | (bn > _ORTHO_TOL))),
        _count(hit_lane & _any_nonfinite(hit.pos)),
        _count(hit_lane & (~torch.isfinite(pdf) | (pdf < 0.0))),
        _count(hit_lane & (torch.abs(wi_len - 1.0) > _UNIT_TOL)),
        _count(hit_lane & _any_nonfinite(f)),
    ]
    bad_mat = torch.zeros_like(hit_lane)
    if lobes is not None:
        for field in (lobes.albedo, lobes.specular, lobes.alpha,
                      lobes.eta, lobes.eta_t, lobes.k):
            flat = field.reshape(field.shape[0], -1)
            bad_mat = bad_mat | ~torch.isfinite(flat).all(dim=-1)
    if emit is not None:
        bad_mat = bad_mat | _any_nonfinite(emit)
    counts.append(_count(hit_lane & bad_mat))
    return torch.stack(counts)


def report(counts) -> dict:
    """[K] vector -> {key: int} (on the host)."""
    c = torch.as_tensor(counts).cpu()
    return {k: int(c[i]) for i, k in enumerate(AUDIT_KEYS)}


def format_report(rep: dict) -> str:
    total = sum(rep.values())
    lines = [f"debug_checks: {total} violation(s)"]
    for k, v in rep.items():
        mark = "FAIL" if v else "ok"
        lines.append(f"  {mark:4s} {k:24s} {v}")
    return "\n".join(lines)
