"""Counter-based stateless PCG sampler. Mirrors pbrs_tpu/core/sampler.py
(the PCG stream only; Sobol' and threefry are not ported yet).

Every draw is a pure function of (seed, pixel, sample, bounce*16+dim,
lane), bit-identical to ``pbrs_tpu.core.sampler.PCGSampler`` and to the
in-kernel draw of the fused bounce (``csrc/fused_bounce.cu``).

The hash runs on int64 tensors that hold uint32 values, masked to 32 bits
after every step: PyTorch's CPU build has no uint32 ``<<``, ``>>`` or
``+``. Products are split into 16-bit halves so no int64 product
overflows. Every helper also accepts plain Python ints.
"""

from __future__ import annotations

import torch

# Purpose/dimension ids -- one stream per logical decision per bounce.
DIM_CAMERA_JITTER = 0
DIM_LIGHT_SELECT = 1
DIM_LIGHT_UV = 2
DIM_SCATTER_UV = 3
DIM_BSDF_UV = 4
DIM_RUSSIAN_ROULETTE = 5
DIM_SPECULAR_CHOICE = 6
DIM_CAMERA_STRATUM = 7
DIM_COMPACT = 8

MASK32 = 0xFFFFFFFF


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


def _mul32(a, c: int):
    """(a * c) mod 2^32 for a in [0, 2^32) and a constant c < 2^32."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _rotl32(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def _pcg_permute(x):
    """PCG output permutation (RXS-M-XS variant) on uint32 values."""
    word = _mul32((x >> ((x >> 28) + 4)) ^ x, 277803737)
    return (word >> 22) ^ word


def _mix(h, k):
    """One absorb step: murmur3-style mixing of k into state h."""
    k = _mul32(_u32(k), 0xCC9E2D51)
    k = _rotl32(k, 15)
    k = _mul32(k, 0x1B873593)
    h = h ^ k
    h = _rotl32(h, 13)
    return (_mul32(h, 5) + 0xE6546B64) & MASK32


def _finalize(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_u32(*counters):
    """Hash int counters (tensors or ints) to uint32 bits, held in int64."""
    h = 0x9E3779B9
    for c in counters:
        h = _mix(h, c)
    return _pcg_permute(_finalize(h))


def uniform_from_u32(bits):
    """uint32 bits -> float32 in [0, 1) from the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


class PCGSampler:
    """Stateless sampler: draws are pure functions of the counter tuple.
    The seed is a plain Python int; nothing reads torch's global RNG."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed) & MASK32

    def u1(self, pixel, sample, bounce, dim, lane=0):
        return uniform_from_u32(
            hash_u32(self.seed, pixel, sample, bounce * 16 + dim, lane))

    def u2(self, pixel, sample, bounce, dim):
        return torch.stack([self.u1(pixel, sample, bounce, dim, lane=0),
                            self.u1(pixel, sample, bounce, dim, lane=1)],
                           dim=-1)


def stratified_jitter(sampler, pixel, sample, msaa: int):
    """Per-sample stratified jitter inside the pixel: sample i of msaa^2
    lands in stratum (i // msaa, i % msaa); ids >= msaa^2 take a random
    stratum. Returns (dx, dy) in [0,1)^2. [pbrs_tpu/core/sampler.py:242]"""
    u = sampler.u2(pixel, sample, 0, DIM_CAMERA_JITTER)
    n_strata = msaa * msaa
    if not isinstance(sample, torch.Tensor) and int(sample) < n_strata:
        k = int(sample)
        sx, sy = float((k // msaa) % msaa), float(k % msaa)
    else:
        i = torch.as_tensor(sample, device=pixel.device)
        u_s = sampler.u1(pixel, sample, 0, DIM_CAMERA_STRATUM)
        rand_k = torch.clamp_max((u_s * n_strata).to(torch.int64),
                                 n_strata - 1)
        k = torch.where(i >= n_strata, rand_k, i.to(torch.int64))
        sx = ((k // msaa) % msaa).to(torch.float32)
        sy = (k % msaa).to(torch.float32)
    dx = (sx + u[..., 0]) / msaa
    dy = (sy + u[..., 1]) / msaa
    return dx, dy
