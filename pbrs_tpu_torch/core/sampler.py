"""Counter-based stateless samplers. Mirrors pbrs_tpu/core/sampler.py:
``PCGSampler``, the Owen-scrambled ``SobolSampler`` and ``ThreefrySampler``.

Every draw is a pure function of (seed, pixel, sample, bounce*16+dim,
lane), bit-identical to the same class of ``pbrs_tpu.core.sampler``; the
PCG and Sobol' streams also to the in-kernel draws of the fused kernels
(``csrc/bounce_common.cuh``).

The hashes run on int64 tensors that hold uint32 values, masked to 32 bits
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


def _absorb(*counters):
    h = 0x9E3779B9
    for c in counters:
        h = _mix(h, c)
    return h


def hash_u32(*counters):
    """Hash int counters (tensors or ints) to uint32 bits, held in int64."""
    return _pcg_permute(_finalize(_absorb(*counters)))


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


# --------------------------- Sobol' (Owen-scrambled) -------------------------
#
# Burley, "Practical Hash-based Owen Scrambling" (JCGT 2020): every logical
# dimension (bounce*16+dim, lane) draws the base-2 Sobol' pair (dimension 0
# the bit-reversed van der Corput sequence, dimension 1 the classic
# direction numbers), padded across logical dimensions by a nested-uniform
# (Laine-Karras) shuffle of the sample index keyed by (seed, pixel,
# dimension), and Owen-scrambled on output with an independent key.

# Direction numbers of Sobol' dimension 1 (primitive polynomial x + 1).
_SOBOL_DIM1 = []
_v = 1 << 31
for _k in range(32):
    _SOBOL_DIM1.append(_v)
    _v ^= _v >> 1
_SOBOL_DIM1 = tuple(_SOBOL_DIM1)
SHUFFLE_SALT, SCRAMBLE_SALT = 0x51633E2D, 0x68BC21EB


def _reverse_bits_u32(x):
    x = ((x << 16) & MASK32) | (x >> 16)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    return ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)


def _laine_karras(x, seed):
    """Owen scramble of a bit-reversed value (Burley 2020, section 10.2)."""
    x = (_u32(x) + _u32(seed)) & MASK32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def nested_uniform_scramble(x, seed):
    """Owen scramble on the natural bit order (reverse, LK, reverse)."""
    return _reverse_bits_u32(_laine_karras(_reverse_bits_u32(_u32(x)), seed))


def sobol_u32(index, dim: int):
    """Unscrambled base-2 Sobol' sample `index` of dimension `dim` (0/1) as
    uint32 bits."""
    index = _u32(index)
    if dim == 0:
        return _reverse_bits_u32(index)
    out = index * 0
    for k in range(32):
        out = out ^ (((index >> k) & 1) * _SOBOL_DIM1[k])
    return out


def _sobol_draws(seed, pixel, sample, bounce, dim, lane, sobol_dims):
    """Owen-scrambled Sobol' draws as uint32 bits, one per Sobol' dimension
    in sobol_dims: the sample index shuffled under hash_u32(seed, pixel,
    bounce*16+dim, lane, SHUFFLE_SALT), each dimension scrambled under the
    same hash with SCRAMBLE_SALT + dimension. The hashes share the mixing
    of their first four counters."""
    h = _absorb(seed, pixel, (bounce * 16 + dim) & MASK32, lane)

    def key(salt):
        return _pcg_permute(_finalize(_mix(h, salt & MASK32)))

    idx = nested_uniform_scramble(sample, key(SHUFFLE_SALT))
    return [nested_uniform_scramble(sobol_u32(idx, d), key(SCRAMBLE_SALT + d))
            for d in sobol_dims]


def sobol_bits(seed, pixel, sample, bounce, dim, lane, sobol_dim):
    """One Owen-scrambled Sobol' draw (Sobol' dimension `sobol_dim`) as
    uint32 bits."""
    return _sobol_draws(seed, pixel, sample, bounce, dim, lane,
                        (sobol_dim,))[0]


class SobolSampler:
    """Stateless Owen-scrambled Sobol'; a drop-in for PCGSampler. u2 draws
    the 2-D Sobol' pair under hash lane 0; u1 draws dimension 0 under hash
    lane `lane`."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed) & MASK32

    def u1(self, pixel, sample, bounce, dim, lane=0):
        return uniform_from_u32(
            sobol_bits(self.seed, pixel, sample, bounce, dim, lane, 0))

    def u2(self, pixel, sample, bounce, dim):
        # One shuffled index for both axes: the pair is a true 2-D Sobol'
        # point.
        return torch.stack([uniform_from_u32(b) for b in _sobol_draws(
            self.seed, pixel, sample, bounce, dim, 0, (0, 1))], dim=-1)


# ------------------------------- threefry ----------------------------------
#
# jax.random's threefry2x32 key chain, bit for bit: a key is two uint32
# words; fold_in(key, c) = threefry2x32(key, (0, c)); uniform(key) takes
# the XOR of threefry2x32(key, (0, 0))'s two words (the partitionable
# random-bits layout) and keeps the top 23 bits as a float32 mantissa.

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


class ThreefrySampler:
    """jax.random-backed sampler of pbrs_tpu (threefry key chains), for
    cross-validation; the fused kernels do not draw it."""

    def __init__(self, seed: int = 0):
        seed = int(seed)
        self.key = ((seed >> 32) & MASK32, seed & MASK32)

    def u1(self, pixel, sample, bounce, dim, lane=0):
        pixel = _u32(pixel)
        k0, k1 = self.key
        for c in (pixel, sample, bounce * 16 + dim, lane):
            k0, k1 = threefry2x32(k0, k1, 0, _u32(c))
        b0, b1 = threefry2x32(k0, k1, 0, 0)
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        one = (bits + pixel * 0).to(torch.int32).view(torch.float32)
        return torch.clamp_min(one - 1.0, 0.0)

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
