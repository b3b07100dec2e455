"""Texture table. Mirrors pbrs_tpu/textures/textures.py: solid, 3D
checker, Perlin marble and image textures (nearest texel, uv clamped, from
one flat atlas of every image's pixels).

Perlin noise is the JAX package's gather-free variant: a murmur-style
lattice hash and Perlin's 16-direction gradients. The hash wraps like
uint32; PyTorch's CPU build has no uint32 shifts or adds, so it runs on
int64 tensors masked to 32 bits, with products split into 16-bit halves
(core/sampler.py does the same for PCG).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core import sampler as smp

SOLID = 0
CHECKER = 1
PERLIN = 2
IMAGE = 3

PERLIN_OCTAVES = 7
HASH_C = (0x8DA6B343, 0xD8163841, 0xCB1AB31F, 0x85EBCA6B)


@dataclass
class TextureTable:
    kind: torch.Tensor  # [T] int32
    color_a: torch.Tensor  # [T,3] solid color / checker even
    color_b: torch.Tensor  # [T,3] checker odd
    freq: torch.Tensor  # [T] perlin frequency
    img_offset: torch.Tensor  # [T] int32 offset into the atlas
    img_w: torch.Tensor  # [T] int32
    img_h: torch.Tensor  # [T] int32
    atlas: torch.Tensor  # [P,3] every image's pixels, row-major
    present_kinds: tuple = (SOLID,)

    @property
    def num_textures(self):
        return self.kind.shape[0]

    def to(self, device) -> "TextureTable":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _hash3(ix, iy, iz):
    """Murmur-style mix of three lattice coordinates (int64 tensors holding
    int32 values) -> uint32 bits held in int64."""
    c1, c2, c3, c4 = HASH_C
    m = smp.MASK32
    h = smp._mul32(ix & m, c1)
    h = (h + smp._mul32(iy & m, c2)) & m
    h = (h + smp._mul32(iz & m, c3)) & m
    h = h ^ (h >> 13)
    h = smp._mul32(h, c4)
    return h ^ (h >> 16)


def _grad_dot(h, x, y, z):
    """Perlin's 16-direction gradient dot product, branchless."""
    hi = h & 15
    u = torch.where(hi < 8, x, y)
    v = torch.where(hi < 4, y, torch.where((hi == 12) | (hi == 14), x, z))
    su = torch.where((hi & 1) == 0, u, -u)
    sv = torch.where((hi & 2) == 0, v, -v)
    return su + sv


def perlin_noise(sx, sy, sz):
    """Gradient lattice noise with smoothstep trilinear weights, on
    coordinate planes."""
    fl = [torch.floor(s) for s in (sx, sy, sz)]
    ix, iy, iz = (f.to(torch.int64) for f in fl)
    fx, fy, fz = (s - f for s, f in zip((sx, sy, sz), fl))
    smx, smy, smz = (f * f * (3.0 - 2.0 * f) for f in (fx, fy, fz))
    acc = torch.zeros_like(sx)
    for di in (0, 1):
        wu = smx * di + (1.0 - smx) * (1 - di)
        for dj in (0, 1):
            wj = smy * dj + (1.0 - smy) * (1 - dj)
            for dk in (0, 1):
                wk = smz * dk + (1.0 - smz) * (1 - dk)
                h = _hash3(ix + di, iy + dj, iz + dk)
                acc = acc + wu * wj * wk * _grad_dot(h, fx - di, fy - dj,
                                                     fz - dk)
    # The 16 gradients have length sqrt(2); scale to unit amplitude.
    return acc * float(1.0 / np.sqrt(2.0))


def marble(px, py, pz, freq):
    """Perlin marble sin(freq z + 10 turbulence(p)) / 2 + 1/2 over
    PERLIN_OCTAVES octaves of the lattice scaled by freq 2^i."""
    acc = torch.zeros_like(px)
    for i in range(PERLIN_OCTAVES):
        sc = freq * (2.0 ** i)
        acc = acc + (0.5 ** i) * perlin_noise(px * sc, py * sc, pz * sc)
    return torch.sin(freq * pz + 10.0 * torch.abs(acc)) * 0.5 + 0.5


def eval_texture(table: TextureTable, tex_id, uv, pos):
    """Texture values [N,3] for per-hit ids [N] at positions [N,3]; uv [N,2]
    is read by image textures only. tex_id < 0 gives black."""
    present = table.present_kinds
    i = torch.clamp_min(tex_id, 0).to(torch.int64)
    kind = table.kind[i]
    ca, cb, freq = table.color_a[i], table.color_b[i], table.freq[i]
    out = ca
    px, py, pz = pos[..., 0], pos[..., 1], pos[..., 2]
    if CHECKER in present:
        sines = torch.sin(10.0 * px) * torch.sin(10.0 * py) * torch.sin(
            10.0 * pz)
        checker = torch.where((sines < 0.0)[..., None], cb, ca)
        out = torch.where((kind == CHECKER)[..., None], checker, out)
    if PERLIN in present:
        m = marble(px, py, pz, freq)
        out = torch.where((kind == PERLIN)[..., None], m[..., None], out)
    if IMAGE in present:
        # Nearest texel with uv clamped to [0, 1].
        w, h, off = table.img_w[i], table.img_h[i], table.img_offset[i]
        u = torch.clamp(uv[..., 0], 0.0, 1.0)
        v = torch.clamp(uv[..., 1], 0.0, 1.0)
        col = torch.remainder((u * w).to(torch.int32), torch.clamp_min(w, 1))
        row = torch.remainder((v * h).to(torch.int32), torch.clamp_min(h, 1))
        pix = table.atlas[(off + row * w + col).to(torch.int64)]
        out = torch.where((kind == IMAGE)[..., None], pix, out)
    return torch.where((tex_id < 0)[..., None], 0.0, out)


class TextureBuilder:
    """Host-side accumulator; `add_*` returns the texture id."""

    def __init__(self):
        self.rows = []  # (kind, color_a, color_b, freq, image or None)

    def add_solid(self, color) -> int:
        self.rows.append((SOLID, np.asarray(color, np.float32), np.zeros(3),
                          1.0, None))
        return len(self.rows) - 1

    def add_checker(self, even, odd) -> int:
        self.rows.append((CHECKER, np.asarray(even, np.float32),
                          np.asarray(odd, np.float32), 1.0, None))
        return len(self.rows) - 1

    def add_perlin(self, freq: float) -> int:
        self.rows.append((PERLIN, np.zeros(3), np.zeros(3), float(freq), None))
        return len(self.rows) - 1

    def add_image(self, pixels_hw3) -> int:
        img = np.asarray(pixels_hw3, np.float32)
        assert img.ndim == 3 and img.shape[2] == 3
        self.rows.append((IMAGE, np.zeros(3), np.zeros(3), 1.0, img))
        return len(self.rows) - 1

    def add_image_file(self, path: str) -> int:
        from ..io import image as io_image

        return self.add_image(io_image.read_png_rgb(path))

    def build(self) -> TextureTable:
        rows = self.rows or [(SOLID, np.zeros(3), np.zeros(3), 1.0, None)]
        offsets, widths, heights, parts = [], [], [], []
        cursor = 0
        for *_, img in rows:
            if img is None:
                offsets.append(0)
                widths.append(0)
                heights.append(0)
            else:
                offsets.append(cursor)
                heights.append(img.shape[0])
                widths.append(img.shape[1])
                parts.append(img.reshape(-1, 3))
                cursor += img.shape[0] * img.shape[1]
        atlas = (np.concatenate(parts, axis=0) if parts
                 else np.zeros((1, 3), np.float32))
        t = torch.from_numpy
        kind = np.asarray([r[0] for r in rows], np.int32)
        return TextureTable(
            kind=t(kind), present_kinds=tuple(sorted(set(kind.tolist()))),
            color_a=t(np.stack([r[1] for r in rows]).astype(np.float32)),
            color_b=t(np.stack([r[2] for r in rows]).astype(np.float32)),
            freq=t(np.asarray([r[3] for r in rows], np.float32)),
            img_offset=t(np.asarray(offsets, np.int32)),
            img_w=t(np.asarray(widths, np.int32)),
            img_h=t(np.asarray(heights, np.int32)),
            atlas=t(atlas.astype(np.float32)))
