"""Equirect environment-map importance sampling. Mirrors
pbrs_tpu/lights/env_sampling.py: ``build_distribution`` (host), and
``sample_env``, ``eval_env_pdf`` and ``pdf_env`` on tensors.

The host build weights every texel by luminance * sin(theta) and compiles
the normalized texel probabilities into a flat Vose alias table over all
H*W texels, both outcomes' payloads packed per bucket row, so one draw is
one row gather. pdf(dir) = p_img(u, v) * H * W / (2 pi^2 sin(theta)), the
Jacobian of the equirect (u, v) -> direction map.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import lights as lt


@dataclass
class EnvDistribution:
    """Piecewise-constant 2-D distribution over the equirect image."""

    marginal_cdf: torch.Tensor  # [H+1] over rows, cdf[0]=0, cdf[H]=1
    conditional_cdf: torch.Tensor  # [H, W+1] per-row cdf
    pdf_img: torch.Tensor  # [H, W] normalized texel density (sums to 1)
    image: torch.Tensor  # [H, W, 3]
    scale: torch.Tensor  # [3]
    # Flat alias table over the H*W texels; per bucket row: [q, b_row,
    # b_col, b_r, b_g, b_b, b_p, a_row, a_col, a_r, a_g, a_b, a_p] --
    # threshold + (row, col, radiance, texel probability) of the bucket
    # texel and of its alias.
    alias_packed: torch.Tensor  # [H*W, 13]

    def to(self, device) -> "EnvDistribution":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def build_distribution(image, scale=(1.0, 1.0, 1.0)) -> EnvDistribution:
    """Host-side build from the [H, W, 3] equirect radiance map."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    lum = (0.21267127 * img[..., 0] + 0.71515972 * img[..., 1]
           + 0.07216883 * img[..., 2])
    # sin(theta) row weight: the solid angle of an equirect texel row.
    theta = (np.arange(h) + 0.5) / h * np.pi
    weight = lum * np.sin(theta)[:, None]
    total = weight.sum()
    if total <= 0:
        weight = np.ones_like(weight)
        total = weight.sum()
    pdf_img = (weight / total).astype(np.float32)  # [H, W], sums to 1

    row_w = pdf_img.sum(axis=1)  # [H]
    marginal = np.zeros(h + 1, np.float32)
    marginal[1:] = np.cumsum(row_w)
    marginal[-1] = 1.0

    cond = np.zeros((h, w + 1), np.float32)
    safe_row = np.where(row_w > 0, row_w, 1.0)
    cond[:, 1:] = np.cumsum(pdf_img / safe_row[:, None], axis=1)
    cond[:, -1] = 1.0

    # Flat Vose alias table over the H*W texels.
    p = pdf_img.reshape(-1).astype(np.float64)
    hw = p.size
    scaled = p * hw
    q = np.ones(hw, np.float64)
    alias = np.arange(hw, dtype=np.int64)
    small = [i for i in range(hw) if scaled[i] < 1.0]
    large = [i for i in range(hw) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        q[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    for i in small + large:
        q[i] = 1.0

    rows_i = (np.arange(hw, dtype=np.int64) // w).astype(np.float32)
    cols_i = (np.arange(hw, dtype=np.int64) % w).astype(np.float32)
    rgb = img.reshape(hw, 3)
    p32 = pdf_img.reshape(-1)

    def payload(idx):
        return np.concatenate([
            rows_i[idx, None], cols_i[idx, None], rgb[idx], p32[idx, None],
        ], axis=1)

    alias_packed = np.concatenate(
        [q[:, None].astype(np.float32), payload(np.arange(hw)),
         payload(alias)], axis=1)
    t = torch.from_numpy
    return EnvDistribution(
        marginal_cdf=t(marginal), conditional_cdf=t(cond), pdf_img=t(pdf_img),
        image=t(img.copy()),
        scale=t(np.asarray(scale, np.float32).reshape(3).copy()),
        alias_packed=t(np.ascontiguousarray(alias_packed, np.float32)))


def _dir_from_uv(u, v):
    """Equirect (u, v) in [0,1)^2 -> unit direction; the inverse of the
    lookup in lights.eval_env (phi = atan2(z, x), theta from +y)."""
    phi = (u - 0.5) * (2.0 * math.pi)
    theta = v * math.pi
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.cos(phi), torch.cos(theta),
                        sin_t * torch.sin(phi)], dim=-1)


def sample_env(dist: EnvDistribution, u2):
    """Directions drawn from the distribution through the alias table.

    u2: [N, 2] uniforms. Returns (dir [N,3], radiance [N,3], pdf [N]), the
    pdf w.r.t. solid angle (0 only at degenerate poles). The position
    inside the texel comes from the residual uniforms, so the continuous
    (u, v) density stays p_img * H * W."""
    h, w = dist.pdf_img.shape
    hw = h * w
    u, v = u2[..., 0], u2[..., 1]
    x = torch.clamp(v, 0.0, 1.0 - 1e-7) * hw
    b = torch.clamp(x.to(torch.int32), 0, hw - 1)
    rowv = dist.alias_packed[b.to(torch.int64)]  # [N, 13]
    q = rowv[..., 0]
    take_alias = u >= q
    sel = torch.where(take_alias[..., None], rowv[..., 7:13], rowv[..., 1:7])
    ju = torch.where(take_alias,
                     (u - q) / torch.clamp_min(1.0 - q, 1e-12),
                     u / torch.clamp_min(q, 1e-12))
    jv = x - b.to(torch.float32)
    row_f, col_f = sel[..., 0], sel[..., 1]
    radiance = sel[..., 2:5] * dist.scale
    p_img = sel[..., 5]
    uu = (col_f + torch.clamp(ju, 0.0, 1.0 - 1e-6)) / w
    vv = (row_f + torch.clamp(jv, 0.0, 1.0 - 1e-6)) / h
    direction = _dir_from_uv(uu, vv)
    sin_t = torch.sqrt(torch.clamp_min(
        1.0 - direction[..., 1] * direction[..., 1], 0.0))
    pdf = p_img * hw / torch.clamp_min(2.0 * math.pi * math.pi * sin_t, 1e-8)
    return direction, radiance, pdf


def _texel(dist, directions):
    h, w = dist.pdf_img.shape
    d = directions / torch.clamp_min(
        torch.linalg.norm(directions, dim=-1, keepdim=True), 1e-30)
    return lt.equirect_texel(d, h, w)


def _solid_angle_pdf(dist, p_img, theta):
    h, w = dist.pdf_img.shape
    return p_img * (h * w) / torch.clamp_min(
        2.0 * math.pi * math.pi * torch.sin(theta), 1e-8)


def eval_env_pdf(env, directions):
    """(radiance [N,3], solid-angle pdf [N]) along directions, from one
    texel lookup."""
    dist = env.dist
    assert tuple(env.image.shape[:2]) == tuple(dist.pdf_img.shape)
    row, col, theta = _texel(dist, directions)
    rgb = env.image[row, col] * env.scale
    return rgb, _solid_angle_pdf(dist, dist.pdf_img[row, col], theta)


def pdf_env(dist: EnvDistribution, directions):
    """Solid-angle pdf of the distribution along arbitrary directions (the
    MIS weight of the BSDF-sampled arm)."""
    row, col, theta = _texel(dist, directions)
    return _solid_angle_pdf(dist, dist.pdf_img[row, col], theta)
