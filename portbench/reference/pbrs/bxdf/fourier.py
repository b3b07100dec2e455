"""Fourier-basis measured BSDF (layerlab "SCATFUN" format). Mirrors
pbrs_tpu/bxdf/fourier.py: the isotropic spline x Fourier BSDF of Jakob et
al. 2014.

Host side (NumPy): parse the binary table and pad the ragged a_k runs into
a dense [n_mu^2, C, M] array; stack several tables along the row axis
(``concat_tables``) so every eval / pdf / sample takes a per-lane
``table_idx``.

Tensor side:
* ``eval_fourier`` -- Catmull-Rom weights over both zenith grids, a
  16-pair weighted coefficient mix, a Chebyshev cosine series;
* ``pdf_fourier`` -- the luminance series over the per-mu_o CDF total;
* ``sample_fourier_bsdf`` -- inverse-CDF zenith sampling over the
  tabulated a0 marginal (piecewise linear) and a fixed 24-step
  Newton-bisection for the azimuth.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..core import spline as spl

M_CAP = 128


@dataclass
class FourierTable:
    mu: torch.Tensor  # [n_mu]
    cdf: torch.Tensor  # [T*n_mu, n_mu] row = o index, col = i index
    a0: torch.Tensor  # [T*n_mu, n_mu] order-0 luminance coefficient
    a_dense: torch.Tensor  # [T*n_mu*n_mu, C, M] padded coefficients
    m_lookup: torch.Tensor  # [T*n_mu, n_mu] int32 series length
    eta: float = 1.0
    n_channels: int = 3
    m_cap: int = M_CAP
    n_tables: int = 1

    def to(self, device) -> "FourierTable":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def load_scatfun(path: str) -> FourierTable:
    """Parse a layerlab .bsdf file."""
    with open(path, "rb") as f:
        raw = f.read()
    assert raw[:7] == b"SCATFUN", "not a SCATFUN file"
    version, flags, n_mu, n_coeffs, m_max, n_channels, n_bases = struct.unpack(
        "<BIiiiii", raw[7:7 + 1 + 4 * 6])
    assert version == 1 and flags == 1, (version, flags)
    (_n_meta, _n_par, _n_parv, eta, _a0, _a1, _u0, _u1) = struct.unpack(
        "<iiifffff", raw[32:64])
    off = 64
    mu = np.frombuffer(raw, "<f4", n_mu, off)
    off += 4 * n_mu
    cdf = np.frombuffer(raw, "<f4", n_mu * n_mu, off)
    off += 4 * n_mu * n_mu
    ol = np.frombuffer(raw, "<i4", n_mu * n_mu * 2, off)
    off += 4 * n_mu * n_mu * 2
    a = np.frombuffer(raw, "<f4", n_coeffs, off)
    return build_table(n_channels, mu, cdf.reshape(n_mu, n_mu), ol[0::2],
                       ol[1::2], a, eta=eta)


def build_table(n_channels, mu, cdf, a_offset, m_lookup, coefficients,
                eta=1.0, m_cap=M_CAP) -> FourierTable:
    """Dense-pad the ragged coefficient runs."""
    mu = np.asarray(mu, np.float32)
    n_mu = mu.shape[0]
    cdf = np.asarray(cdf, np.float32).reshape(n_mu, n_mu)
    a_offset = np.asarray(a_offset, np.int64).reshape(-1)
    m_lookup = np.asarray(m_lookup, np.int64).reshape(-1)
    coefficients = np.asarray(coefficients, np.float32)
    m_cap = int(min(m_cap, max(1, m_lookup.max())))

    a_dense = np.zeros((n_mu * n_mu, n_channels, m_cap), np.float32)
    a0 = np.zeros(n_mu * n_mu, np.float32)
    for idx in range(n_mu * n_mu):
        m = int(m_lookup[idx])
        if m == 0:
            continue
        start = int(a_offset[idx])
        run = coefficients[start:start + m * n_channels].reshape(
            n_channels, m)
        keep = min(m, m_cap)
        a_dense[idx, :, :keep] = run[:, :keep]
        a0[idx] = run[0, 0]
    t = torch.from_numpy
    return FourierTable(
        mu=t(mu.copy()), cdf=t(cdf.copy()), a0=t(a0.reshape(n_mu, n_mu)),
        a_dense=t(a_dense),
        m_lookup=t(np.minimum(m_lookup, m_cap).reshape(n_mu, n_mu).astype(
            np.int32)),
        eta=float(eta), n_channels=int(n_channels), m_cap=m_cap)


def make_lambert_table(albedo=0.5, n_mu=16) -> FourierTable:
    """Synthetic table of a Lambertian BRDF: the stored function is
    (rho / pi) |mu_i| with a single order-0 coefficient."""
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    n = n_mu
    a0 = np.zeros((n, n), np.float32)
    for o in range(n):
        for i in range(n):
            # Reflection only: the incident grid value is -wi.z.
            if mu[o] > 0 and mu[i] < 0:
                a0[o, i] = albedo / np.pi * abs(mu[i])
    # Unnormalised CDF over mu_i per mu_o row; its last column is the
    # row's total.
    cdf = np.zeros((n, n), np.float32)
    for o in range(n):
        acc = 0.0
        for i in range(1, n):
            acc += 0.5 * (a0[o, i] + a0[o, i - 1]) * (mu[i] - mu[i - 1])
            cdf[o, i] = acc
    m_lookup = (a0 > 0).astype(np.int64).reshape(-1)
    a_offset = np.arange(n * n, dtype=np.int64) * 3
    coeffs = np.zeros(n * n * 3, np.float32)
    # Channel layout of a run: [y..., r..., b...] with m = 1.
    coeffs[0::3] = a0.reshape(-1)
    coeffs[1::3] = a0.reshape(-1)
    coeffs[2::3] = a0.reshape(-1)
    return build_table(3, mu, cdf, a_offset, m_lookup, coeffs)


def truncation_energy_ratio(m_lookup, a_offset, coefficients, n_channels,
                            m_cap=M_CAP) -> float:
    """Share of the summed |a_k| (luminance channel) dropped by capping the
    series at m_cap; 0.0 means the cap loses nothing."""
    m_lookup = np.asarray(m_lookup, np.int64).reshape(-1)
    a_offset = np.asarray(a_offset, np.int64).reshape(-1)
    coefficients = np.asarray(coefficients, np.float32)
    kept = 0.0
    dropped = 0.0
    for idx in range(m_lookup.shape[0]):
        m = int(m_lookup[idx])
        if m == 0:
            continue
        start = int(a_offset[idx])
        y_run = np.abs(coefficients[start:start + m])
        kept += float(y_run[:m_cap].sum())
        dropped += float(y_run[m_cap:].sum())
    total = kept + dropped
    return dropped / total if total > 0 else 0.0


def concat_tables(tables) -> FourierTable:
    """Stack several tables into one multi-table FourierTable. The mu grids
    must match; m_cap pads to the largest; 1-channel tables repeat the
    luminance run into the r / b channels."""
    if len(tables) == 1:
        return tables[0]
    mu0 = tables[0].mu.numpy()
    for t in tables[1:]:
        if tuple(t.mu.shape) != mu0.shape or not np.allclose(
                t.mu.numpy(), mu0, atol=1e-6):
            raise ValueError(
                "fourier tables with differing mu grids cannot share a "
                "scene; resample offline")
    m_cap = max(t.m_cap for t in tables)
    n_ch = max(t.n_channels for t in tables)
    denses = []
    for t in tables:
        d = t.a_dense.numpy()
        if t.n_channels < n_ch:
            d = np.repeat(d, n_ch, axis=1)[:, :n_ch]
        if t.m_cap < m_cap:
            d = np.pad(d, ((0, 0), (0, 0), (0, m_cap - t.m_cap)))
        denses.append(d)
    cat = torch.cat
    return FourierTable(
        mu=torch.from_numpy(mu0.copy()),
        cdf=cat([t.cdf for t in tables]), a0=cat([t.a0 for t in tables]),
        a_dense=torch.from_numpy(np.concatenate(denses, axis=0)),
        m_lookup=cat([t.m_lookup for t in tables]),
        eta=tables[0].eta, n_channels=n_ch, m_cap=m_cap,
        n_tables=len(tables))


# ------------------------------ tensor side --------------------------------


def _cos_dphi(wo, wi_neg):
    """cos of the azimuth difference."""
    x0, y0 = wo[..., 0], wo[..., 1]
    x1, y1 = wi_neg[..., 0], wi_neg[..., 1]
    denom = torch.sqrt((x0 * x0 + y0 * y0) * (x1 * x1 + y1 * y1))
    r = (x0 * x1 + y0 * y1) / torch.where(denom == 0.0, 1.0, denom)
    r = torch.where(denom == 0.0, 0.0, r)
    return torch.clamp(r, -1.0, 1.0)


def _tidx(table, table_idx, like):
    if table.n_tables == 1 or table_idx is None:
        return torch.zeros(like.shape, dtype=torch.int64, device=like.device)
    return torch.clamp(table_idx.to(torch.int64), 0, table.n_tables - 1)


def _tap_sum(w, rows):
    """sum_k w[:, k] rows[:, k]: w [N, K], rows [N, K, ...]. Summed as a
    fused multiply-add chain in tap order (float64 steps, each rounded to
    float32: the order of XLA's CPU dot), so a lane's mix is bit-equal to
    pbrs_tpu's on the CPU; near a grazing zenith f ~ 1 / |mu_i| turns one
    ulp of the interpolated CDF into a visible difference."""
    w = w.to(torch.float64).reshape(w.shape + (1,) * (rows.dim() - 2))
    rows = rows.to(torch.float64)
    acc = (w[:, 0] * rows[:, 0]).to(torch.float32)
    for k in range(1, w.shape[1]):
        acc = (w[:, k] * rows[:, k] + acc).to(torch.float32)
    return acc


def _mix_coefficients(table: FourierTable, mu_i, mu_o, table_idx=None):
    """Catmull-Rom-weighted 16-pair coefficient mix: ak [N, C, M], the
    valid mask and (off_o, w_o, taps_o)."""
    n_mu = table.mu.shape[0]
    off_i, w_i = spl.catmull_rom_weights(table.mu, mu_i)
    off_o, w_o = spl.catmull_rom_weights(table.mu, mu_o)
    taps_i = spl.catmull_rom_taps(table.mu, off_i)
    taps_o = spl.catmull_rom_taps(table.mu, off_o)
    w = w_o[..., :, None] * w_i[..., None, :]
    pair = taps_o[..., :, None] * n_mu + taps_i[..., None, :]
    flat_pair = pair.reshape(pair.shape[0], 16)
    tid = _tidx(table, table_idx, mu_i)
    flat_pair = flat_pair + (tid * n_mu * n_mu)[..., None]
    flat_w = w.reshape(w.shape[0], 16)
    ak = _tap_sum(flat_w, table.a_dense[flat_pair])  # [N, C, M]
    lo, hi = table.mu[0], table.mu[-1]
    valid = (mu_i >= lo) & (mu_i <= hi) & (mu_o >= lo) & (mu_o <= hi)
    return ak, valid, (off_o, w_o, taps_o)


def _cos_basis(cos_phi, m):
    """cos(k phi) for k in [0, m) by the Chebyshev recurrence: [N, m]."""
    prev, cur = cos_phi, torch.ones_like(cos_phi)
    ks = []
    for _ in range(m):
        ks.append(cur)
        prev, cur = cur, 2.0 * cos_phi * cur - prev
    return torch.stack(ks, dim=-1)


def _series(ak, basis):
    return torch.sum(ak * basis[..., None, :], dim=-1)  # [N, C]


def _rgb_from_channels(y, r, b, scale):
    g = 1.39829 * y - 0.100913 * b - 0.297375 * r
    rgb = torch.stack([r, g, b], dim=-1) * scale[..., None]
    return torch.clamp_min(rgb, 0.0)


def _color(table, vals, mu_i):
    scale = torch.where(mu_i != 0.0, 1.0 / torch.abs(mu_i), 0.0)
    if table.n_channels == 1:
        y = torch.clamp_min(vals[..., 0], 0.0) * scale
        return torch.stack([y, y, y], dim=-1)
    return _rgb_from_channels(torch.clamp_min(vals[..., 0], 0.0),
                              vals[..., 1], vals[..., 2], scale)


def eval_fourier(table: FourierTable, wo, wi, table_idx=None):
    """f(wo, wi) [N, 3]."""
    mu_i = -wi[..., 2]
    mu_o = wo[..., 2]
    cos_phi = _cos_dphi(wo, -wi)
    ak, valid, _ = _mix_coefficients(table, mu_i, mu_o, table_idx)
    vals = _series(ak, _cos_basis(cos_phi, table.m_cap))
    return torch.where(valid[..., None], _color(table, vals, mu_i), 0.0)


def pdf_fourier(table: FourierTable, wo, wi, table_idx=None):
    """Sampling density of wi."""
    mu_i = -wi[..., 2]
    mu_o = wo[..., 2]
    cos_phi = _cos_dphi(wo, -wi)
    ak, valid, (off_o, w_o, taps_o) = _mix_coefficients(
        table, mu_i, mu_o, table_idx)
    basis = _cos_basis(cos_phi, table.m_cap)
    y = torch.clamp_min(_series(ak, basis)[..., 0], 0.0)
    # rho = sum_o w_o cdf[tap_o, last] 2 pi
    n_mu = table.mu.shape[0]
    tid = _tidx(table, table_idx, mu_i)
    last = table.cdf[:, -1]
    rho = torch.sum(w_o * last[tid[..., None] * n_mu + taps_o],
                    dim=-1) * 2.0 * math.pi
    pdf = torch.where(rho > 0.0, y / torch.where(rho > 0.0, rho, 1.0), 0.0)
    return torch.where(valid, pdf, 0.0)


def _sample_zenith(table: FourierTable, mu_o, v, table_idx=None):
    """Inverse-CDF sample of mu_i from the tabulated marginal of mu_o,
    piecewise linear between grid nodes. Returns (mu_i, pdf_mu)."""
    n_mu = table.mu.shape[0]
    off_o, w_o = spl.catmull_rom_weights(table.mu, mu_o)
    taps_o = spl.catmull_rom_taps(table.mu, off_o)
    tid = _tidx(table, table_idx, mu_o)
    taps_o = tid[..., None] * n_mu + taps_o
    cdf_row = _tap_sum(w_o, table.cdf[taps_o])  # [N, n_mu]
    a0_row = _tap_sum(w_o, table.a0[taps_o])
    total = cdf_row[:, -1]
    target = v * total
    # Segment: the largest i with cdf_row[i] <= target.
    below = (cdf_row <= target[:, None]).to(torch.int64)
    seg = torch.clamp(below.sum(dim=1) - 1, 0, n_mu - 2)

    def take(arr, i):
        return arr.gather(1, i[:, None])[:, 0]

    c0 = take(cdf_row, seg)
    c1 = take(cdf_row, seg + 1)
    f0 = take(a0_row, seg)
    f1 = take(a0_row, seg + 1)
    mu0 = table.mu[seg]
    mu1 = table.mu[seg + 1]
    dc = torch.where(c1 > c0, c1 - c0, 1.0)
    t = torch.clamp((target - c0) / dc, 0.0, 1.0)
    mu_i = mu0 + t * (mu1 - mu0)
    f_mu = f0 + t * (f1 - f0)
    pdf = torch.where(total > 0.0,
                      f_mu / torch.where(total > 0.0, total, 1.0), 0.0)
    return mu_i, torch.clamp_min(pdf, 0.0)


def _sample_azimuth(ak_y, u, m_cap, iters=24):
    """Invert the azimuth CDF F(phi) ~ int sum a_k cos(k phi) by a fixed
    number of Newton-bisection steps. Returns (f(phi), phi, pdf);
    ak_y [N, M]."""
    flip = u >= 0.5
    u = torch.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)
    ks = torch.arange(m_cap, dtype=torch.float32, device=ak_y.device)
    recip = torch.where(ks > 0, 1.0 / torch.where(ks > 0, ks, 1.0), 0.0)
    a0 = ak_y[:, 0]

    def f_and_int(phi):
        kphi = phi[:, None] * ks[None, :]
        f = torch.sum(ak_y * torch.cos(kphi), dim=1)
        integral = a0 * phi + torch.sum(
            ak_y * recip[None, :] * torch.sin(kphi), dim=1)
        return f, integral

    n = ak_y.shape[0]
    left = torch.zeros(n, dtype=torch.float32, device=ak_y.device)
    right = torch.full_like(left, math.pi)
    phi = torch.full_like(left, 0.5 * math.pi)
    for _ in range(iters):
        f, integral = f_and_int(phi)
        err = integral - u * a0 * math.pi
        right = torch.where(err > 0.0, phi, right)
        left = torch.where(err > 0.0, left, phi)
        newton = phi - err / torch.where(f != 0.0, f, 1.0)
        ok = (newton > left) & (newton < right) & (f != 0.0)
        phi = torch.where(ok, newton, 0.5 * (left + right))
    f, _ = f_and_int(phi)
    phi = torch.where(flip, 2.0 * math.pi - phi, phi)
    pdf = torch.where(a0 > 0.0, f / (2.0 * math.pi
                                     * torch.where(a0 > 0, a0, 1.0)), 0.0)
    return f, phi, torch.clamp_min(pdf, 0.0)


def sample_fourier_bsdf(table: FourierTable, wo, u2, table_idx=None):
    """Sample wi: (f [N, 3], wi [N, 3], pdf [N])."""
    u, v = u2[..., 0], u2[..., 1]
    mu_o = wo[..., 2]
    mu_i, pdf_mu = _sample_zenith(table, mu_o, v, table_idx)
    ak, valid, _ = _mix_coefficients(table, mu_i, mu_o, table_idx)
    _, phi, pdf_phi = _sample_azimuth(ak[:, 0, :], u, table.m_cap)
    pdf = torch.clamp_min(pdf_phi * pdf_mu, 0.0)

    sin2_i = torch.clamp_min(1.0 - mu_i * mu_i, 0.0)
    sin2_o = torch.clamp_min(1.0 - mu_o * mu_o, 0.0)
    norm = torch.sqrt(sin2_i / torch.where(sin2_o == 0.0, 1.0, sin2_o))
    norm = torch.where(sin2_o == 0.0, 0.0, norm)
    sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
    wix = norm * (cos_phi * wo[..., 0] - sin_phi * wo[..., 1])
    wiy = norm * (sin_phi * wo[..., 0] + cos_phi * wo[..., 1])
    wi = -torch.stack([wix, wiy, mu_i], dim=-1)
    nlen = torch.sqrt(torch.sum(wi * wi, dim=-1, keepdim=True))
    wi = wi / torch.where(nlen == 0.0, 1.0, nlen)

    vals = _series(ak, _cos_basis(cos_phi, table.m_cap))
    f = torch.where(valid[..., None], _color(table, vals, mu_i), 0.0)
    pdf = torch.where(valid, pdf, 0.0)
    return f, wi, pdf
