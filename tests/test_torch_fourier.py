"""The Fourier measured BSDF in the port: ``bxdf/fourier.py`` and the
Catmull-Rom weights of ``core/spline.py`` against pbrs_tpu's on seeded
inputs (a Lambert table, a two-table stack with per-lane table ids, an
order-12 synthetic table), the SCATFUN reader, the FOURIER lobe, the
fourier_plastic tables, the general path on a 16x16 crop of
fourier_plastic per lane against pbrs_tpu's run op by op (two-arm and
folded), the wave route's Fourier override against the general path
(tests/test_fused_wave.py:218), and checks of the sampler that parity cannot make: the pdf integrates to 1
and the azimuth draws follow the pdf they return, on a table with M > 1.
"""

import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import dispatch as jdispatch
from pbrs_tpu.bxdf import fourier as jfb
from pbrs_tpu.bxdf import lobes as jlb
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.core import spline as jspl
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch.accel import dispatch
from pbrs_tpu_torch.accel import fused_wave as fw
from pbrs_tpu_torch.bxdf import fourier as tfb
from pbrs_tpu_torch.bxdf import lobes as tlb
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.core import spline as tspl
from pbrs_tpu_torch.integrators import wavefront as twf
from pbrs_tpu_torch.scene import buffers, presets
from test_fused_wave import _center_pix
from test_torch_single_lobe import ALPHA_RTOL
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ATOL, RTOL = 2e-5, 1e-4
N = 512
M_HIGH = 12  # coefficient order of the synthetic high-order table


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def high_order_args(n_mu=16, m=M_HIGH, r=0.55, albedo=0.7):
    """build_table arguments of a reflection table whose azimuth profile
    is a Poisson kernel a0 (1 + 2 sum_k r^k cos k phi) (positive, order m)
    and whose zenith part is Lambert-like with a mu_o tilt."""
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    a0 = np.zeros((n_mu, n_mu), np.float32)
    for o in range(n_mu):
        for i in range(n_mu):
            if mu[o] > 0 and mu[i] < 0:
                a0[o, i] = (albedo / np.pi * abs(mu[i])
                            * (0.6 + 0.4 * mu[o] * abs(mu[i])))
    cdf = np.zeros((n_mu, n_mu), np.float32)
    for o in range(n_mu):
        acc = 0.0
        for i in range(1, n_mu):
            acc += 0.5 * (a0[o, i] + a0[o, i - 1]) * (mu[i] - mu[i - 1])
            cdf[o, i] = acc
    series = np.concatenate([[1.0], 2.0 * r ** np.arange(1, m)])
    m_lookup = np.where(a0 > 0, m, 0).reshape(-1)
    coeffs, offsets = [], []
    for idx, a in enumerate(a0.reshape(-1)):
        offsets.append(len(coeffs))
        if a > 0:
            y = a * series
            coeffs.extend(np.concatenate([y, 0.9 * y, 1.1 * y]).tolist())
    return (3, mu, cdf, np.asarray(offsets), m_lookup,
            np.asarray(coeffs, np.float32))


def tables(name):
    """(pbrs_tpu table, port table, table ids or None)."""
    if name == "lambert":
        return jfb.make_lambert_table(0.6, 32), tfb.make_lambert_table(
            0.6, 32), None
    if name == "concat":
        j = jfb.concat_tables([jfb.make_lambert_table(0.2, 32),
                               jfb.make_lambert_table(0.8, 32)])
        t = tfb.concat_tables([tfb.make_lambert_table(0.2, 32),
                               tfb.make_lambert_table(0.8, 32)])
        ids = np.random.default_rng(5).integers(0, 2, N).astype(np.int32)
        return j, t, ids
    args = high_order_args()
    return jfb.build_table(*args), tfb.build_table(*args), None


def _dirs(rng, n, up=True):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.05 if up else d[:, 2]
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_catmull_rom_matches_reference():
    grid = np.linspace(-1.0, 1.0, 16).astype(np.float32)
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 4096).astype(np.float32)
    x[:4] = grid[[0, 1, 7, 15]]  # exactly on nodes, both ends
    jo, jw = jspl.catmull_rom_weights(jnp.asarray(grid), jnp.asarray(x))
    to, tw = tspl.catmull_rom_weights(torch.from_numpy(grid),
                                      torch.from_numpy(x))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    _close(tw, jw)
    np.testing.assert_array_equal(
        tspl.catmull_rom_taps(torch.from_numpy(grid), to).numpy(),
        np.asarray(jspl.catmull_rom_taps(jnp.asarray(grid), jo)))


@pytest.mark.parametrize("name", ["lambert", "concat", "high_order"])
def test_tables_match_reference(name):
    j, t, _ = tables(name)
    for f in ("mu", "cdf", "a0", "a_dense", "m_lookup"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)
    for f in ("eta", "n_channels", "m_cap", "n_tables"):
        assert getattr(t, f) == getattr(j, f), f
    if name == "high_order":
        assert t.m_cap == M_HIGH


@pytest.mark.parametrize("name", ["lambert", "concat", "high_order"])
def test_eval_pdf_sample_match_reference(name):
    j, t, ids = tables(name)
    rng = np.random.default_rng(1)
    wo = _dirs(rng, N)
    wi = _dirs(rng, N)
    wi[: N // 4, 2] *= -1.0  # some transmission-side directions
    u2 = rng.random((N, 2), dtype=np.float32)
    jid = None if ids is None else jnp.asarray(ids)
    tid = None if ids is None else torch.from_numpy(ids)
    T = torch.from_numpy
    _close(tfb.eval_fourier(t, T(wo), T(wi), tid),
           jfb.eval_fourier(j, jnp.asarray(wo), jnp.asarray(wi), jid))
    _close(tfb.pdf_fourier(t, T(wo), T(wi), tid),
           jfb.pdf_fourier(j, jnp.asarray(wo), jnp.asarray(wi), jid))
    got = tfb.sample_fourier_bsdf(t, T(wo), T(u2), tid)
    want = jfb.sample_fourier_bsdf(j, jnp.asarray(wo), jnp.asarray(u2), jid)
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[2].min()) >= 0.0 and float(got[2].max()) > 0.0


def test_fourier_lobe_matches_reference():
    """The FOURIER kind through eval_lobe / pdf_lobe / sample_lobe, the
    table index riding in alpha[..., 0], beside a Lambert slot."""
    jt = jfb.concat_tables([jfb.make_lambert_table(0.3, 32),
                            jfb.make_lambert_table(0.9, 32)])
    tt = tfb.concat_tables([tfb.make_lambert_table(0.3, 32),
                            tfb.make_lambert_table(0.9, 32)])
    rng = np.random.default_rng(2)
    kind = rng.choice([tlb.LAMBERT, tlb.FOURIER], N).astype(np.int32)
    alb = rng.random((N, 3), dtype=np.float32)
    alpha = np.stack([rng.integers(0, 2, N), np.zeros(N)], 1).astype(
        np.float32)
    zeros2 = np.zeros((N, 2), np.float32)
    fields = dict(kind=kind, albedo=alb, specular=alb, alpha=alpha,
                  distrib=np.zeros(N, np.int32), fr_kind=np.zeros(N, np.int32),
                  eta=zeros2 + 1.0, eta_t=alb, k=alb)
    kinds = (tlb.LAMBERT, tlb.FOURIER)
    jl = jlb.Lobes(**{k: jnp.asarray(v) for k, v in fields.items()},
                   fourier=jt, present_kinds=kinds)
    tl = tlb.Lobes(**{k: torch.from_numpy(v) for k, v in fields.items()},
                   fourier=tt, present_kinds=kinds)
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    u2 = rng.random((N, 2), dtype=np.float32)
    T, J = torch.from_numpy, jnp.asarray
    _close(tlb.eval_lobe(tl, T(wo), T(wi)), jlb.eval_lobe(jl, J(wo), J(wi)))
    _close(tlb.pdf_lobe(tl, T(wo), T(wi)), jlb.pdf_lobe(jl, J(wo), J(wi)))
    got = tlb.sample_lobe(tl, T(wo), T(u2))
    want = jlb.sample_lobe(jl, J(wo), J(u2))
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _write_scatfun(path, table):
    """A SCATFUN file holding `table`'s runs (its m_lookup per entry)."""
    n_mu = table.mu.shape[0]
    m_lookup = table.m_lookup.numpy().reshape(-1)
    a_dense = table.a_dense.numpy()
    coeffs, offsets = [], []
    for idx in range(n_mu * n_mu):
        offsets.append(len(coeffs))
        m = int(m_lookup[idx])
        for c in range(3):
            coeffs.extend(a_dense[idx, c, :m].tolist())
    header = b"SCATFUN" + struct.pack("<B", 1)
    header += struct.pack("<Iiiiii", 1, n_mu, len(coeffs), table.m_cap, 3, 1)
    header += struct.pack("<iiifffff", 0, 0, 0, 1.33, 0.1, 0.1, 0, 0)
    assert len(header) == 64
    ol = np.zeros(n_mu * n_mu * 2, "<i4")
    ol[0::2] = offsets
    ol[1::2] = m_lookup
    with open(path, "wb") as f:
        f.write(header)
        f.write(table.mu.numpy().astype("<f4").tobytes())
        f.write(table.cdf.numpy().astype("<f4").tobytes())
        f.write(ol.tobytes())
        f.write(np.asarray(coeffs, "<f4").tobytes())


def test_scatfun_round_trip(tmp_path):
    """Write the order-12 table, read it back with the port and with
    pbrs_tpu: the same table, array for array."""
    table = tfb.build_table(*high_order_args())
    path = str(tmp_path / "high.bsdf")
    _write_scatfun(path, table)
    got = tfb.load_scatfun(path)
    want = jfb.load_scatfun(path)
    assert got.eta == want.eta == pytest.approx(1.33)
    for f in ("mu", "cdf", "a0", "a_dense", "m_lookup"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(table, f).numpy(), f)
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.m_cap == want.m_cap == M_HIGH


def test_pbrt_fourier_material(tmp_path):
    """A PBRT ``fourier`` material with a bsdffile loads into the same
    tables as pbrs_tpu's loader builds."""
    from pbrs_tpu.scene.pbrt import loader as jloader
    from pbrs_tpu_torch.scene.pbrt import loader as tloader

    _write_scatfun(str(tmp_path / "m.bsdf"), tfb.make_lambert_table(0.5, 8))
    (tmp_path / "s.pbrt").write_text(
        'Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
        'Camera "perspective" "float fov" [40]\nWorldBegin\n'
        'Material "fourier" "string bsdffile" "m.bsdf"\n'
        'Shape "sphere" "float radius" 1\nWorldEnd\n')
    tscene = tloader.build_scene(str(tmp_path / "s.pbrt"))
    jscene = jloader.build_scene(str(tmp_path / "s.pbrt"))
    assert tlb.FOURIER in tscene.materials.present_kinds
    got = buffers.scene_to_arrays(tscene)
    want = buffers.scene_to_arrays(jscene)
    for key in (k for k in want if k.startswith("materials.")):
        np.testing.assert_array_equal(got[key], want[key], key)


@pytest.fixture(scope="module")
def plastic():
    """(pbrs_tpu's fourier_plastic, the port's carried copy)."""
    jscene = jpresets.fourier_plastic()
    return jscene, buffers.scene_from_arrays(buffers.scene_to_arrays(jscene))


def test_fourier_plastic_tables(plastic):
    """The port's preset equals pbrs_tpu's array for array (the plastic's
    alpha to one ulp: roughness_to_alpha rounds apart), and the carried
    copy keeps the Fourier table."""
    jscene, carried = plastic
    want = buffers.scene_to_arrays(jscene)
    for scene in (presets.fourier_plastic(), carried):
        got = buffers.scene_to_arrays(scene)
        assert set(got) == set(want)
        for key in want:
            if key == "materials.alpha":
                np.testing.assert_allclose(got[key], want[key],
                                           rtol=ALPHA_RTOL, atol=0)
            else:
                np.testing.assert_array_equal(got[key], want[key], key)
    assert carried.materials.fourier.n_tables == 3
    assert carried.materials.present_kinds == jscene.materials.present_kinds


@pytest.mark.parametrize("nee_mode", ["twoarm", "folded"])
def test_general_path_matches_reference(plastic, nee_mode):
    """A 16x16 crop at the image center, depth 3, sample 1: every lane and
    the traced rays against pbrs_tpu's general path run op by op. (Under
    jit XLA contracts 1 - mu_o^2 in sample_fourier_bsdf, and the frame
    change before it, into fused multiply-adds; on a lane whose wo is
    within sin^2 theta_o < 2e-4 of the normal that cancels, and the
    compiled run parts from its own op-by-op run by up to 5e-4 relative.
    ROADMAP.md, Queue 3.)"""
    jscene, tscene = plastic
    pix = np.asarray(_center_pix(jscene, 16))
    ji, jo = jdispatch.make_trace_fns(jscene, use_pallas=False)
    ti, to = dispatch.make_trace_fns(tscene, False)
    with jax.disable_jit():
        want, cnt_j = jwf.render_samples(
            jscene, jsmp.PCGSampler(0), jnp.asarray(pix), 1, max_depth=3,
            msaa=2, intersect_fn=ji, occlude_fn=jo, nee_mode=nee_mode,
            return_ray_count=True)
    got, cnt_t = twf.render_samples(
        tscene, tsmp.PCGSampler(0), torch.from_numpy(pix.astype(np.int32)),
        1, ti, to, max_depth=3, msaa=2, nee_mode=nee_mode)
    assert np.asarray(want).sum() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert int(cnt_t) == int(cnt_j)


def test_wave_override_matches_general_path(plastic):
    """The wave route with the Fourier override (K4's plain version for the
    other lanes) against the port's general path, per lane and in traced
    rays (tests/test_fused_wave.py:218: 16x16 center block, depth 3)."""
    _, tscene = plastic
    assert fw.scene_supports_wave(tscene)
    assert not fw.scene_supports_wave_folded(tscene)
    pix = torch.from_numpy(np.asarray(_center_pix(tscene, 16), np.int32))
    sampler = tsmp.PCGSampler(0)
    integ = fw.FusedWaveIntegrator(tscene)
    assert integ.has_fourier
    got, cnt_w = integ.render_samples(sampler, pix, 0, max_depth=3)
    ti, to = dispatch.make_trace_fns(tscene, True)
    want, cnt_g = twf.render_samples(tscene, sampler, pix, 0, ti, to,
                                     max_depth=3)
    assert want.sum() > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5,
                               rtol=2e-4)
    assert int(cnt_w) == int(cnt_g)


def test_folded_wave_refuses_fourier(plastic):
    with pytest.raises(ValueError, match="Fourier"):
        fw.FusedWaveIntegrator(plastic[1], folded=True)


# --------------------- checks parity cannot make ----------------------------


def _hemisphere_grid(n_theta=64, n_phi=128):
    t = (np.arange(n_theta) + 0.5) * (np.pi / 2) / n_theta
    p = (np.arange(n_phi) + 0.5) * 2 * np.pi / n_phi
    t, p = np.meshgrid(t, p, indexing="ij")
    dirs = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                     np.cos(t)], -1).reshape(-1, 3).astype(np.float32)
    dw = (np.sin(t) * (np.pi / 2 / n_theta) * (2 * np.pi / n_phi)).reshape(-1)
    return dirs, dw


@pytest.mark.parametrize("mu_o", [0.35, 0.8])
def test_high_order_pdf_integrates_to_one(mu_o):
    """The order-12 table's pdf over the reflection hemisphere integrates
    to 1 (up to the trapezoid CDF against the Catmull-Rom mix)."""
    table = tfb.build_table(*high_order_args())
    dirs, dw = _hemisphere_grid()
    s = np.sqrt(1.0 - mu_o * mu_o)
    wo = torch.tensor([[s * 0.6, s * 0.8, mu_o]]).expand(dirs.shape[0], 3)
    pdf = tfb.pdf_fourier(table, wo, torch.from_numpy(dirs)).numpy()
    assert abs(float((pdf * dw).sum()) - 1.0) < 0.05


def test_high_order_azimuth_draws_follow_their_pdf():
    """_sample_azimuth's Newton-bisection with M = 12: the drawn phi follow
    the pdf it returns (a Poisson kernel), bin by bin, and the returned pdf
    is f(phi) / (2 pi a0) at the drawn phi."""
    n, bins, r = 1 << 16, 32, 0.55
    series = np.concatenate([[1.0], 2.0 * r ** np.arange(1, M_HIGH)])
    ak = torch.from_numpy(np.tile(0.2 * series, (n, 1)).astype(np.float32))
    u = torch.from_numpy(
        np.random.default_rng(4).random(n, dtype=np.float32))
    f, phi, pdf = tfb._sample_azimuth(ak, u, M_HIGH)
    phi, pdf = phi.numpy().astype(np.float64), pdf.numpy()
    assert phi.min() >= 0.0 and phi.max() <= 2 * np.pi

    def density(x):
        k = np.arange(M_HIGH)
        return (series[None, :] * np.cos(np.outer(x, k))).sum(1) / (2 * np.pi)

    np.testing.assert_allclose(pdf, density(phi), rtol=1e-4, atol=1e-5)
    edges = np.linspace(0.0, 2 * np.pi, bins + 1)
    fine = np.linspace(0.0, 2 * np.pi, bins * 64 + 1)
    mid = 0.5 * (fine[1:] + fine[:-1])
    mass = (density(mid) * np.diff(fine)).reshape(bins, 64).sum(1)
    counts = np.histogram(phi, edges)[0]
    expect = n * mass
    assert np.all(np.abs(counts - expect) < 5.0 * np.sqrt(expect) + 1.0), (
        counts, expect.round())


def zenith_pdf_gap(mu_o=0.6, n=1 << 16, bins=64):
    """How far the zenith draws' density sits from the pdf_mu they return
    (the piecewise-linear inversion), on the order-12 table: the largest
    relative gap over the histogram bins that hold draws."""
    table = tfb.build_table(*high_order_args())
    v = torch.from_numpy(np.random.default_rng(6).random(n, dtype=np.float32))
    mu_i, pdf_mu = tfb._sample_zenith(table, torch.full((n,), mu_o), v)
    mu_i, pdf_mu = mu_i.numpy(), pdf_mu.numpy()
    edges = np.linspace(-1.0, 0.0, bins + 1)
    counts = np.histogram(mu_i, edges)[0]
    which = np.clip(np.digitize(mu_i, edges) - 1, 0, bins - 1)
    mean_pdf = np.bincount(which, pdf_mu, bins) / np.maximum(counts, 1)
    seen = counts > 0
    hist = counts / (n * np.diff(edges))
    return float(np.max(np.abs(hist[seen] - mean_pdf[seen])
                        / mean_pdf[seen])), mu_i, pdf_mu


def test_zenith_draws_and_their_pdf():
    """The zenith draws stay on the grid and return a finite pdf; the gap
    between their density and that pdf is measured, not bounded
    (ROADMAP.md, Queue 3)."""
    gap, mu_i, pdf_mu = zenith_pdf_gap()
    assert mu_i.min() >= -1.0 and mu_i.max() <= 1.0
    assert np.all(np.isfinite(pdf_mu)) and pdf_mu.min() >= 0.0
    assert (mu_i < 0.0).mean() > 0.99
    assert np.isfinite(gap)
    print(f"zenith density vs returned pdf: largest relative gap {gap:.4f}")
