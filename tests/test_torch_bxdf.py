"""The port's Fresnel, microfacet, lobe and BSDF modules against pbrs_tpu's
on numpy-seeded directions and parameters."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.bxdf import bsdf as jbsdf
from pbrs_tpu.bxdf import fresnel as jfr
from pbrs_tpu.bxdf import lobes as jlb
from pbrs_tpu.bxdf import microfacet as jmf
from pbrs_tpu_torch.bxdf import bsdf as tbsdf
from pbrs_tpu_torch.bxdf import fresnel as tfr
from pbrs_tpu_torch.bxdf import lobes as tlb
from pbrs_tpu_torch.bxdf import microfacet as tmf

N = 512
# Elementwise float32 formulas on both sides; XLA's CPU transcendentals
# (exp, log, tan, atan) and PyTorch's round apart by a few ulps.
ATOL, RTOL = 1e-6, 1e-5


def _dirs(rng, n=N, upper=False):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if upper:
        d[:, 2] = np.abs(d[:, 2])
    return d


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.asarray(a)) for a in arrays])


def test_fresnel_models():
    rng = np.random.default_rng(0)
    cos = rng.uniform(-1.2, 1.2, N).astype(np.float32)
    e0 = rng.uniform(1.0, 1.6, N).astype(np.float32)
    e1 = rng.uniform(1.0, 2.4, N).astype(np.float32)
    eta = rng.uniform(0.1, 3.0, (N, 3)).astype(np.float32)
    k = rng.uniform(0.0, 5.0, (N, 3)).astype(np.float32)
    kind = rng.integers(0, 3, N).astype(np.int32)
    (jc, je0, je1, jeta, jk, jkind), (tc, te0, te1, teta, tk_, tkind) = \
        _both(cos, e0, e1, eta, k, kind)
    _close(tfr.dielectric_refl(tc, te0, te1), jfr.dielectric_refl(jc, je0, je1))
    _close(tfr.conductor_refl(tc, teta, tk_), jfr.conductor_refl(jc, jeta, jk))
    _close(tfr.eval_color(tkind, tc, te0, te1, teta, tk_),
           jfr.eval_color(jkind, jc, je0, je1, jeta, jk))


@pytest.mark.parametrize("distrib", [jmf.BECKMANN, jmf.TROWBRIDGE_REITZ])
@pytest.mark.parametrize("aniso", [False, True])
def test_microfacet_distribution(distrib, aniso):
    rng = np.random.default_rng(1 + distrib + 2 * aniso)
    ax = rng.uniform(0.02, 0.8, N).astype(np.float32)
    ay = rng.uniform(0.02, 0.8, N).astype(np.float32) if aniso else ax
    wo, wh = _dirs(rng, upper=True), _dirs(rng)
    u2 = rng.random((N, 2)).astype(np.float32)
    dist = np.full(N, distrib, np.int32)
    (jd, jax_, jay, jwo, jwh, ju), (td, tax, tay, two, twh, tu) = _both(
        dist, ax, ay, wo, wh, u2)
    _close(tmf.d(td, tax, tay, twh), jmf.d(jd, jax_, jay, jwh), rtol=1e-4)
    _close(tmf._lambda(td, tax, tay, twh), jmf._lambda(jd, jax_, jay, jwh))
    _close(tmf.g1(td, tax, tay, twh), jmf.g1(jd, jax_, jay, jwh))
    _close(tmf.g(td, tax, tay, two, twh), jmf.g(jd, jax_, jay, jwo, jwh))
    _close(tmf.pdf_wh(td, tax, tay, two, twh),
           jmf.pdf_wh(jd, jax_, jay, jwo, jwh), rtol=1e-4)
    _close(tmf.sample_wh(td, tax, tay, two, tu),
           jmf.sample_wh(jd, jax_, jay, jwo, ju), atol=1e-5)


def test_roughness_to_alpha():
    r = np.random.default_rng(2).uniform(1e-5, 1.0, N).astype(np.float32)
    _close(tmf.roughness_to_alpha(torch.from_numpy(r)),
           jmf.roughness_to_alpha(jnp.asarray(r)))


def _lobes(rng, kinds, n=N, slots=1):
    """Random lobe tables for both packages: kind [n, slots] drawn from
    `kinds`, random parameters."""
    shape = (n, slots)
    f = {
        "kind": rng.choice(kinds, shape).astype(np.int32),
        "albedo": rng.uniform(0.1, 0.9, shape + (3,)).astype(np.float32),
        "specular": np.zeros(shape + (3,), np.float32),
        "alpha": np.repeat(rng.uniform(0.05, 0.6, shape + (1,)), 2,
                           -1).astype(np.float32),
        "distrib": rng.integers(0, 2, shape).astype(np.int32),
        "fr_kind": rng.integers(0, 3, shape).astype(np.int32),
        "eta": np.stack([np.ones(shape), rng.uniform(1.2, 2.0, shape)],
                        -1).astype(np.float32),
        "eta_t": rng.uniform(0.1, 3.0, shape + (3,)).astype(np.float32),
        "k": rng.uniform(0.0, 5.0, shape + (3,)).astype(np.float32),
    }
    # FresnelBlend reads Rs; Oren-Nayar reads (A, B) from alpha.
    f["specular"] = rng.uniform(0.0, 0.6, shape + (3,)).astype(np.float32)
    f["alpha"][..., 1] = np.where(f["kind"] == jlb.OREN_NAYAR,
                                  rng.uniform(0.0, 0.4, shape),
                                  f["alpha"][..., 0])
    present = tuple(sorted(set(kinds) - {0}))
    jl = jlb.Lobes(**{k: jnp.asarray(v) for k, v in f.items()},
                   present_kinds=present)
    tl = tlb.Lobes(**{k: torch.from_numpy(v) for k, v in f.items()},
                   present_kinds=present)
    return jl, tl


KINDS = {"lambert": jlb.LAMBERT, "microfacet": jlb.MICROFACET,
         "mirror": jlb.SPEC_MIRROR, "dielectric": jlb.SPEC_DIELECTRIC,
         "transmit": jlb.SPEC_TRANSMIT, "oren_nayar": jlb.OREN_NAYAR,
         "fresnel_blend": jlb.FRESNEL_BLEND}


@pytest.mark.parametrize("name", sorted(KINDS))
def test_lobe_eval_pdf_sample(name):
    rng = np.random.default_rng(10 + KINDS[name])
    jl, tl = _lobes(rng, [KINDS[name], 0])
    jl1, tl1 = jlb.slot(jl, 0), tlb.slot(tl, 0)
    wo, wi = _dirs(rng), _dirs(rng)
    u2 = rng.random((N, 2)).astype(np.float32)
    (jwo, jwi, ju), (two, twi, tu) = _both(wo, wi, u2)
    _close(tlb.eval_lobe(tl1, two, twi), jlb.eval_lobe(jl1, jwo, jwi),
           rtol=1e-4)
    _close(tlb.pdf_lobe(tl1, two, twi), jlb.pdf_lobe(jl1, jwo, jwi),
           rtol=1e-4)
    got = tlb.sample_lobe(tl1, two, tu)
    want = jlb.sample_lobe(jl1, jwo, ju)
    for g, w in zip(got, want):
        _close(g, w, atol=2e-5, rtol=2e-4)


def test_bsdf_mixture_and_specular():
    """Two-slot mixtures of every ported kind through the world-frame BSDF:
    eval, pdf, sample and sample_specular."""
    rng = np.random.default_rng(20)
    jl, tl = _lobes(rng, list(KINDS.values()) + [0], slots=2)
    n_, t_ = _dirs(rng), _dirs(rng)
    wo, wi = _dirs(rng), _dirs(rng)
    u2 = rng.random((N, 2)).astype(np.float32)
    (jn, jt, jwo, jwi, ju), (tn, tt, two, twi, tu) = _both(n_, t_, wo, wi, u2)
    jf, tf = jbsdf.make_frame(jn, jt), tbsdf.make_frame(tn, tt)
    _close(tbsdf.eval_bsdf(tl, tf, two, twi), jbsdf.eval_bsdf(jl, jf, jwo, jwi),
           rtol=1e-4)
    _close(tbsdf.pdf_bsdf(tl, tf, two, twi), jbsdf.pdf_bsdf(jl, jf, jwo, jwi),
           rtol=1e-4)
    for got, want in ((tbsdf.sample_bsdf(tl, tf, two, tu),
                       jbsdf.sample_bsdf(jl, jf, jwo, ju)),
                      (tbsdf.sample_specular(tl, tf, two),
                       jbsdf.sample_specular(jl, jf, jwo))):
        for g, w in zip(got, want):
            _close(g, w, atol=2e-5, rtol=2e-4)


def test_matte_and_substrate_rows_match_reference():
    """add_matte(sigma > 0) builds Oren-Nayar's (A, B), add_substrate a
    Trowbridge-Reitz FresnelBlend, row for row as pbrs_tpu's builder."""
    from pbrs_tpu.materials import table as jmt
    from pbrs_tpu_torch.materials import table as tmt

    tables = []
    for mod in (jmt, tmt):
        b = mod.MaterialBuilder()
        b.add_matte((0.6, 0.5, 0.4), sigma_deg=20.0)
        b.add_matte((0.2, 0.3, 0.4), sigma_deg=0.0)
        b.add_substrate((0.5, 0.3, 0.2), (0.3, 0.3, 0.3), 0.08,
                        remap_roughness=False, kd_tex=2)
        tables.append(b.build())
    jt, tt = tables
    for name in ("kind", "albedo", "specular", "alpha", "distrib", "fr_kind",
                 "eta", "eta_t", "k", "tex_id", "emission"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    assert tt.present_kinds == jt.present_kinds
    assert tt.textured_slots == jt.textured_slots


def test_unported_kinds_raise():
    rng = np.random.default_rng(3)
    _, tl = _lobes(rng, [jlb.FOURIER])
    with pytest.raises(NotImplementedError, match="not ported"):
        tlb.eval_lobe(tlb.slot(tl, 0), torch.zeros(N, 3), torch.zeros(N, 3))
