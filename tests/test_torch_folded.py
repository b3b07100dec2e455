"""Folded NEE in the port (the BSDF-sampled MIS arm rides the continuation
ray and the next bounce's closest hit resolves it): the general path's
folded loop against pbrs_tpu's render_samples(nee_mode="folded") per lane,
K4-folded's plain version against the interpret-mode
_shade_call(folded=True) on every plane, the folded wave path against the
folded general path per lane with equal ray counts
(tests/test_fused_wave.py:127-172), and the folded image mean against the
two-arm one (tests/test_folded_nee.py:61)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import dispatch as jdispatch
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import render
from pbrs_tpu_torch.accel import dispatch
from pbrs_tpu_torch.accel import fused_wave as fw
from pbrs_tpu_torch.bxdf import lobes as lb
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.integrators import wavefront as twf
from test_folded_nee import _scene as _folded_scene
from test_fused_single_lobe import _shrunk
from test_fused_wave import _center_pix
from test_torch_sobol_kernels import SIZE, compare_planes, record_shade
from test_torch_wave import _carry
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ATOL, RTOL = 3e-5, 2e-4  # tests/test_fused_wave.py:127-146


def _general_folded(jscene, pix, depth, sample=0):
    """pbrs_tpu's and the port's folded general paths on pix: (reference
    radiance, count), (port radiance, count)."""
    tscene = _carry(jscene)
    ji, jo = jdispatch.make_trace_fns(jscene, use_pallas=False)
    ti, to = dispatch.make_trace_fns(tscene, False)
    want, cnt_j = jwf.render_samples(
        jscene, jsmp.PCGSampler(0), jnp.asarray(pix), sample,
        max_depth=depth, msaa=2, intersect_fn=ji, occlude_fn=jo,
        nee_mode="folded", return_ray_count=True)
    got = twf.render_samples(tscene, tsmp.PCGSampler(0),
                             torch.from_numpy(np.array(pix, np.int32)),
                             sample, ti, to, max_depth=depth, msaa=2,
                             nee_mode="folded")
    return (np.asarray(want), int(cnt_j)), got


@pytest.mark.parametrize("case", ["cornell", "env_is"])
def test_general_folded_matches_reference(case):
    """Cornell 20^2 (the center block), depth 4, as
    tests/test_fused_wave.py:148-149; and a 16^2 view of
    tests/test_folded_nee.py's scene (area, sphere and point lights, a
    mirror, an importance-sampled image env), depth 5."""
    if case == "cornell":
        jscene = jpresets.cornell_box()
        pix, depth = np.asarray(_center_pix(jscene, 20)), 4
    else:
        jscene = _shrunk(_folded_scene(), 16)
        pix, depth = np.arange(256), 5
        assert jscene.env.dist is not None
    (want, cnt_j), (got, cnt_t) = _general_folded(jscene, pix, depth)
    assert want.sum() > 0  # non-vacuous: the lanes are lit
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert int(cnt_t) == cnt_j


@pytest.fixture(scope="module")
def zoo_folded():
    """tests/test_folded_nee.py's scene at SIZE^2: every folded leg is live
    (area pendings on the quad and sphere lights, env pendings under
    env-IS, the point light, a mirror)."""
    jscene = _shrunk(_folded_scene(), SIZE)
    tscene = _carry(jscene)
    return (jscene, tscene) + record_shade(tscene, tsmp.PCGSampler(0),
                                           folded=True)


def test_k4_folded_matches_pallas_kernel(zoo_folded):
    """K4-folded's plain version against _shade_call(folded=True) in
    interpret mode on every bounce of the folded wave path: every plane per
    lane."""
    jscene, _, calls, *_ = zoo_folded
    assert all(kw["folded"] and kw["rng"] == "pcg"
               for _, _, _, kw, _ in calls)
    compare_planes(jscene, calls)
    # Cornell's big quad light gives area pendings.
    jcornell = _shrunk(jpresets.cornell_box(), SIZE)
    more = record_shade(_carry(jcornell), tsmp.PCGSampler(0), folded=True)[0]
    compare_planes(jcornell, more)
    # Folded K4 writes no second shadow query: its direction and side stay
    # 0, and s2t (the light's distance) is finite and set on some lane.
    s2 = torch.cat([fout[11:16] for *_, (fout, _) in calls + more], dim=1)
    assert (s2[[0, 1, 2, 4]] == 0).all()
    assert (s2[3] > 0).any() and torch.isfinite(s2[3]).all()


def test_wave_folded_matches_general_folded(zoo_folded):
    """The folded wave path against the port's folded general path per
    lane on the folded scene and on Cornell, with equal ray counts."""
    _, tscene, _, rad, cnt = zoo_folded
    pix = torch.arange(SIZE * SIZE, dtype=torch.int32)
    name, fn = render.make_integrator(tscene, tsmp.PCGSampler(0), 3, 2,
                                      "plain", nee_mode="folded")
    want, cnt_g = fn(pix, 0)
    assert name == "plain_folded" and float(want.sum()) > 0
    np.testing.assert_allclose(rad.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    assert int(cnt) == int(cnt_g)
    cornell = _carry(jpresets.cornell_box())
    pix = torch.tensor(np.asarray(_center_pix(cornell, 16)),
                       dtype=torch.int32)
    _, fn = render.make_integrator(cornell, tsmp.PCGSampler(0), 4, 2,
                                   "plain", nee_mode="folded")
    want, cnt_g = fn(pix, 1)
    got, cnt_w = fw.FusedWaveIntegrator(cornell, folded=True).render_samples(
        tsmp.PCGSampler(0), pix, 1, max_depth=4, msaa=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    assert int(cnt_w) == int(cnt_g)


def test_folded_matches_twoarm_mean():
    """Same expectation as two-arm NEE (tests/test_folded_nee.py:61-73:
    48^2, 24 samples, PCG seed 11, depth 5), on the port's general path,
    the 24 samples in one batch of lanes; with fewer traced segments
    (tests/test_folded_nee.py:97)."""
    scene = _carry(_folded_scene())
    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32).repeat(24)
    sid = torch.arange(24, dtype=torch.int32).repeat_interleave(n)
    means, counts = {}, {}
    # One intra-op thread: beside the other test workers, PyTorch's thread
    # pool on these 55296-lane ops oversubscribes the cores (~100x slower).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for mode in ("twoarm", "folded"):
            _, fn = render.make_integrator(scene, tsmp.PCGSampler(11), 5, 2,
                                           "plain", nee_mode=mode)
            rad, cnt = fn(pix, sid)
            means[mode] = rad.view(24, n, 3).mean(0).numpy()
            counts[mode] = int(cnt)
    finally:
        torch.set_num_threads(threads)
    a, b = means["twoarm"], means["folded"]
    assert np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) < 0.01 * max(a.mean(), 1e-6)
    rel = np.abs((a - b).mean(axis=-1)) / np.maximum(a.mean(axis=-1), 0.05)
    assert np.quantile(rel, 0.99) < 0.5
    assert counts["folded"] < 0.82 * counts["twoarm"]


def test_folded_refusals(zoo_folded):
    """What stays unported: a FOURIER lobe under folded NEE (the JAX
    package's Fourier override is two-arm only), and a folded K2 / K3 --
    route auto then takes K4 folded, or the folded general path."""
    _, tscene, *_ = zoo_folded
    kind = tscene.materials.kind.clone()
    kind[0, 0] = lb.FOURIER
    fourier = tscene.replace(materials=dataclasses.replace(
        tscene.materials, kind=kind))
    assert not fw.scene_supports_wave_folded(fourier)
    with pytest.raises(ValueError, match="Fourier"):
        fw.FusedWaveIntegrator(fourier, folded=True)
    assert fw.scene_supports_wave_folded(tscene)
    with pytest.raises(ValueError, match="nee_mode"):
        render.make_integrator(tscene, tsmp.PCGSampler(0), 2, 1, "plain",
                               nee_mode="onearm")
