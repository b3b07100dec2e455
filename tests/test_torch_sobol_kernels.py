"""K3's and K4's plain versions drawing Owen-scrambled Sobol' against
pbrs_tpu's Pallas kernels in interpret mode (_bounce2_kernel and
_shade_call with rng="sobol"), and the port's wave path under Sobol'
against its general path per lane."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import fused_single_lobe as jfsl
from pbrs_tpu.accel import fused_wave as jfw
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu_torch import render
from pbrs_tpu_torch.accel import fused_single_lobe as fsl
from pbrs_tpu_torch.accel import fused_wave as fw
from pbrs_tpu_torch.core import sampler as tsmp
from test_fused_single_lobe import _shrunk
from test_fused_single_lobe import _zoo_scene as _single_lobe_zoo
from test_fused_wave import _zoo_scene
from test_torch_single_lobe import carried
from test_torch_wave import _carry, _pallas_planes, assert_planes_match
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ATOL, RTOL = 3e-5, 2e-4  # tests/test_fused_single_lobe.py:272, test_fused_wave.py:212
SIZE, DEPTH = 16, 3


def test_k3_sobol_matches_pallas_kernel():
    """K3's plain version vs _bounce2_kernel(rng="sobol") in interpret mode
    through both integrators: the single-lobe zoo at 16^2, depth 3."""
    jscene = _shrunk(_single_lobe_zoo(), SIZE)
    n = SIZE * SIZE
    want, cnt_j = jfsl.FusedSingleLobeIntegrator(jscene, interpret=True) \
        .render_samples(jsmp.SobolSampler(3), jnp.arange(n), 0,
                        max_depth=DEPTH, msaa=2, return_ray_count=True)
    got, cnt_t = fsl.FusedSingleLobeIntegrator(carried(jscene)) \
        .render_samples(tsmp.SobolSampler(3),
                        torch.arange(n, dtype=torch.int32), 0,
                        max_depth=DEPTH, msaa=2)
    want = np.asarray(want)
    assert want.sum() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert int(cnt_t) == pytest.approx(float(cnt_j), rel=1e-6)


def record_shade(tscene, sampler, folded=False):
    """Every K4 call of the port's wave path on sample 0 with its outputs,
    and the path's radiance and ray count."""
    calls = []
    shade = fw.shade

    def record(tab, fin, iin, count, **kw):
        out = shade(tab, fin, iin, count, **kw)
        calls.append((tab, fin, iin, kw, out))
        return out

    fw.shade = record
    try:
        rad, cnt = fw.FusedWaveIntegrator(tscene, folded=folded) \
            .render_samples(sampler, torch.arange(SIZE * SIZE,
                                                  dtype=torch.int32), 0,
                            max_depth=DEPTH, msaa=2)
    finally:
        fw.shade = shade
    return calls, rad, cnt


def compare_planes(jscene, calls):
    """shade_reference against _shade_call(interpret=True) on every
    recorded call (test_torch_wave.assert_planes_match): all 30 float and 2
    int planes of every lane that enters alive at ATOL / RTOL, where only a
    side plane whose direction lies in the surface's plane to rounding
    (|d . n| <= 1e-5 |d|) may differ (ROADMAP Queue 3); the lanes that
    enter dead pass through on their own."""
    integ = jfw.FusedWaveIntegrator(jscene, interpret=True, use_pallas=False)
    n = SIZE * SIZE
    for tab, fin, iin, kw, (fout, iout) in calls:
        ints = jnp.asarray([kw["seed"], kw["bounce"], int(kw["first"]),
                            int(kw["rr_on"])], jnp.int32)
        out = jfw._shade_call(
            integ.mats, integ.mats_splits, integ.lights, integ.delta, ints,
            jnp.asarray([integ.world_radius], jnp.float32),
            _pallas_planes(tab, fin, iin, 64), n_mats=integ.n_mats,
            n_area=integ.n_area, n_delta=integ.n_delta,
            present_kinds=integ.present_kinds,
            light_shapes=integ.light_shapes, n_slots=integ.n_slots,
            textured_slots=integ.textured_slots, has_env=integ.has_env,
            env_is=integ.env_is, folded=kw["folded"], interpret=True,
            rng=kw["rng"])
        want = np.stack([np.asarray(o).reshape(-1)[:n] for o in out])
        assert_planes_match(fin, iin, fout, iout, want)


@pytest.fixture(scope="module")
def zoo_sobol():
    jscene = _shrunk(_zoo_scene(), SIZE)
    tscene = _carry(jscene)
    return (jscene, tscene) + record_shade(tscene, tsmp.SobolSampler(3))


def test_k4_sobol_matches_pallas_kernel(zoo_sobol):
    jscene, _, calls, *_ = zoo_sobol
    assert len(calls) == DEPTH
    assert all(kw["rng"] == "sobol" and not kw["folded"]
               for _, _, _, kw, _ in calls)
    compare_planes(jscene, calls)


def test_wave_sobol_matches_general_path(zoo_sobol):
    """The wave path under Sobol' against the port's general path under
    Sobol', per lane, with equal ray counts."""
    _, tscene, _, rad, cnt = zoo_sobol
    _, fn = render.make_integrator(tscene, tsmp.SobolSampler(3), DEPTH, 2,
                                   "plain")
    want, cnt_g = fn(torch.arange(SIZE * SIZE, dtype=torch.int32), 0)
    assert float(want.sum()) > 0
    np.testing.assert_allclose(rad.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    assert int(cnt) == int(cnt_g)


def test_single_lobe_sobol_matches_general_path():
    """K3's integrator under Sobol' against the port's general path under
    Sobol' on the single-lobe zoo."""
    tscene = carried(_shrunk(_single_lobe_zoo(), SIZE))
    pix = torch.arange(SIZE * SIZE, dtype=torch.int32)
    got, cnt = fsl.FusedSingleLobeIntegrator(tscene).render_samples(
        tsmp.SobolSampler(5), pix, 1, max_depth=DEPTH, msaa=2)
    _, fn = render.make_integrator(tscene, tsmp.SobolSampler(5), DEPTH, 2,
                                   "plain")
    want, cnt_g = fn(pix, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    assert int(cnt) == int(cnt_g)
