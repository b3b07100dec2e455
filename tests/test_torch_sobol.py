"""The port's Sobol' and threefry samplers against pbrs_tpu's, bit for bit:
the u1/u2 streams, the in-kernel draw of the fused kernels (the plain
versions' fused_kernel._u1, as tests/test_fused.py:82-99 checks it), K2's
plain version under Sobol' against the interpret-mode Pallas
_bounce_kernel, and the port's general path under Sobol' against
pbrs_tpu's per lane."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import fused_kernel as jfk
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.geometry import camera as jcam
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import render
from pbrs_tpu_torch.accel import fused_kernel as tfk
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.geometry import camera as tcam
from pbrs_tpu_torch.scene import presets
from test_torch_fused import ATOL, RTOL, VIEW
from test_torch_sampler import SEEDS, _counters, _j, _t


@pytest.mark.parametrize("seed", SEEDS)
def test_sobol_u1_u2_bit_identical(seed):
    pix = _counters(seed + 30)
    js, ts = jsmp.SobolSampler(seed), tsmp.SobolSampler(seed)
    big = _counters(seed + 31)  # per-lane sample ids, a quarter >= 2^31
    for s_t, s_j in ((0, 0), (5, 5), (_t(big), _j(big))):
        for bounce, dim in ((0, jsmp.DIM_CAMERA_JITTER),
                            (3, jsmp.DIM_BSDF_UV),
                            (7, jsmp.DIM_RUSSIAN_ROULETTE)):
            np.testing.assert_array_equal(
                ts.u2(_t(pix), s_t, bounce, dim).numpy(),
                np.asarray(js.u2(_j(pix), s_j, bounce, dim)))
            # u1 keys the hashes with `lane` (SobolSampler.u1's quirk).
            np.testing.assert_array_equal(
                ts.u1(_t(pix), s_t, bounce, dim, lane=1).numpy(),
                np.asarray(js.u1(_j(pix), s_j, bounce, dim, lane=1)))


def test_sobol_building_blocks_bit_identical():
    x = _counters(40)
    key = _counters(41)
    np.testing.assert_array_equal(
        tsmp.nested_uniform_scramble(_t(x), _t(key)).numpy(),
        np.asarray(jsmp.nested_uniform_scramble(_j(x), _j(key))))
    for dim in (0, 1):
        np.testing.assert_array_equal(
            tsmp.sobol_u32(_t(x), dim).numpy(),
            np.asarray(jsmp.sobol_u32(_j(x), dim)))
    assert tsmp._SOBOL_DIM1 == jsmp._SOBOL_DIM1


@pytest.mark.parametrize("seed", [0, 7, 123457])
def test_threefry_u1_u2_bit_identical(seed):
    """jax.random's threefry2x32 fold_in chain and float32 uniform, in the
    partitionable layout this JAX runs."""
    pix = _counters(seed + 50, n=256)
    js, ts = jsmp.ThreefrySampler(seed), tsmp.ThreefrySampler(seed)
    for sample, bounce, dim in ((0, 0, jsmp.DIM_CAMERA_JITTER),
                                (9, 2, jsmp.DIM_LIGHT_UV)):
        np.testing.assert_array_equal(
            ts.u2(_t(pix), sample, bounce, dim).numpy(),
            np.asarray(js.u2(_j(pix), sample, bounce, dim)))
    np.testing.assert_array_equal(
        ts.u1(_t(pix), 3, 1, jsmp.DIM_LIGHT_SELECT, lane=2).numpy(),
        np.asarray(js.u1(_j(pix), 3, 1, jsmp.DIM_LIGHT_SELECT, lane=2)))


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_in_kernel_sobol_draw(seed):
    """The plain versions' in-kernel draw equals pbrs_tpu's _u1(rng="sobol")
    and, on lanes 0 / 1, the components of SobolSampler.u2."""
    pix = _counters(seed + 60).astype(np.int64) % (1 << 31)
    smp_id = np.random.default_rng(seed).integers(0, 64, size=pix.shape[0])
    sampler = tsmp.SobolSampler(seed)
    for bounce in (0, 4):
        for dim in (jsmp.DIM_LIGHT_UV, jsmp.DIM_BSDF_UV):
            pair = sampler.u2(_t(pix), _t(smp_id), bounce, dim)
            for lane in (0, 1):
                got = tfk._u1(seed, _t(pix), _t(smp_id), bounce, dim, lane,
                              "sobol")
                want = np.asarray(jfk._u1(
                    jnp.uint32(seed), jnp.asarray(pix, jnp.int32),
                    jnp.asarray(smp_id, jnp.int32), bounce, dim, lane,
                    rng="sobol"))
                np.testing.assert_array_equal(got.numpy(), want)
                np.testing.assert_array_equal(got.numpy(),
                                              pair[..., lane].numpy())
    # Lane 0 is SobolSampler.u1 too.
    np.testing.assert_array_equal(
        tfk._u1(seed, _t(pix), 3, 2, jsmp.DIM_LIGHT_SELECT, 0,
                "sobol").numpy(),
        sampler.u1(_t(pix), 3, 2, jsmp.DIM_LIGHT_SELECT).numpy())


def test_rng_kinds():
    assert tfk.rng_kind(tsmp.SobolSampler(3)) == "sobol"
    assert tfk.rng_kind(tsmp.PCGSampler(3)) == "pcg"
    assert set(tfk.RNG_CODES) == {"pcg", "sobol"}


@pytest.fixture(scope="module")
def cornell():
    jscene = jpresets.cornell_box().replace(camera=jcam.looking_at(
        jcam.make_camera((24, 24), 40.0), *VIEW))
    tscene = presets.cornell_box().replace(camera=tcam.looking_at(
        tcam.make_camera((24, 24), 40.0), *VIEW))
    return jscene, tscene


def test_k2_sobol_matches_pallas_kernel(cornell):
    """K2's plain version drawing Sobol' against the interpret-mode Pallas
    _bounce_kernel(rng="sobol"), through both integrators: 24^2, depth 5
    (roulette at bounce 4), sample 1, per lane at tests/test_fused.py's
    tolerance, equal ray counts."""
    jscene, tscene = cornell
    want, cnt_j = jfk.FusedDiffuseIntegrator(jscene, interpret=True) \
        .render_samples(jsmp.SobolSampler(3), jnp.arange(576), 1,
                        max_depth=5, msaa=2, return_ray_count=True)
    got, cnt_t = tfk.FusedDiffuseIntegrator(tscene).render_samples(
        tsmp.SobolSampler(3), torch.arange(576, dtype=torch.int32), 1,
        max_depth=5, msaa=2)
    want = np.asarray(want)
    assert want.sum() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # The Pallas kernel sums per-lane averages in float32.
    assert int(cnt_t) == pytest.approx(float(cnt_j), rel=1e-6)


def test_general_path_sobol_matches_reference(cornell):
    """The port's general path (plain route) and K2's integrator on the
    Sobol' sampler against pbrs_tpu's general path, per lane, with equal
    ray counts."""
    jscene, tscene = cornell
    want, cnt_j = jwf.render_samples(jscene, jsmp.SobolSampler(3),
                                     jnp.arange(576), 2, max_depth=4, msaa=2,
                                     return_ray_count=True)
    want = np.asarray(want)
    pix = torch.arange(576, dtype=torch.int32)
    name, fn = render.make_integrator(tscene, tsmp.SobolSampler(3), 4, 2,
                                      "plain")
    got, cnt = fn(pix, 2)
    assert name == "plain"
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert int(cnt) == int(cnt_j)
    fused, cnt_f = tfk.FusedDiffuseIntegrator(tscene).render_samples(
        tsmp.SobolSampler(3), pix, 2, max_depth=4, msaa=2)
    np.testing.assert_allclose(fused.numpy(), want, atol=ATOL, rtol=RTOL)
    assert int(cnt_f) == int(cnt_j)
