"""The port's fused bounce (K2's plain version) and integrators vs
pbrs_tpu: the Pallas bounce kernel in interpret mode and the jnp general
wavefront, per lane at 24^2."""

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
from pbrs_tpu_torch.integrators import wavefront as twf
from pbrs_tpu_torch.scene import presets

SIZE = 24
ATOL, RTOL = 2e-5, 1e-4  # tests/test_fused.py:38
# Ray origins are scene coordinates up to 555, where one float32 ulp is
# 6.1e-5: two ulps, since XLA's CPU code and PyTorch round p + t*d apart.
ORIGIN_ATOL = 2 * float(np.spacing(np.float32(555.0)))
VIEW = ((278, 278, -800), (278, 278, 0), (0, 1, 0))


@pytest.fixture(scope="module")
def scenes():
    jscene = jpresets.cornell_box().replace(camera=jcam.looking_at(
        jcam.make_camera((SIZE, SIZE), 40.0), *VIEW))
    tscene = presets.cornell_box().replace(camera=tcam.looking_at(
        tcam.make_camera((SIZE, SIZE), 40.0), *VIEW))
    return jscene, tscene


def test_tables_match_reference(scenes):
    jscene, tscene = scenes
    integ = jfk.FusedDiffuseIntegrator(jscene, interpret=True)
    tab = tfk.FusedTables.from_scene(tscene)
    # Column 15 holds global prim ids in the port's bank (the Pallas bounce
    # bank zeroes it); the bounce reads columns 0-13 only.
    np.testing.assert_array_equal(
        tab.bank.numpy()[:, :15],
        np.stack([np.asarray(c) for c in integ.params], 1)[:, :15])
    np.testing.assert_array_equal(tab.mats.numpy(), np.asarray(integ.mats))
    np.testing.assert_array_equal(tab.lights.numpy(), np.asarray(integ.lights))
    np.testing.assert_array_equal(tab.env.numpy(), integ.env_colors)
    assert (tab.counts, tab.n_area, tab.env_kind) == (
        integ.counts, integ.n_area, integ.env_kind)


def _pallas_bounce(integ, bounce, fin, alive, pix, samp, seed=0):
    """One interpret-mode Pallas bounce on [n] planes padded to a tile."""
    n = fin.shape[1]
    rows = 64
    pad = rows * 128 - n

    def plane(a, fill):
        a = np.concatenate([a, np.full(pad, fill, a.dtype)])
        return jnp.asarray(a.reshape(rows, 128))

    f = [plane(fin[i], 1.0 if 3 <= i < 6 else 0.0) for i in range(9)]
    out = jfk._bounce_call(
        integ.params, integ.mats, integ.lights,
        jnp.asarray([seed, bounce], jnp.int32), jnp.asarray(integ.env_colors),
        *f, plane(alive, 0), plane(pix, 0), plane(samp, 0),
        counts=integ.counts, n_mats=int(integ.mats.shape[0]),
        n_area=integ.n_area, env_kind=integ.env_kind,
        bounce_is_first=bounce == 0, rr_active=bounce > 3, interpret=True)
    planes = np.stack([np.asarray(o).reshape(-1)[:n] for o in out[:12]])
    return (planes, np.asarray(out[12]).reshape(-1)[:n],
            float(np.sum(np.asarray(out[13]))))


@pytest.mark.parametrize("bounce", [0, 4])
def test_bounce_reference_matches_pallas_kernel(scenes, bounce):
    jscene, tscene = scenes
    tab = tfk.FusedTables.from_scene(tscene)
    n = SIZE * SIZE
    pix = torch.arange(n, dtype=torch.int32)
    samp = torch.full((n,), 1, dtype=torch.int32)
    rays = twf.camera_rays(tscene, tsmp.PCGSampler(0), pix, 1, 2)
    fin = torch.cat([rays.origin.T, rays.dir.T, torch.ones(3, n)])
    alive = torch.ones(n, dtype=torch.int32)
    for b in range(bounce):  # the port's own planes up to `bounce`
        fout, alive, _ = tfk.bounce_reference(
            tab, fin, alive, pix, samp, seed=0, bounce=b,
            bounce_is_first=b == 0, rr_active=b > 3)
        fin = fout[3:]
    got, alive_t, cnt_t = tfk.bounce_reference(
        tab, fin, alive, pix, samp, seed=0, bounce=bounce,
        bounce_is_first=bounce == 0, rr_active=bounce > 3)
    integ = jfk.FusedDiffuseIntegrator(jscene, interpret=True)
    want, alive_j, cnt_j = _pallas_bounce(
        integ, bounce, fin.numpy(), alive.numpy(), pix.numpy(), samp.numpy())
    live = alive.numpy() > 0
    assert 0 < live.sum() and (bounce == 0) == live.all()
    got = got.numpy()
    # Radiance and beta on every lane; next origin/dir on live lanes (the
    # Pallas kernel recomputes a dead lane's ray inside a live tile, the
    # port passes it through).
    for rows, mask, atol in ((slice(0, 3), slice(None), ATOL),
                             (slice(3, 6), live, ORIGIN_ATOL),
                             (slice(6, 9), live, ATOL),
                             (slice(9, 12), slice(None), ATOL)):
        np.testing.assert_allclose(got[rows][:, mask], want[rows][:, mask],
                                   atol=atol, rtol=RTOL)
    np.testing.assert_array_equal(alive_t.numpy(), alive_j)
    assert int(cnt_t) == pytest.approx(cnt_j, rel=1e-6)


@pytest.mark.parametrize("sample", [0, 3])
def test_integrators_match_reference_per_lane(scenes, sample):
    jscene, tscene = scenes
    n = SIZE * SIZE
    rad_j, cnt_j = jwf.render_samples(jscene, jsmp.PCGSampler(0),
                                      jnp.arange(n), sample, max_depth=5,
                                      msaa=2, return_ray_count=True)
    rad_j = np.asarray(rad_j)
    pix = torch.arange(n, dtype=torch.int32)
    fused = tfk.FusedDiffuseIntegrator(tscene)
    rad_f, cnt_f = fused.render_samples(tsmp.PCGSampler(0), pix, sample,
                                        max_depth=5, msaa=2)
    results = {"fused": (rad_f, cnt_f)}
    for route in ("general", "plain"):
        _, fn = render.make_integrator(tscene, tsmp.PCGSampler(0), 5, 2, route)
        results[route] = fn(pix, sample)
    for name, (rad, cnt) in results.items():
        np.testing.assert_allclose(rad.numpy(), rad_j, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        assert int(cnt) == pytest.approx(float(cnt_j), rel=1e-6), name


def test_rng_kind_takes_pcg_only():
    """The fused kernels draw PCG and Sobol' in-kernel; a threefry sampler
    (jax.random's stream) is refused and takes the general wavefront."""
    assert tfk.rng_kind(tsmp.PCGSampler(1)) == "pcg"
    assert tfk.rng_kind(tsmp.SobolSampler(1)) == "sobol"
    for sampler in (tsmp.ThreefrySampler(1), jsmp.SobolSampler(1)):
        with pytest.raises(TypeError):
            tfk.rng_kind(sampler)
