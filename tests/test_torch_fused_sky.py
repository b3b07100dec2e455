"""The fused bounce's sphere-detail and environment branches, which the
Cornell box never takes: an open scene with two spheres under a gradient
or constant sky, port vs pbrs_tpu at 16^2."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pbrs_tpu.geometry.camera as jcam
import pbrs_tpu.lights.lights as jlights
import pbrs_tpu.scene.buffers as jbuffers
from pbrs_tpu.accel import fused_kernel as jfk
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.integrators import wavefront as jwf
import pbrs_tpu_torch.geometry.camera as tcam
import pbrs_tpu_torch.lights.lights as tlights
import pbrs_tpu_torch.scene.buffers as tbuffers
from pbrs_tpu_torch import render
from pbrs_tpu_torch.accel import fused_kernel as tfk
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.integrators import wavefront as twf
from pbrs_tpu_torch.scene import buffers

from test_torch_fused import ATOL, ORIGIN_ATOL, RTOL, _pallas_bounce
from test_torch_scene import jax_arrays
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

SIZE = 16


def sky_scene(buffers_mod, lights_mod, cam_mod, env):
    """The same open scene in either package (chip_smoke.py:sky_scene)."""
    b = buffers_mod.SceneBuilder()
    white = b.materials.add_lambertian((0.73, 0.73, 0.73))
    red = b.materials.add_lambertian((0.65, 0.05, 0.05))
    light = b.materials.add_diffuse_light((15.0, 15.0, 15.0))
    g = b.geometry
    g.add_quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    g.add_quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)
    g.add_quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light)
    g.add_sphere((190, 90, 190), 90, red)
    g.add_sphere((370, 120, 300), 120, white)
    b.lights.add_area_quad((15.0, 15.0, 15.0), (213, 554, 227), (130, 0, 0),
                           (0, 0, 105))
    b.lights.env = (lights_mod.make_env_gradient((0.5, 0.7, 1.0), (1, 1, 1))
                    if env == "gradient" else
                    lights_mod.make_env_const((0.2, 0.3, 0.4)))
    b.camera = cam_mod.looking_at(cam_mod.make_camera((SIZE, SIZE), 40.0),
                                  (278, 278, -800), (278, 278, 0), (0, 1, 0))
    return b.build()


@pytest.fixture(scope="module", params=["gradient", "const"])
def scenes(request):
    jscene = sky_scene(jbuffers, jlights, jcam, request.param)
    tscene = sky_scene(tbuffers, tlights, tcam, request.param)
    return jscene, tscene


def test_scene_equal_and_fused_eligible(scenes):
    jscene, tscene = scenes
    want = jax_arrays(jscene)
    got = buffers.scene_to_arrays(tscene)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tfk.scene_supports_fused(tscene) and jfk.scene_supports_fused(
        jscene)


@pytest.mark.parametrize("bounce", [0, 2])
def test_bounce_reference_matches_pallas_kernel(scenes, bounce):
    jscene, tscene = scenes
    tab = tfk.FusedTables.from_scene(tscene)
    n = SIZE * SIZE
    pix = torch.arange(n, dtype=torch.int32)
    samp = torch.zeros(n, dtype=torch.int32)
    r = twf.camera_rays(tscene, tsmp.PCGSampler(0), pix, 0, 2)
    fin = torch.cat([r.origin.T, r.dir.T, torch.ones(3, n)])
    alive = torch.ones(n, dtype=torch.int32)
    for b in range(bounce):
        fout, alive, _ = tfk.bounce_reference(
            tab, fin, alive, pix, samp, seed=0, bounce=b,
            bounce_is_first=b == 0, rr_active=False)
        fin = fout[3:]
    got, alive_t, cnt_t = tfk.bounce_reference(
        tab, fin, alive, pix, samp, seed=0, bounce=bounce,
        bounce_is_first=bounce == 0, rr_active=False)
    want, alive_j, cnt_j = _pallas_bounce(
        jfk.FusedDiffuseIntegrator(jscene, interpret=True), bounce,
        fin.numpy(), alive.numpy(), pix.numpy(), samp.numpy())
    live = alive.numpy() > 0
    got = got.numpy()
    for rows, mask, atol in ((slice(0, 3), slice(None), ATOL),
                             (slice(3, 6), live, ORIGIN_ATOL),
                             (slice(6, 9), live, ATOL),
                             (slice(9, 12), slice(None), ATOL)):
        np.testing.assert_allclose(got[rows][:, mask], want[rows][:, mask],
                                   atol=atol, rtol=RTOL)
    np.testing.assert_array_equal(alive_t.numpy(), alive_j)
    assert int(cnt_t) == pytest.approx(cnt_j, rel=1e-6)


def test_integrators_match_reference_per_lane(scenes):
    jscene, tscene = scenes
    n = SIZE * SIZE
    rad_j, cnt_j = jwf.render_samples(jscene, jsmp.PCGSampler(0),
                                      jnp.arange(n), 1, max_depth=5, msaa=2,
                                      return_ray_count=True)
    pix = torch.arange(n, dtype=torch.int32)
    results = {"fused": tfk.FusedDiffuseIntegrator(tscene).render_samples(
        tsmp.PCGSampler(0), pix, 1, max_depth=5, msaa=2)}
    _, fn = render.make_integrator(tscene, tsmp.PCGSampler(0), 5, 2,
                                   "general")
    results["general"] = fn(pix, 1)
    for name, (rad, cnt) in results.items():
        np.testing.assert_allclose(rad.numpy(), np.asarray(rad_j), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
        assert int(cnt) == pytest.approx(float(cnt_j), rel=1e-6), name
    assert np.asarray(rad_j).sum() > 0
