"""The port's direct integrator and visualizers against pbrs_tpu's
(integrators/direct.py) per lane on a small Cornell box, and render_image /
the CLI with the direct integrator on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.integrators import direct as jdirect
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import cli, render
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.integrators import direct
from pbrs_tpu_torch.integrators import wavefront as twf
from pbrs_tpu_torch.io import image
from test_fused_single_lobe import _shrunk
from test_torch_wave import _carry

ATOL, RTOL = 3e-5, 2e-4
SIZE = 16


@pytest.fixture(scope="module")
def cornell():
    jscene = _shrunk(jpresets.cornell_box(), SIZE)
    return jscene, _carry(jscene)


def _rays(scenes, sample, sampler="pcg"):
    jscene, tscene = scenes
    js = {"pcg": jsmp.PCGSampler, "sobol": jsmp.SobolSampler}[sampler](2)
    ts = {"pcg": tsmp.PCGSampler, "sobol": tsmp.SobolSampler}[sampler](2)
    n = SIZE * SIZE
    pix_j, pix_t = jnp.arange(n), torch.arange(n, dtype=torch.int32)
    return (js, pix_j, jwf.camera_rays(jscene, js, pix_j, sample, 2),
            ts, pix_t, twf.camera_rays(tscene, ts, pix_t, sample, 2))


@pytest.mark.parametrize("sampler, depth", [("pcg", 2), ("sobol", 5)])
def test_direct_radiance_matches_reference(cornell, sampler, depth):
    jscene, tscene = cornell
    js, pix_j, rays_j, ts, pix_t, rays_t = _rays(cornell, 1, sampler)
    want = np.asarray(jdirect.direct_radiance(jscene, rays_j, js, pix_j, 1,
                                              depth=depth))
    got = direct.direct_radiance(tscene, rays_t, ts, pix_t, 1, depth=depth)
    assert want.sum() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_specular_chain_matches_reference():
    """A mirror sphere in a lit scene: the chain follows the delta lobe
    with the |cos| throughput (COMPAT.md), depth 3."""
    from test_folded_nee import _scene

    jscene = _shrunk(_scene(), SIZE)
    tscene = _carry(jscene)
    js, pix_j, rays_j, ts, pix_t, rays_t = _rays((jscene, tscene), 0)
    want = np.asarray(jdirect.direct_radiance(jscene, rays_j, js, pix_j, 0,
                                              depth=3))
    got = direct.direct_radiance(tscene, rays_t, ts, pix_t, 0, depth=3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", ["normals", "materials"])
def test_visualizers_match_reference(cornell, kind):
    jscene, tscene = cornell
    _, _, rays_j, _, _, rays_t = _rays(cornell, 0)
    fn_j = {"normals": jdirect.normal_visualizer,
            "materials": jdirect.material_visualizer}[kind]
    fn_t = {"normals": direct.normal_visualizer,
            "materials": direct.material_visualizer}[kind]
    want = np.asarray(fn_j(jscene, rays_j))
    got = fn_t(tscene, rays_t)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_render_image_direct(cornell):
    """render_image(integrator="direct") on the CPU: the mean of
    direct_radiance over the msaa^2 sample indices, with every traced
    segment counted; a visualizer traces one segment a pixel."""
    _, tscene = cornell
    got, stats = render.render_image(tscene, spp=4, max_depth=2, seed=1,
                                     integrator="direct", device="cpu")
    sampler = tsmp.PCGSampler(1)
    n = SIZE * SIZE
    want = torch.zeros(n, 3)
    for s in range(4):
        pix = torch.arange(n, dtype=torch.int32)
        rays = twf.camera_rays(tscene, sampler, pix, s, 2)
        want += direct.direct_radiance(tscene, rays, sampler, pix, s, depth=2)
    np.testing.assert_allclose(got.reshape(n, 3), (want / 4).numpy(),
                               atol=ATOL, rtol=RTOL)
    # Two closest hits and up to two shadow rays a lane a segment.
    assert stats.integrator == "direct"
    assert 4 * n < stats.traced_rays <= 6 * 4 * n
    vis, stats = render.render_image(tscene, spp=1, integrator="normals",
                                     device="cpu")
    assert vis.shape == (SIZE, SIZE, 3) and stats.traced_rays == n


def test_cli_direct_and_visualizers(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "cornell.exr")
    rc = cli.main(["--scene_name", "cornell_box", "--resolution", "16x16",
                   "--msaa", "1", "--depth", "2", "--integrator", "direct",
                   "--sampler", "sobol", "--visualize_normals",
                   "--visualize_materials", "--output", out,
                   "--device", "cpu"])
    img = image.read_exr(out)
    assert rc == 0 and img.shape == (16, 16, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    said = capsys.readouterr().out
    assert "direct path on cpu" in said
    for name in ("cornell_box-normals.png", "cornell_box-mtl.png"):
        vis = image.read_png(str(tmp_path / name))
        assert vis.shape == (16, 16, 3) and name in said
