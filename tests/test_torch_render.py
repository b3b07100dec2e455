"""The port's render loop and CLI: the pinned Cornell checksum, the same
image as pbrs_tpu.render.render_image(use_pallas=False), and a readable
EXR from the command line."""

import json
import os

import numpy as np
import pytest
import torch

from pbrs_tpu import render as jrender
from pbrs_tpu.geometry import camera as jcam
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import cli, render
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.io import image
from pbrs_tpu_torch.scene import presets

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_checksums.json")
REL_TOL = 2e-3  # tests/test_golden.py


@pytest.mark.parametrize("route", ["plain", "general"])
def test_golden_checksum(route):
    """tests/test_golden.py's Cornell config: 48^2, depth 4, msaa 2,
    samples 0 and 1."""
    with open(GOLDEN) as f:
        want = json.load(f)["cornell_box"]
    scene = cli.with_resolution(presets.cornell_box(), 48, 48)
    _, fn = render.make_integrator(scene, tsmp.PCGSampler(0), 4, 2, route)
    pix = torch.arange(48 * 48, dtype=torch.int32)
    got = sum(float(fn(pix, s)[0].sum()) for s in range(2))
    assert abs(got - want) <= REL_TOL * abs(want)


def _scenes(size):
    def shrunk(scene, cam_mod):
        cam = scene.camera
        fresh = cam_mod.make_camera((size, size), 40.0)
        return scene.replace(camera=fresh.replace(
            center=cam.center, orientation=cam.orientation,
            a=cam.a * ((cam.width // 2) / (size // 2)),
            b=cam.b * ((cam.height // 2) / (size // 2)), c=cam.c))

    return (shrunk(jpresets.cornell_box(), jcam),
            cli.with_resolution(presets.cornell_box(), size, size))


def test_render_image_matches_reference():
    jscene, tscene = _scenes(16)
    want, _ = jrender.render_image(jscene, spp=4, max_depth=5, seed=1,
                                   use_pallas=False)
    got, stats = render.render_image(tscene, spp=4, max_depth=5, seed=1,
                                     device="cpu")
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)
    assert stats.integrator == "plain" and stats.spp == 4
    assert stats.camera_rays == 4 * 16 * 16 and stats.traced_rays > 0
    # Chunked lanes (three chunks, the last padded) give the same image.
    chunked, _ = render.render_image(tscene, spp=4, max_depth=5, seed=1,
                                     chunk_pixels=100, route="general",
                                     device="cpu")
    np.testing.assert_allclose(chunked, got, atol=2e-5, rtol=1e-4)


def test_cli_writes_exr(tmp_path, capsys):
    out = str(tmp_path / "cornell.exr")
    rc = cli.main(["--scene_name", "cornell_box", "--resolution", "16x16",
                   "--msaa", "1", "--depth", "3", "--output", out,
                   "--device", "cpu"])
    img = image.read_exr(out)
    assert rc == 0 and img.shape == (16, 16, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    assert "plain path on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--checkpoint", "film.npz"],
                                  ["--scene_name", "fourier_plastic"],
                                  ["--filter", "gaussian:1.5"]])
def test_cli_refuses_unported(argv):
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(argv)


def test_cli_renders_plates_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "plates.exr")
    rc = cli.main(["--scene_name", "plates", "--resolution", "16x16",
                   "--msaa", "1", "--depth", "3", "--output", out,
                   "--device", "cpu"])
    img = image.read_exr(out)
    assert rc == 0 and img.shape == (16, 16, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    assert "plain path on cpu" in capsys.readouterr().out


def test_card_is_the_default(monkeypatch):
    """Without a CUDA device the entry points refuse rather than fall back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = cli.with_resolution(presets.cornell_box(), 8, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render.render_image(scene, spp=1)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--resolution", "8x8"])


def test_unported_integrator_and_route_raise():
    """Every integrator, sampler and NEE mode of pbrs_tpu is ported; an
    unknown one, an unknown route, and the options still unported
    (checkpoints, pixel filters) are refused."""
    scene = cli.with_resolution(presets.cornell_box(), 8, 8)
    for kw, what in (({"integrator": "bdpt"}, "integrator"),
                     ({"route": "fast"}, "route"),
                     ({"sampler_kind": "halton"}, "sampler_kind"),
                     ({"nee_mode": "onearm"}, "nee_mode")):
        with pytest.raises(ValueError, match=what):
            render.render_image(scene, device="cpu", **kw)
    for kw in ({"checkpoint_path": "film.npz"},
               {"pixel_filter": ("gaussian", 1.5)}):
        with pytest.raises(TypeError):
            render.render_image(scene, device="cpu", **kw)
