"""The render loop's options against pbrs_tpu: the BSDF-only estimator
(use_nee=False) per lane, the reference's NEE-against-brute-force checks,
exact checkpoint/resume and the SIGTERM flush, the --debug_checks audit
counts, the route rules and the CLI flags.

Per-lane contract (ROADMAP.md): atol 2e-5, rtol 1e-4. Sample indices go
to the general path as one batch (a tensor of sample ids), not a loop of
eager renders.
"""

import os
import signal

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.core import filters as jflt
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.geometry import camera as jcam
from pbrs_tpu.integrators import debug_audit as jaud
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu.scene.buffers import SceneBuilder as JSceneBuilder
from pbrs_tpu_torch import cli, render
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.geometry import camera as tcam
from pbrs_tpu_torch.integrators import debug_audit as taud
from pbrs_tpu_torch.io import image
from pbrs_tpu_torch.scene import presets
from pbrs_tpu_torch.scene.buffers import SceneBuilder as TSceneBuilder
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ATOL, RTOL = 2e-5, 1e-4


def _jcornell(size):
    scene = jpresets.cornell_box()
    cam = scene.camera
    fresh = jcam.make_camera((size, size), 40.0)
    return scene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * ((cam.width // 2) / (size // 2)),
        b=cam.b * ((cam.height // 2) / (size // 2)), c=cam.c))


def _batch(n, samples):
    pix = np.tile(np.arange(n, dtype=np.int32), len(samples))
    sid = np.repeat(np.asarray(samples, np.int32), n)
    return pix, sid


def _port_samples(scene, pix, sid, depth, msaa, seed=0, **kw):
    """The port's general path (plain route) on one batch of lanes."""
    _, fn = render.make_integrator(scene, tsmp.PCGSampler(seed), depth, msaa,
                                   "plain", **kw)
    return fn(torch.from_numpy(pix), torch.from_numpy(sid))


@pytest.mark.parametrize("pixel_filter", [None, ("mitchell", 2.0)])
def test_bsdf_only_matches_reference_per_lane(pixel_filter):
    """use_nee=False on Cornell 24^2, depth 5, msaa 2, samples 0-1, with
    and without a weighted filter: radiance per lane and the ray count."""
    size = 24
    pix, sid = _batch(size * size, [0, 1])
    table = None
    if pixel_filter is not None:
        table = jflt.make_filter_cdf(jflt.MITCHELL, 2.0)
    want, want_count = jwf.render_samples(
        _jcornell(size), jsmp.PCGSampler(0), jnp.asarray(pix),
        jnp.asarray(sid), max_depth=5, msaa=2, use_nee=False,
        return_ray_count=True, filter_inv_cdf=table)
    tscene = cli.with_resolution(presets.cornell_box(), size, size)
    from pbrs_tpu_torch.core import filters as flt

    got, count = _port_samples(
        tscene, pix, sid, 5, 2, use_nee=False,
        filter_table=None if pixel_filter is None
        else flt.filter_table(pixel_filter))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert int(count) == int(want_count)
    assert float(got.sum()) > 0


def _mirror_light_scene(builder, cam_mod):
    """tests/test_integrator.py:_mirror_light_scene with either package's
    builder: a mirror reflecting an area light into the camera over a
    diffuse floor."""
    b = builder()
    mirror = b.materials.add_mirror()
    white = b.materials.add_lambertian((0.7, 0.7, 0.7))
    lmat = b.materials.add_diffuse_light((15.0, 15.0, 15.0))
    g = b.geometry
    g.add_quad((-2, -2, 2), (4, 0, 0), (0, 4, 0), mirror)
    g.add_quad((-1, -1, -6), (2, 0, 0), (0, 2, 0), lmat)
    g.add_quad((-4, -2, -7), (8, 0, 0), (0, 0, 10), white)
    b.lights.add_area_quad((15.0, 15.0, 15.0), (-1, -1, -6), (2, 0, 0),
                           (0, 2, 0))
    cam = cam_mod.make_camera((24, 24), 60.0)
    b.camera = cam_mod.looking_at(cam, (0, 0, -3), (0, 0, 2), (0, 1, 0))
    return b.build()


def _image(scene, spp, depth, use_nee, seed, batch=256):
    """tests/test_integrator.py:_render through the port: spp = msaa^2
    samples, `batch` sample indices a call, averaged."""
    n = scene.camera.width * scene.camera.height
    msaa = int(round(spp ** 0.5))
    acc = torch.zeros(n, 3)
    for s0 in range(0, spp, batch):
        ids = range(s0, min(spp, s0 + batch))
        pix, sid = _batch(n, ids)
        rad, _ = _port_samples(scene, pix, sid, depth, msaa, seed,
                               use_nee=use_nee)
        acc += rad.reshape(len(ids), n, 3).sum(0)
    img = acc.numpy() / spp
    return img.reshape(scene.camera.height, scene.camera.width, 3)


def test_mirror_area_light_nee_not_double_counted():
    """tests/test_integrator.py:test_mirror_area_light_nee_not_double_counted
    on the port, at its tolerances: light seen through a mirror counts once
    under NEE, as under BSDF sampling alone."""
    scene = _mirror_light_scene(TSceneBuilder, tcam)
    img_nee = _image(scene, 64, 4, True, 0)
    img_brute = _image(scene, 256, 4, False, 99)
    c_nee = img_nee[8:16, 8:16].mean()
    c_brute = img_brute[8:16, 8:16].mean()
    assert c_brute > 1.0
    np.testing.assert_allclose(c_nee, c_brute, rtol=0.06)
    np.testing.assert_allclose(img_nee.mean(), img_brute.mean(), rtol=0.08)


@pytest.mark.slow
def test_cornell_nee_matches_brute_force():
    """tests/test_integrator.py:test_cornell_nee_matches_brute_force on the
    port: Cornell 32^2, NEE at 64 spp depth 5 against BSDF-only at 784 spp
    depth 6."""
    scene = cli.with_resolution(presets.cornell_box(), 32, 32)
    cam = tcam.looking_at(tcam.make_camera((32, 32), 40.0),
                          (278, 278, -800), (278, 278, 0), (0, 1, 0))
    scene = scene.replace(camera=cam)
    img_nee = _image(scene, 64, 5, True, 0)
    img_brute = _image(scene, 784, 6, False, 1234, batch=98)
    a = img_nee.reshape(4, 8, 4, 8, 3).mean(axis=(1, 3))
    b = img_brute.reshape(4, 8, 4, 8, 3).mean(axis=(1, 3))
    rel = np.abs(a - b) / np.maximum((a + b) / 2, 5e-3)
    assert np.median(rel) < 0.08, (np.median(rel), rel.max())
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.05)


# ----------------------------- checkpoint/resume -----------------------------


def _tiny():
    return cli.with_resolution(presets.cornell_box(), 16, 16)


def _sigterm_at(monkeypatch, sample):
    """Make every render's integrator send SIGTERM to this process while
    it renders `sample`."""
    make = render.make_integrator

    def patched(*a, **k):
        name, fn = make(*a, **k)

        def fn2(pix, s):
            if s == sample:
                os.kill(os.getpid(), signal.SIGTERM)
            return fn(pix, s)
        return name, fn2
    monkeypatch.setattr(render, "make_integrator", patched)


def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, monkeypatch):
    """A SIGTERM during sample 1 flushes the two samples done to the
    checkpoint and raises; resuming from it gives the uninterrupted film
    bit for bit, as does a render checkpointed every 2 samples."""
    kw = dict(spp=4, max_depth=3, seed=3, device="cpu")
    full = render.Film(16, 16)
    img_full, _ = render.render_image(_tiny(), film=full, **kw)
    ckpt = str(tmp_path / "film.npz")
    with monkeypatch.context() as m:
        _sigterm_at(m, 1)
        with pytest.raises(KeyboardInterrupt):
            render.render_image(_tiny(), checkpoint_path=ckpt, **kw)
    assert signal.getsignal(signal.SIGTERM) is not None
    saved = render.Film.load(ckpt)
    assert saved.samples_done == 2
    img, stats = render.render_image(_tiny(), film=saved,
                                     checkpoint_path=ckpt, **kw)
    assert stats.launches == 2 and stats.camera_rays == 2 * 256
    np.testing.assert_array_equal(saved.accum, full.accum)
    np.testing.assert_array_equal(img, img_full)
    again = render.Film.load(ckpt)
    assert again.samples_done == 4
    np.testing.assert_array_equal(again.accum, full.accum)
    every = render.Film(16, 16)
    render.render_image(_tiny(), film=every, checkpoint_path=ckpt,
                        checkpoint_every=2, **kw)
    np.testing.assert_array_equal(every.accum, full.accum)


def test_film_must_match_camera():
    with pytest.raises(ValueError, match="film is 8x8"):
        render.render_image(_tiny(), spp=1, device="cpu",
                            film=render.Film(8, 8))


# ---------------------------------- audit ----------------------------------


def _poisoned(builder, cam_mod):
    """tests/test_debug_audit.py's NaN-albedo sphere over a floor."""
    b = builder()
    g = b.geometry
    g.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20),
               b.materials.add_lambertian((0.5, 0.5, 0.5)))
    g.add_sphere((0, 1, 0), 1.0,
                 b.materials.add_lambertian((np.nan, 0.5, 0.5)))
    light = (8.0, 8.0, 8.0)
    g.add_quad((-1, 5, -1), (2, 0, 0), (0, 0, 2),
               b.materials.add_diffuse_light(light))
    b.lights.add_area_quad(light, (-1, 5, -1), (2, 0, 0), (0, 0, 2))
    cam = cam_mod.make_camera((24, 24), 45.0)
    b.camera = cam_mod.looking_at(cam, (0, 1, -5), (0, 1, 0), (0, 1, 0))
    return b.build()


@pytest.mark.parametrize("which", ["clean", "poisoned"])
def test_audit_counts_match_reference(which):
    """The audit against pbrs_tpu's, depth 4, msaa 1, sample 0, 24^2.

    Clean (Cornell): every count equals the reference's (all zero), and
    the audited radiance equals the unaudited. Poisoned material
    (tests/test_debug_audit.py's NaN-albedo sphere): the port counts the
    lanes that hit the NaN material; the reference's one-hot matmul
    gather of the material table (pbrs_tpu/core/gather.py) multiplies the
    NaN row by zero on every other lane too, so its counts are a superset:
    at bounce 0 the port's nonfinite_material is exactly the lanes whose
    camera ray hits the sphere, and every count is at most the
    reference's."""
    if which == "clean":
        jscene = _jcornell(24)
        tscene = cli.with_resolution(presets.cornell_box(), 24, 24)
    else:
        jscene = _poisoned(JSceneBuilder, jcam)
        tscene = _poisoned(TSceneBuilder, tcam)
    pix, sid = _batch(24 * 24, [0])
    _, want = jwf.render_samples(jscene, jsmp.PCGSampler(0),
                                 jnp.asarray(pix), jnp.asarray(sid),
                                 max_depth=4, msaa=1, audit=True)
    rad, _, counts = _port_samples(tscene, pix, sid, 4, 1, audit=True)
    got, want = taud.report(counts), jaud.report(want)
    assert tuple(got) == taud.AUDIT_KEYS == jaud.AUDIT_KEYS
    text = taud.format_report(got)
    assert text.splitlines()[0] == f"debug_checks: {sum(got.values())} " \
        "violation(s)"
    if which == "clean":
        assert got == want and sum(got.values()) == 0
        plain, _ = _port_samples(tscene, pix, sid, 4, 1)
        np.testing.assert_array_equal(rad.numpy(), plain.numpy())
        return
    assert got["nonfinite_material"] > 0
    assert all(got[k] <= want[k] for k in got), (got, want)
    from pbrs_tpu.shapes import intersect as jisect

    rays = jwf.camera_rays(jscene, jsmp.PCGSampler(0), jnp.asarray(pix),
                           jnp.asarray(sid), 1)
    on_sphere = int((np.asarray(jisect.intersect(jscene.geom, rays).mat_id)
                     == 1).sum())
    _, _, first = _port_samples(tscene, pix, sid, 1, 1, audit=True)
    assert taud.report(first)["nonfinite_material"] == on_sphere > 0


# -------------------------- route rules and the CLI --------------------------


def test_route_rules():
    """The options run the general path (route auto on the CPU is the
    plain route); stats.audit only under debug_checks; options that the
    chosen integrator does not take are refused."""
    scene = cli.with_resolution(presets.cornell_box(), 8, 8)
    for kw in ({"use_nee": False}, {"pixel_filter": ("gaussian", 1.5)},
               {"debug_checks": True}):
        img, stats = render.render_image(scene, spp=1, max_depth=2,
                                         device="cpu", **kw)
        assert stats.integrator == "plain" and np.isfinite(img).all()
        assert (stats.audit is not None) == ("debug_checks" in kw)
    _, fn = render.make_integrator(scene, tsmp.PCGSampler(0), 2, 1,
                                   "general", use_nee=False)
    for kw, what in (({"integrator": "direct", "debug_checks": True},
                      "debug_checks"),
                     ({"integrator": "direct", "use_nee": False}, "use_nee"),
                     ({"integrator": "normals",
                       "pixel_filter": ("box", 0.5)}, "pixel_filter"),
                     ({"nee_mode": "folded", "use_nee": False}, "folded")):
        with pytest.raises(ValueError, match=what):
            render.render_image(scene, spp=1, device="cpu", **kw)


def test_cli_checkpoint_filter_and_debug_checks(tmp_path, capsys,
                                                monkeypatch):
    out = str(tmp_path / "c.exr")
    ckpt = str(tmp_path / "c.npz")
    argv = ["--resolution", "16x16", "--msaa", "1", "--depth", "2",
            "--output", out, "--device", "cpu", "--filter", "gaussian:1.5",
            "--checkpoint", ckpt, "--checkpoint_every", "1",
            "--use_single_thread", "--use_multi_thread", "--debug_checks"]
    assert cli.main(argv) == 0
    first = capsys.readouterr().out
    assert "resuming" not in first and "debug_checks: 0 violation(s)" in first
    assert render.Film.load(ckpt).samples_done == 1
    img = image.read_exr(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    # The checkpoint exists now: the CLI resumes from it (nothing is left
    # to render at 1 spp) and writes the same image.
    assert cli.main(argv) == 0
    assert f"resuming from {ckpt} at 1 samples" in capsys.readouterr().out
    np.testing.assert_array_equal(image.read_exr(out), img)
    # A violation exits non-zero, the image still written.
    render_image = render.render_image

    def violating(*a, **k):
        img, stats = render_image(*a, **k)
        stats.audit["nonfinite_f"] = 1
        return img, stats
    monkeypatch.setattr(render, "render_image", violating)
    os.remove(ckpt)
    assert cli.main(argv) == 2
    assert "FAIL nonfinite_f" in capsys.readouterr().out
