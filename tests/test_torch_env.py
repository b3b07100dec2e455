"""The port's image environment and its importance sampling
(lights/env_sampling.py, lights/lights.py ENV_IMAGE, the env-IS arm of
integrators/nee.py) against pbrs_tpu's: the alias-table distribution array
for array, sample_env / eval_env_pdf / pdf_env / eval_env per lane on
seeded uniforms and directions, the invariants of tests/test_env_sampling.py
on the port alone, and the general path's radiance per lane on an
env-lit scene."""

import math
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.lights import env_sampling as jes
from pbrs_tpu.lights import lights as jlt
from pbrs_tpu_torch.io import image as io_image
from pbrs_tpu_torch.lights import env_sampling as es
from pbrs_tpu_torch.lights import lights as lt
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Directions come from sin / cos / atan2 / acos, which PyTorch's and XLA's
# CPU code round a few ulps apart.
DIR_ATOL, PDF_RTOL = 2e-6, 2e-5


def _test_image(h=16, w=32, seed=0):
    """tests/test_env_sampling.py's image: dim noise + a bright window."""
    img = np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)
    img *= 0.2
    img[5:8, 10:14] = 25.0
    return img


def _window():
    return io_image.read_png_rgb(os.path.join(
        REPO, "scenes", "interior", "textures", "env_window.png"))


def _sphere_grid(n_theta=128, n_phi=256):
    theta = (np.arange(n_theta) + 0.5) * np.pi / n_theta
    phi = (np.arange(n_phi) + 0.5) * 2 * np.pi / n_phi - np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                    -1).reshape(-1, 3).astype(np.float32)
    dw = (np.sin(t) * (np.pi / n_theta) * (2 * np.pi / n_phi)).reshape(-1)
    return dirs, dw


@pytest.fixture(scope="module")
def dists():
    """(image, scale, port distribution, pbrs_tpu distribution) for the
    test image and the interior's window map."""
    out = {}
    for name, img, scale in (("test", _test_image(), (1.0, 1.0, 1.0)),
                             ("window", _window(), (1.5, 1.2, 1.0))):
        out[name] = (img, scale, es.build_distribution(img, scale),
                     jes.build_distribution(img, scale))
    return out


@pytest.mark.parametrize("name", ["test", "window"])
def test_distribution_arrays_equal(dists, name):
    _, _, d, jd = dists[name]
    for field in ("marginal_cdf", "conditional_cdf", "pdf_img", "image",
                  "scale", "alias_packed"):
        got, want = getattr(d, field).numpy(), np.asarray(getattr(jd, field))
        assert got.dtype == want.dtype and got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("name", ["test", "window"])
def test_sample_env_per_lane(dists, name):
    _, _, d, jd = dists[name]
    u2 = np.random.default_rng(3).random((8192, 2)).astype(np.float32)
    got = es.sample_env(d, torch.from_numpy(u2))
    want = jes.sample_env(jd, jnp.asarray(u2))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=DIR_ATOL, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=PDF_RTOL, atol=0)


def _boundary(dirs, h, w, eps=1e-4):
    """Lanes whose equirect coordinates lie within eps of a texel edge."""
    d = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    u = (np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi) + 0.5) % 1.0
    v = np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi
    fu, fv = u * w, v * h
    return ((np.abs(fu - np.round(fu)) < eps * w)
            | (np.abs(fv - np.round(fv)) < eps * h))


@pytest.mark.parametrize("name", ["test", "window"])
def test_eval_env_and_pdf_per_lane(dists, name):
    """eval_env (ENV_IMAGE), eval_env_pdf and pdf_env on seeded directions.
    A lane may pick the neighbouring texel only where its direction lies on
    a texel edge (atan2 / acos round apart); every other lane is equal."""
    img, scale, d, jd = dists[name]
    env = lt.make_env_image(img, scale)
    jenv = jlt.make_env_image(img, scale)
    dirs = np.random.default_rng(4).normal(size=(8192, 3)).astype(np.float32)
    tdir, jdir = torch.from_numpy(dirs), jnp.asarray(dirs)
    rad, pdf = es.eval_env_pdf(env, tdir)
    jrad, jpdf = jes.eval_env_pdf(jenv, jdir)
    pairs = ((lt.eval_env(env, tdir), jlt.eval_env(jenv, jdir)),
             (rad, jrad), (pdf, jpdf),
             (es.pdf_env(d, tdir), jes.pdf_env(jd, jdir)))
    edge = _boundary(dirs, *img.shape[:2])
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        ok = np.isclose(got, want, rtol=PDF_RTOL, atol=0)
        ok = ok.all(axis=-1) if ok.ndim > 1 else ok
        assert ok[~edge].all() and (~ok).sum() <= edge.sum()


def test_env_image_tables_carried():
    """scene_to_arrays / scene_from_arrays carry the env image and its
    distribution exactly."""
    from pbrs_tpu_torch.scene import buffers, presets

    scene = presets.cornell_box()
    scene.env = lt.make_env_image(_test_image(), (2.0, 2.0, 2.0))
    back = buffers.scene_from_arrays(buffers.scene_to_arrays(scene))
    assert back.env.kind == lt.ENV_IMAGE
    for field in ("marginal_cdf", "conditional_cdf", "pdf_img", "image",
                  "scale", "alias_packed"):
        torch.testing.assert_close(getattr(back.env.dist, field),
                                   getattr(scene.env.dist, field),
                                   rtol=0, atol=0)


# ---- tests/test_env_sampling.py's invariants, on the port alone ----


def test_pdf_integrates_to_one(dists):
    _, _, d, _ = dists["test"]
    dirs, dw = _sphere_grid()
    pdf = es.pdf_env(d, torch.from_numpy(dirs)).numpy()
    assert abs(float((pdf * dw).sum()) - 1.0) < 2e-2


def test_sample_pdf_consistency(dists):
    """The importance-sampled estimate of the env's luminance integral
    equals the Riemann sum; sampled pdfs equal pdf_env at the samples; the
    bright window takes most samples; eval_env returns the sampled texel."""
    img, _, d, _ = dists["test"]
    u2 = torch.from_numpy(
        np.random.default_rng(3).random((1 << 16, 2)).astype(np.float32))
    dirs_s, rad, pdf = es.sample_env(d, u2)
    lum = (0.21267127 * rad[:, 0] + 0.71515972 * rad[:, 1]
           + 0.07216883 * rad[:, 2]).numpy()
    est = float(np.mean(lum / np.maximum(pdf.numpy(), 1e-12)))
    dirs, dw = _sphere_grid(256, 512)
    vals = lt.eval_env(lt.make_env_image(img), torch.from_numpy(dirs)).numpy()
    lum_g = (0.21267127 * vals[:, 0] + 0.71515972 * vals[:, 1]
             + 0.07216883 * vals[:, 2])
    ref = float((lum_g * dw).sum())
    assert abs(est - ref) / ref < 0.03
    assert float((rad.sum(-1) > 10.0).float().mean()) > 0.7
    ok = np.isclose(pdf.numpy(), es.pdf_env(d, dirs_s).numpy(), rtol=1e-3,
                    atol=1e-6)
    assert ok.mean() > 0.999
    back = lt.eval_env(lt.make_env_image(img), dirs_s).numpy()
    assert np.isclose(back, rad.numpy(), rtol=1e-5).all(-1).mean() > 0.99
    assert math.isfinite(float(pdf.min())) and float(pdf.min()) > 0


def _env_scene(pkg):
    """tests/test_env_sampling.py's dark env with one bright window over a
    diffuse floor, plus a glossy sphere, at 12^2."""
    if pkg == "jax":
        from pbrs_tpu.geometry import camera as cam_mod
        from pbrs_tpu.lights import lights as lights_mod
        from pbrs_tpu.scene.buffers import SceneBuilder
    else:
        from pbrs_tpu_torch.geometry import camera as cam_mod
        from pbrs_tpu_torch.lights import lights as lights_mod
        from pbrs_tpu_torch.scene.buffers import SceneBuilder
    b = SceneBuilder()
    b.geometry.add_quad((-20, 0, -20), (40, 0, 0), (0, 0, 40),
                        b.materials.add_lambertian((0.7, 0.7, 0.7)))
    b.geometry.add_sphere((0, 1, 0), 1.0, b.materials.add_glossy(
        (0.8, 0.8, 0.8), 0.3))
    img = np.full((16, 32, 3), 0.01, np.float32)
    img[4:6, 7:9] = 60.0
    b.lights.env = lights_mod.make_env_image(img)
    cam = cam_mod.make_camera((12, 12), 45.0)
    b.camera = cam_mod.looking_at(cam, (0, 3, -8), (0, 0.5, 0), (0, 1, 0))
    return b.build()


def test_general_path_env_is_matches_reference():
    """The port's general path (NEE with the env-IS arm) against pbrs_tpu's
    per lane, with equal ray counts."""
    from pbrs_tpu.core import sampler as jsmp
    from pbrs_tpu.integrators import wavefront as jwf
    from pbrs_tpu_torch import render
    from pbrs_tpu_torch.core import sampler as tsmp

    jscene, tscene = _env_scene("jax"), _env_scene("torch")
    want, cnt_j = jwf.render_samples(jscene, jsmp.PCGSampler(0),
                                     jnp.arange(144), 0, max_depth=2, msaa=2,
                                     return_ray_count=True)
    _, fn = render.make_integrator(tscene, tsmp.PCGSampler(0), 2, 2, "plain")
    got, cnt_t = fn(torch.arange(144, dtype=torch.int32), 0)
    want = np.asarray(want)
    assert want.sum() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=2e-4)
    assert int(cnt_t) == int(cnt_j)
