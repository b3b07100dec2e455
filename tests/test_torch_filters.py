"""The port's pixel filters (core/filters.py) and filter importance
sampling in camera_rays_weighted against pbrs_tpu.core.filters and
pbrs_tpu's camera_rays_weighted, lane for lane; then the invariants of
tests/test_spline_filters.py on the port's tables."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.core import filters as jflt
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import cli
from pbrs_tpu_torch.core import filters as flt
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.integrators import wavefront as twf
from pbrs_tpu_torch.scene import presets
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

KINDS = [("box", 0.5), ("triangle", 1.5), ("gaussian", 1.5),
         ("mitchell", 2.0), ("lanczos", 3.0)]


@pytest.mark.parametrize("name,radius", KINDS)
def test_tables_and_offsets_match_reference(name, radius):
    kind = flt.KINDS[name]
    want = jflt.make_filter_cdf(kind, radius)
    got = flt.filter_table((name, radius))
    np.testing.assert_array_equal(got.inv_cdf.numpy(),
                                  np.asarray(want.inv_cdf))
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    assert got.weighted == want.weighted
    u = np.random.default_rng(kind).random(4096, np.float32)
    u[:3] = [0.0, 0.5, np.float32(0.99999994)]
    off_j, w_j = jflt.sample_filter_offset(want, jnp.asarray(u))
    off_t, w_t = flt.sample_filter_offset(got, torch.from_numpy(u))
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
    assert (w_t is None) == (w_j is None)
    if w_t is not None:
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


@pytest.mark.parametrize("name,radius", [("gaussian", 1.5), ("mitchell", 2.0)])
def test_camera_rays_weighted_match_reference(name, radius):
    """Rays and signed weights per lane, 24^2 Cornell, msaa 2, samples 0-3
    in one batch."""
    size = 24
    jscene = jpresets.cornell_box()
    cam = jscene.camera
    from pbrs_tpu.geometry import camera as jcam

    fresh = jcam.make_camera((size, size), 40.0)
    jscene = jscene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * ((cam.width // 2) / (size // 2)),
        b=cam.b * ((cam.height // 2) / (size // 2)), c=cam.c))
    tscene = cli.with_resolution(presets.cornell_box(), size, size)
    pix = np.tile(np.arange(size * size, dtype=np.int32), 4)
    sid = np.repeat(np.arange(4, dtype=np.int32), size * size)
    jr, jw = jwf.camera_rays_weighted(
        jscene, jsmp.PCGSampler(3), jnp.asarray(pix), jnp.asarray(sid), 2,
        jflt.make_filter_cdf(flt.KINDS[name], radius))
    tr, tw = twf.camera_rays_weighted(
        tscene, tsmp.PCGSampler(3), torch.from_numpy(pix),
        torch.from_numpy(sid), 2, flt.filter_table((name, radius)))
    np.testing.assert_allclose(tr.origin.numpy(), np.asarray(jr.origin),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tr.dir.numpy(), np.asarray(jr.dir),
                               rtol=1e-6, atol=1e-6)
    assert (tw is None) == (jw is None) == (name != "mitchell")
    if tw is not None:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # camera_rays is the same warp without the weight.
    rays = twf.camera_rays(tscene, tsmp.PCGSampler(3), torch.from_numpy(pix),
                           torch.from_numpy(sid), 2,
                           flt.filter_table((name, radius)))
    np.testing.assert_array_equal(rays.dir.numpy(), tr.dir.numpy())


def test_gaussian_filter_fixed():
    x = np.array([0.0, 0.5, 1.0])
    alpha, radius = 2.0, 1.0
    want = np.exp(-alpha * x**2) - np.exp(-alpha * radius**2)
    got = flt.eval_filter_1d(flt.GAUSSIAN, radius, x, alpha=alpha)
    np.testing.assert_allclose(got, np.maximum(want, 0.0), rtol=1e-12)


def test_mitchell_partition():
    xs = np.linspace(-2, 2, 5001)
    f = flt.eval_filter_1d(flt.MITCHELL, 2.0, xs)
    np.testing.assert_allclose(flt._trapezoid(f, xs), 1.0, atol=2e-2)


def test_filter_importance_sampling_matches_distribution():
    for kind, radius in [(flt.TRIANGLE, 1.5), (flt.GAUSSIAN, 2.0)]:
        table = flt.make_filter_cdf(kind, radius)
        assert not table.weighted
        u = torch.from_numpy(np.random.default_rng(0).random(1 << 16,
                                                             np.float32))
        xs, w = flt.sample_filter_offset(table, u)
        xs = xs.numpy()
        assert w is None
        assert np.abs(xs).max() <= radius + 1e-4
        hist, edges = np.histogram(xs, bins=32, range=(-radius, radius),
                                   density=True)
        centers = 0.5 * (edges[:-1] + edges[1:])
        f = flt.eval_filter_1d(kind, radius, centers)
        f = f / flt._trapezoid(f, centers)
        mask = f > 0.1
        np.testing.assert_allclose(hist[mask], f[mask], rtol=0.2)


def test_box_filter_sampling_uniform():
    table = flt.make_filter_cdf(flt.BOX, 0.5)
    u = torch.from_numpy(np.linspace(0, 0.999999, 101, dtype=np.float32))
    xs, _ = flt.sample_filter_offset(table, u)
    xs = xs.numpy()
    np.testing.assert_allclose(xs[0], -0.5, atol=0.02)
    np.testing.assert_allclose(xs[-1], 0.5, atol=0.02)


def test_mitchell_weighted_fis_reconstructs_true_filter():
    radius = 2.0
    table = flt.make_filter_cdf(flt.MITCHELL, radius)
    assert table.weighted
    u = torch.from_numpy(np.random.default_rng(1).random(1 << 18,
                                                         np.float32))
    xs, w = flt.sample_filter_offset(table, u)
    xs, w = xs.numpy(), w.numpy()
    assert (w < 0).any()
    np.testing.assert_allclose(w.mean(), 1.0, atol=5e-3)
    hist, edges = np.histogram(xs, bins=40, range=(-radius, radius),
                               weights=w)
    hist = hist / (len(xs) * (edges[1] - edges[0]))
    centers = 0.5 * (edges[:-1] + edges[1:])
    f = flt.eval_filter_1d(flt.MITCHELL, radius, centers)
    xs_fine = np.linspace(-radius, radius, 4096)
    f_norm = flt._trapezoid(
        flt.eval_filter_1d(flt.MITCHELL, radius, xs_fine), xs_fine)
    f = f / f_norm
    assert (f < 0).any()
    np.testing.assert_allclose(hist, f, atol=0.02)


def test_unknown_filter_kind_raises():
    with pytest.raises(ValueError, match="filter kind"):
        flt.filter_table(("hann", 1.0))
