"""The frozen reference against the port's general path on the CPU, at the
port's own per-lane tolerances (atol 2e-5, rtol 1e-4): a 24^2 Cornell
frame and a crop of the interior."""

from __future__ import annotations

import numpy as np
import torch

from portbench import scenes
from portbench.reference import render as ref
from portbench.tests import tiny

ATOL, RTOL = 2e-5, 1e-4


def _port_sums(config, pixels, n_samples, msaa):
    from pbrs_tpu_torch.accel import dispatch
    from pbrs_tpu_torch.core import sampler as smp
    from pbrs_tpu_torch.integrators import wavefront

    scene = scenes.build(config, tiny.REPO).to("cpu")
    isect_fn, occl_fn = dispatch.make_trace_fns(scene, use_kernels=False)
    pix = torch.as_tensor(pixels, dtype=torch.int32)
    acc = torch.zeros(len(pixels), 3)
    for s in range(n_samples):
        rad, _ = wavefront.render_samples(scene, smp.PCGSampler(77), pix, s,
                                          isect_fn, occl_fn,
                                          max_depth=config["max_depth"],
                                          msaa=msaa)
        acc = acc + rad
    return acc.numpy()


def _ref_sums(config, pixels, n_samples, msaa, ray_dtype=None):
    scene = scenes.reference_scene(config, tiny.REPO)
    return ref.film_sums(scene, 77, pixels, n_samples, config["max_depth"],
                         msaa, "cpu", ray_dtype=ray_dtype)


def test_cornell_24():
    cfg = tiny.tiny_config(width=24, height=24, max_depth=8)
    pixels = np.arange(24 * 24)
    got = _ref_sums(cfg, pixels, 4, 2)
    want = _port_sums(cfg, pixels, 4, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(want).sum() > 0


def test_interior_crop():
    cfg = dict(tiny.tiny_config("interior_1080p_d8"), width=1920,
               height=1080, max_depth=8)
    rows = np.arange(500, 508)[:, None] * 1920
    pixels = (rows + np.arange(940, 948)[None, :]).ravel()
    got = _ref_sums(cfg, pixels, 2, 32)
    want = _port_sums(cfg, pixels, 2, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(want).sum() > 0


def test_sample_blocks_do_not_change_the_sums():
    cfg = tiny.tiny_config(width=16, height=16, max_depth=4)
    scene = scenes.reference_scene(cfg, tiny.REPO)
    pixels = np.arange(0, 256, 3)
    one = ref.film_sums(scene, 5, pixels, 6, 4, 3, "cpu",
                        lane_block=len(pixels))
    many = ref.film_sums(scene, 5, pixels, 6, 4, 3, "cpu")
    np.testing.assert_array_equal(one, many)


def test_live_lanes_a_bounce():
    """The reference's count of lanes alive as each bounce begins, which
    the lane-bounce rooflines read: every camera lane at bounce 0, never
    more later, the same however the samples are blocked."""
    cfg = tiny.tiny_config(width=16, height=16, max_depth=6)
    scene = scenes.reference_scene(cfg, tiny.REPO)
    pixels = np.arange(0, 256, 2)
    one, many = [0] * 6, [0] * 6
    ref.film_sums(scene, 5, pixels, 4, 6, 2, "cpu", lane_block=len(pixels),
                  live=one)
    ref.film_sums(scene, 5, pixels, 4, 6, 2, "cpu", live=many)
    assert one == many
    assert one[0] == 4 * len(pixels)
    assert all(a >= b for a, b in zip(one, one[1:]))
    assert 0 < one[-1] < one[0]
