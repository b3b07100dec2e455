"""The port's persistent wavefront (lane refill) against
pbrs_tpu.integrators.persistent on an 8^2 Cornell box (radiance and the
traced-ray count), against the port's masked wavefront at
tests/test_persistent.py's sizes (full and quarter pool, the ray count),
through the scene's tracers, and the loop's iteration count below its
cap."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.integrators import persistent as jpersistent
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch.accel import dispatch
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.integrators import persistent, wavefront
from pbrs_tpu_torch.scene import buffers
from test_fused_single_lobe import _shrunk
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ATOL, RTOL = 2e-5, 1e-4  # tests/test_fused.py:38
MASKED_TOL = 1e-5  # tests/test_persistent.py


def _cornell(size):
    jscene = _shrunk(jpresets.cornell_box(), size)
    return jscene, buffers.scene_from_arrays(buffers.scene_to_arrays(jscene))


def _tasks(n_pix, spp):
    """tests/test_persistent.py's task order: every pixel, sample by
    sample."""
    pix = np.tile(np.arange(n_pix, dtype=np.int32), spp)
    samp = np.repeat(np.arange(spp, dtype=np.int32), n_pix)
    return pix, samp


class Counting:
    """A trace function that counts its calls: one closest hit a loop
    iteration."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, rays):
        self.calls += 1
        return self.fn(rays)


def test_matches_reference_8x8():
    """128 tasks on a 32-lane pool, depth 4, PCG seed 3."""
    jscene, tscene = _cornell(8)
    pix, samp = _tasks(64, 2)
    want, want_count = jpersistent.render_tasks_persistent(
        jscene, jsmp.PCGSampler(3), jnp.asarray(pix), jnp.asarray(samp),
        n_lanes=32, max_depth=4, msaa=2, return_ray_count=True)
    got, count = persistent.render_tasks_persistent(
        tscene, tsmp.PCGSampler(3), torch.from_numpy(pix),
        torch.from_numpy(samp), n_lanes=32, max_depth=4, msaa=2,
        return_ray_count=True)
    assert got.shape == (128, 3) and count.dtype == torch.float32
    assert float(np.asarray(want).sum()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert float(count) == float(want_count)


@pytest.fixture(scope="module")
def cornell16():
    return _cornell(16)[1]


def _masked(scene, pix, samp, depth, seed):
    isect, occl = dispatch.make_trace_fns(scene, use_kernels=False)
    return wavefront.render_samples(
        scene, tsmp.PCGSampler(seed), torch.from_numpy(pix),
        torch.from_numpy(samp), isect, occl, max_depth=depth, msaa=2)


@pytest.mark.parametrize("n_lanes,depth", [(None, 5), (128, 6)],
                         ids=["full_pool", "quarter_pool"])
def test_matches_masked(cornell16, n_lanes, depth):
    """256 pixels x 2 samples on the full pool (depth 5) and on 128 lanes
    (depth 6), as tests/test_persistent.py."""
    pix, samp = _tasks(256, 2)
    want, _ = _masked(cornell16, pix, samp, depth, 3)
    got = persistent.render_tasks_persistent(
        cornell16, tsmp.PCGSampler(3), torch.from_numpy(pix),
        torch.from_numpy(samp), n_lanes=n_lanes, max_depth=depth, msaa=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=MASKED_TOL,
                               atol=MASKED_TOL)


def test_ray_count_not_higher(cornell16):
    """256 pixels x 4 samples, depth 8, on 256 lanes: refill traces no more
    than 1.01x the masked loop's segments."""
    pix, samp = _tasks(256, 4)
    _, masked_count = _masked(cornell16, pix, samp, 8, 0)
    _, count = persistent.render_tasks_persistent(
        cornell16, tsmp.PCGSampler(0), torch.from_numpy(pix),
        torch.from_numpy(samp), n_lanes=256, max_depth=8, msaa=2,
        return_ray_count=True)
    assert 0 < float(count) <= float(masked_count) * 1.01


@pytest.mark.parametrize("n_lanes", [512, 128, 32])
def test_iterations_below_cap(cornell16, n_lanes):
    """Through the scene's tracers (the trace kernels' plain versions
    here) the loop equals the broadcast sweep's. While tasks wait every
    lane is busy, so the loop ends within (n_tasks / n_lanes + 1) *
    max_depth iterations, far below its cap of n_tasks * max_depth + 2."""
    pix, samp = _tasks(256, 2)
    depth = 6
    isect, occl = dispatch.make_trace_fns(cornell16)
    counting = Counting(isect)
    got = persistent.render_tasks_persistent(
        cornell16, tsmp.PCGSampler(3), torch.from_numpy(pix),
        torch.from_numpy(samp), n_lanes=n_lanes, max_depth=depth, msaa=2,
        intersect_fn=counting, occlude_fn=occl)
    want = persistent.render_tasks_persistent(
        cornell16, tsmp.PCGSampler(3), torch.from_numpy(pix),
        torch.from_numpy(samp), n_lanes=n_lanes, max_depth=depth, msaa=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    n_tasks = pix.shape[0]
    waves = -(-n_tasks // min(n_lanes, n_tasks))
    assert depth <= counting.calls <= (waves + 1) * depth
    assert counting.calls < n_tasks * depth + 2
