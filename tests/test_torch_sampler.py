"""The port's PCG sampler is bit-identical to pbrs_tpu's, including the
in-kernel draw of the fused bounce."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import fused_kernel as jfk
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu_torch.core import sampler as tsmp

SEEDS = (0, 7, 2**31 + 5, 2**32 - 1)


def _counters(seed, n=4096):
    """numpy-seeded uint32 counters, a quarter of them >= 2^31."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    c[: n // 4] |= np.uint64(1 << 31)
    return c.astype(np.uint32)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_u32_bit_identical(seed):
    a, b, c = _counters(seed), _counters(seed + 1), _counters(seed + 2)
    want = np.asarray(jsmp.hash_u32(jnp.uint32(seed), _j(a), _j(b), _j(c), 3))
    got = tsmp.hash_u32(seed, _t(a), _t(b), _t(c), 3).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2**32


@pytest.mark.parametrize("seed", SEEDS)
def test_u1_u2_bit_identical(seed):
    pix = _counters(seed + 10)
    js, ts = jsmp.PCGSampler(seed), tsmp.PCGSampler(seed)
    big = _counters(seed + 11)  # per-lane sample ids, a quarter >= 2^31
    for s_t, s_j in ((0, 0), (5, 5), (_t(big), _j(big))):
        for bounce, dim in ((0, jsmp.DIM_CAMERA_JITTER),
                            (3, jsmp.DIM_BSDF_UV),
                            (7, jsmp.DIM_RUSSIAN_ROULETTE)):
            np.testing.assert_array_equal(
                ts.u2(_t(pix), s_t, bounce, dim).numpy(),
                np.asarray(js.u2(_j(pix), s_j, bounce, dim)))
            np.testing.assert_array_equal(
                ts.u1(_t(pix), s_t, bounce, dim, lane=1).numpy(),
                np.asarray(js.u1(_j(pix), s_j, bounce, dim, lane=1)))


@pytest.mark.parametrize("seed", SEEDS)
def test_matches_in_kernel_pcg_draw(seed):
    pix = _counters(seed + 20).astype(np.int64) % (1 << 31)
    smp_id = np.random.default_rng(seed).integers(0, 64, size=pix.shape[0])
    for bounce in (0, 4):
        for dim in (jsmp.DIM_LIGHT_SELECT, jsmp.DIM_SCATTER_UV):
            for lane in (0, 1):
                want = np.asarray(jfk._u1(
                    jnp.uint32(seed), jnp.asarray(pix, jnp.int32),
                    jnp.asarray(smp_id, jnp.int32), bounce, dim, lane,
                    rng="pcg"))
                got = tsmp.PCGSampler(seed).u1(
                    _t(pix), _t(smp_id), bounce, dim, lane)
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sample", [0, 3, 9, "tensor"])
def test_stratified_jitter_bit_identical(sample):
    pix = np.arange(500, dtype=np.int32)
    if sample == "tensor":
        s = np.random.default_rng(1).integers(0, 12, size=500).astype(np.int32)
        sj, st = _j(s), _t(s)
    else:
        sj = st = sample
    js, ts = jsmp.PCGSampler(3), tsmp.PCGSampler(3)
    want = jsmp.stratified_jitter(js, _j(pix), sj, 3)
    got = tsmp.stratified_jitter(ts, _t(pix), st, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
