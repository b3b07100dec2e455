"""The gather-matmul probe's plain version (pbrs_tpu_torch/tools/
prof_rounds.py:mm_reference) against jax.lax.dot_general on the same bf16
operands, with mm_kernel's precision (Precision.DEFAULT) and f32 result,
accumulated as mm_kernel's fori_loop accumulates.

tools/_prof_rounds.py itself is not imported: it runs chip code (and
tools/_chip_health.py's check of the chip) when it is imported, so the
body of its mm_kernel is written out here.

The mask is 1 on 1% of its entries, so every output is a sum of a few
bf16 table entries: exact in float32 in either order, and the two must be
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrs_tpu_torch.tools import prof_rounds as pr
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

REPS = 3


def _mm_kernel_body(tab, mask, reps):
    """tools/_prof_rounds.py:mm_kernel's loop on plain arrays."""
    acc = jnp.zeros((tab.shape[0], mask.shape[1]), jnp.float32)

    def body(i, acc):
        g = jax.lax.dot_general(
            tab, mask, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32)
        return acc + g

    return jax.lax.fori_loop(0, reps, body, acc)


def test_plain_probe_matches_dot_general():
    tab, mask = pr.probe_operands(seed=0)
    assert tab.shape == (pr.ROWS3, pr.K) and mask.shape == (pr.K, pr.COLS)
    assert tab.dtype == mask.dtype == torch.bfloat16
    share = float(mask.float().mean())
    assert 0.005 < share < 0.015  # a 1% mask
    want = _mm_kernel_body(jnp.asarray(tab.float().numpy(), jnp.bfloat16),
                           jnp.asarray(mask.float().numpy(), jnp.bfloat16),
                           REPS)
    got = pr.mm_probe(tab, mask, REPS)  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (pr.ROWS3, pr.COLS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # reps products, not one: each rep adds the product once more.
    one = pr.mm_reference(tab, mask, 1)
    np.testing.assert_array_equal(got.numpy(), (REPS * one).numpy())


def test_probe_bound_and_cuda_only_launch():
    ms, by = pr.bound_ms(pr.ROWS3, pr.COLS, 400)
    # 2 * 1728 * 128 * 1024 * 400 flops over the dense bf16 peak.
    assert by == "operations"
    assert ms == pytest.approx(2 * 1728 * 128 * 1024 * 400 / 989e12 * 1e3)
    tab, mask = pr.probe_operands(seed=1, rows=64, cols=64)
    assert pr.mm_probe(tab, mask, 0).abs().max() == 0
    # A CPU tensor never reaches the kernel: a bad CUDA call raises.
    with pytest.raises(ValueError, match="CUDA bf16"):
        pr.mm_probe(tab.float().to("meta"), mask, 1)
