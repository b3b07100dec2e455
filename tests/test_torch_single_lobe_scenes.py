"""The K3 plain version and the port's general path against pbrs_tpu's
general wavefront on the two-lobe (plastic / default uber) and textured
(checker, Perlin marble, solid) scenes of tests/test_fused_single_lobe.py,
per lane, with equal ray counts."""

import pytest

from test_fused_single_lobe import _plastic_scene, _textured_scene
from test_torch_single_lobe import compare_with_general
import torch_threads  # noqa: F401  (one PyTorch thread a worker)


@pytest.mark.parametrize("make", [_plastic_scene, _textured_scene],
                         ids=["plastic/uber", "textured"])
def test_matches_general_path(make):
    compare_with_general(make(), depth=4)
