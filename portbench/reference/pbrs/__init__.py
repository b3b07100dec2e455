"""pbrs_tpu_torch — the pbrs_tpu wavefront path tracer on PyTorch and CUDA.

Mirrors ``pbrs_tpu/__init__.py``. The port keeps the JAX package's module
layout and names; each module's docstring names the ``pbrs_tpu`` file it
mirrors. Plain functions work on ``[N, 3]`` / ``[N]`` float32 tensors on
whatever device they are given. The two kernels of the Cornell main path
(the flat-table trace and the fused diffuse bounce) are hand-written CUDA
C++ under ``csrc/``; see ``kernels.py`` for how they are built.

This package imports torch and numpy only, never JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry flows through matmuls (the camera basis). A reduced-precision
# matmul moves a wall at x=554 to x=552 -- the reason the JAX package sets
# "highest" precision (pbrs_tpu/__init__.py:29-33). Keep true float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
