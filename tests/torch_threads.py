"""One PyTorch intra-op thread in each pytest-xdist worker.

Under pytest-xdist the tests run in several worker processes on the
machine's cores; each PyTorch process would otherwise start a thread pool
as wide as the machine, and the pools oversubscribe the cores (a large
eager op then runs many times slower than alone, and slows the JAX tests
of the other workers too). Run alone (no xdist worker), PyTorch keeps its default pool.
Every port test module imports this module.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
