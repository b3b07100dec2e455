"""The benchmark of pbrs_tpu_torch, the PyTorch and CUDA path tracer.

    python3 -m portbench.run --workload cornell_1024_d8.final --seed 7 \\
        --seconds 10 --trace 0

``BENCHMARK.json`` at the checkout's root names the cells; each cell names
a configuration (``portbench/configs/<config>.json``: the scene, its sizes
and the pinned route) and a traffic mix (``portbench/traffic/<mix>.json``:
the loop kind and its parameters). A per-layer metric is a reader of its
own, ``portbench/metrics/<name>.py``; a kernel's name patterns and its
count of bytes a lane are ``portbench/kernels/<kernel>.json``. The harness
finds every one of them by the name ``BENCHMARK.json`` gives, so a new
cell, configuration, mix or metric is new files and entries only.

``portbench/reference/`` is the plain reference that decides ``correct``:
a frozen copy of the port's general path, scene loader and broadcast
trace, which imports nothing of ``pbrs_tpu_torch``.
"""
