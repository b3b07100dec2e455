"""setup_s: process start to the first timed call (imports, the scene,
the kernels built on a checkout's first run, the warm-up pass)."""


def read(rec, cell):
    return rec.setup_s
