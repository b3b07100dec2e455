"""The comparison that decides ``correct``.

The film that the timed calls produced is read at K pixels drawn from the
seed, and each pixel's sum over the passes the film holds is recomputed by
the plain reference (``reference/render.py``). The number compared,
``film_rel_l1``, is the sum of |program - reference| over those pixels and
channels divided by the sum of |reference|. Its limit is the
configuration's (``check.limit``), set from the program's readings over a
dozen seeds and more and from the control's (the reference with its rays
held in bfloat16); ``PERF.md`` gives both.
"""

from __future__ import annotations

import numpy as np

NAME = "film_rel_l1"


def check_pixels(seed: int, n_pixels: int, k: int) -> np.ndarray:
    """K distinct pixel ids of the frame, drawn from the seed, sorted."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    k = min(int(k), int(n_pixels))
    return np.sort(rng.choice(int(n_pixels), size=k, replace=False))


def rel_l1(program, reference) -> float:
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    den = float(np.abs(reference).sum())
    num = float(np.abs(program - reference).sum())
    if not np.isfinite(num):
        return float("inf")
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def limit(config: dict) -> float:
    return float(config["check"]["limit"][NAME])
