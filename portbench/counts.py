"""Roofline counts: the least time one H100 needs for a kernel's work.

A kernel's work is counted from the launch's sizes and the estimator's
own counts, never from what an implementation reads again: each
``kernels/<kernel>.json`` gives the bytes a unit of work reads and writes
once, and the unit:

- ``lane_bounce``: a lane at a bounce. A lane alive as the bounce begins
  moves ``bytes``; a dead one only its alive flag in and out
  (``dead_bytes``). The share of the frame's lanes alive at each bounce is
  the estimator's, counted by the plain reference over every pass at the
  check pixels (``RunRecord.live_per_bounce``).
- ``traced_ray``: a traced segment, the estimator's traced-ray count
  (``RenderStats.traced_rays``) a pass.

No operation is counted: a primitive test or a node visit is a kernel's
own sweep or walk, so each bound is its bytes over the peak bandwidth.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3), 3.35 TB/s and
67 TFLOP/s in float32 outside the tensor cores, at its 700 W limit.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12


class NoKernelTime(RuntimeError):
    """The trace holds no device time for a kernel a cell's roofline names."""


def kernel(root: Path, name: str) -> dict:
    with open(Path(root) / "portbench" / "kernels" / f"{name}.json") as f:
        return json.load(f)


def bound_s(n_bytes: float, flops: float = 0.0) -> float:
    return max(n_bytes / PEAK_BYTES_S, flops / PEAK_FLOPS)


def work_bytes(k: dict, lanes: int, live_per_bounce, passes: int,
               rays_per_pass: int) -> float:
    """Bytes the kernel's work over `passes` passes needs read and written
    once: each bounce's live and dead lanes, or the traced rays a pass."""
    if k["per"] == "lane_bounce":
        per_lane = sum(f * k["bytes"] + (1.0 - f) * k["dead_bytes"]
                       for f in live_per_bounce)
        return float(per_lane) * lanes * passes
    if k["per"] == "traced_ray":
        return float(k["bytes"]) * rays_per_pass * passes
    raise ValueError(f"no count per {k['per']!r}")


def roofline_pct(rec, root: Path, name: str):
    """The kernel's bound time over its device time in the traced stretch,
    in percent; None without a traced stretch. A stretch that holds none
    of the kernel's time raises NoKernelTime: the kernel was renamed, or
    its work left the path, and its roofline must not go silent."""
    k = kernel(root, name)
    if rec.trace is None or rec.profiled_passes <= 0:
        return None
    t = rec.trace.device_s(k["names"])
    if t <= 0.0:
        raise NoKernelTime(f"the trace holds no device time for {name}'s "
                           f"kernels {k['names']}")
    b = work_bytes(k, rec.frame_lanes, rec.live_per_bounce,
                   rec.profiled_passes, rec.rays_per_pass)
    return 100.0 * bound_s(b) / t
