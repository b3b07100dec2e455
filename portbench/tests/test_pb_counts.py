"""The roofline counts read the launch's sizes and the estimator's counts
(lanes alive at each bounce, traced rays) only: how an implementation
splits the work into launches, or what else the trace holds, does not
move them; a trace without the kernel fails."""

from __future__ import annotations

import pytest

from portbench import counts
from portbench.harness import RunRecord
from portbench.trace import TraceSummary
from portbench.tests import tiny

ROOT = tiny.REPO


LIVE = [1.0, 0.9, 0.8, 0.7, 0.3, 0.02, 0.01, 0.005]


def _rec(ops, passes=10, lanes=1 << 20, live=LIVE, rays=3_000_000):
    return RunRecord(trace=TraceSummary(busy_s=1.0, window_s=2.0,
                                        device_ops=ops),
                     profiled_passes=passes, frame_lanes=lanes,
                     live_per_bounce=list(live), rays_per_pass=rays)


def _lane_bytes(k, live, lanes, passes):
    return sum(f * k["bytes"] + (1 - f) * k["dead_bytes"]
               for f in live) * lanes * passes


@pytest.mark.parametrize("name", ["k2", "k4"])
def test_lane_bounce_count_is_sizes_and_live_lanes_only(name):
    k = counts.kernel(ROOT, name)
    b = counts.work_bytes(k, 1 << 20, LIVE, 10, rays_per_pass=123)
    assert b == pytest.approx(_lane_bytes(k, LIVE, 1 << 20, 10))
    assert counts.work_bytes(k, 1 << 20, LIVE, 10, rays_per_pass=999) == b
    assert counts.work_bytes(k, 2 << 20, LIVE, 10, 0) == pytest.approx(2 * b)
    assert counts.work_bytes(k, 1 << 20, LIVE, 20, 0) == pytest.approx(2 * b)


@pytest.mark.parametrize("name", ["k2", "k4"])
def test_dead_lanes_move_only_their_flags(name):
    k = counts.kernel(ROOT, name)
    every = counts.work_bytes(k, 1000, [1.0] * 8, 1, 0)
    assert every == k["bytes"] * 1000 * 8
    first = counts.work_bytes(k, 1000, [1.0] + [0.0] * 7, 1, 0)
    assert first == (k["bytes"] + 7 * k["dead_bytes"]) * 1000
    assert k["dead_bytes"] == 8 and k["bytes"] > 10 * k["dead_bytes"]


def test_trace_count_is_rays_only():
    k = counts.kernel(ROOT, "trace")
    b = counts.work_bytes(k, 1 << 20, LIVE, 10, rays_per_pass=3_000_000)
    assert b == 40 * 3_000_000 * 10
    assert counts.work_bytes(k, 7, [1.0], 10, rays_per_pass=3_000_000) == b


def test_roofline_ignores_how_launches_split():
    name = "pbrs::fused_bounce_kernel(float const*, int)"
    one = _rec({name: 0.02, "aten::add": 0.5})
    split = _rec({name + " v2": 0.01, name: 0.01, "other": 3.0})
    a = counts.roofline_pct(one, ROOT, "k2")
    assert a == pytest.approx(counts.roofline_pct(split, ROOT, "k2"))
    k = counts.kernel(ROOT, "k2")
    want = 100 * _lane_bytes(k, LIVE, 1 << 20, 10) / counts.PEAK_BYTES_S / 0.02
    assert a == pytest.approx(want)


def test_roofline_sums_k1_and_k5():
    rec = _rec({"pbrs::trace_flat_kernel": 0.03,
                "void pbrs::trace_bvh_kernel<2, false>": 0.01})
    got = counts.roofline_pct(rec, ROOT, "trace")
    assert got == pytest.approx(100 * 40 * 3e7 / counts.PEAK_BYTES_S / 0.04)


def test_no_kernel_time_fails_loudly():
    with pytest.raises(counts.NoKernelTime, match="fused_wave_kernel"):
        counts.roofline_pct(_rec({"aten::mul": 1.0}), ROOT, "k4")


def test_no_traced_stretch_reads_nothing():
    assert counts.roofline_pct(RunRecord(), ROOT, "k2") is None


def test_bound_takes_the_larger():
    assert counts.bound_s(3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
