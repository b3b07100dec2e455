"""The profiler window's reduction: busy time as a union, idle gaps named
by the innermost host event at their midpoint, ranks merged."""

from __future__ import annotations

import pytest
import torch

from portbench import trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _x("cpu_op", "aten::outer", 0, 100),
    _x("cpu_op", "aten::inner", 10, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 12, 2),
    _x("kernel", "k_a", 30, 20),
    _x("kernel", "k_b", 40, 20),  # overlaps k_a
    _x("gpu_memcpy", "Memcpy DtoH", 80, 5),
    _x("cpu_op", "aten::late", 60, 15),
    {"ph": "i", "name": "marker", "ts": 5},
]


def test_busy_is_the_union():
    s = trace.summarize(EVENTS, window_s=1.0)
    assert s.busy_s == pytest.approx((30 + 5) * 1e-6)
    assert s.device_ops == pytest.approx({"k_a": 20e-6, "k_b": 20e-6,
                                          "Memcpy DtoH": 5e-6})
    assert s.device_s(["k_"]) == pytest.approx(40e-6)


def test_gaps_named_by_the_innermost_host_event():
    s = trace.summarize(EVENTS, window_s=1.0)
    # Gaps: [0, 30] mid 15 (inner), [60, 80] mid 70 (late), [85, 100]
    # mid 92.5 (outer).
    assert s.idle_gaps == pytest.approx({"aten::inner": 30e-6,
                                         "aten::late": 20e-6,
                                         "aten::outer": 15e-6})
    b = s.breakdown()
    assert b["idle_gaps"][0] == ["aten::inner", pytest.approx(30e-6)]
    assert len(b["device_ops"]) == 3


def test_merge_averages_busy_and_sums_ops():
    a = trace.TraceSummary(1.0, 4.0, {"k": 1.0}, {"g": 2.0})
    b = trace.TraceSummary(3.0, 6.0, {"k": 2.0}, {"h": 1.0})
    m = trace.TraceSummary.merge([a, b])
    assert (m.busy_s, m.window_s) == (2.0, 5.0)
    assert m.device_ops == {"k": 3.0} and m.idle_gaps == {"g": 2.0, "h": 1.0}


def test_window_on_the_cpu_has_no_device_time():
    w = trace.Window("cpu")
    w.start()
    x = torch.ones(256, 256)
    for _ in range(5):
        x = x @ x / 256.0
    s = w.stop()
    assert s.busy_s == 0.0 and s.device_ops == {}
    assert s.window_s > 0.0 and sum(s.idle_gaps.values()) > 0.0
    assert not w.running
