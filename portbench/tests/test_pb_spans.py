"""The program's spans in a traced stretch (portbench/spans.py): the
reduction on hand-made events (self time, each device op on the innermost
span open at its launching call, ranks merged), the trace's own summary
unchanged by span events, and the tool on tiny CPU cells of both loops."""

from __future__ import annotations

import json
import time

import pytest

from portbench import harness, spans, trace
from portbench.tests import tiny


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid, corr)


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, tid=7, corr=corr)


EVENTS = [
    _x("user_annotation", "pbrs.pass", 0, 100),
    _x("user_annotation", "pbrs.camera_rays", 5, 10),
    _launch(6, 1),
    _x("user_annotation", "pbrs.bounce", 20, 50),
    _x("cpu_op", "aten::mul", 21, 5),
    _launch(22, 2),
    _x("user_annotation", "pbrs.trace", 30, 20),
    _launch(31, 3),
    _x("cuda_driver", "cuLaunchKernel", 35, 1, corr=4),
    _launch(80, 5),  # in the pass, after the bounce: the accumulate
    _launch(120, 6),  # outside every span
    _x("user_annotation", "pbrs.trace", 5, 3, tid=2),  # another thread
    _launch(6, 7, tid=2),
    _kernel("k_ray", 10, 4, 1),
    _kernel("k_shade", 40, 6, 2),
    _kernel("k_trace", 50, 8, 3),
    _kernel("k_trace", 60, 8, 4),
    _x("gpu_memcpy", "Memcpy DtoH", 90, 2, tid=7, corr=5),
    _kernel("k_late", 125, 3, 6),
    _kernel("k_other", 126, 1, 7),
    _kernel("k_unmatched", 127, 1, 99),
    {"ph": "i", "name": "marker", "ts": 5},
]


def test_reduce_self_time_and_attribution():
    got = spans.reduce(EVENTS)
    us = 1e-6
    p, b, t = got["pbrs.pass"], got["pbrs.bounce"], got["pbrs.trace"]
    assert (p["count"], b["count"], t["count"]) == (1, 1, 2)
    assert p["host_s"] == pytest.approx(100 * us)
    # The pass less its camera rays and bounce; the bounce less its trace.
    assert p["self_s"] == pytest.approx(40 * us)
    assert b["self_s"] == pytest.approx(30 * us)
    assert t["host_s"] == t["self_s"] == pytest.approx(23 * us)
    # Innermost span at the launch: the copy on the pass, the shade kernel
    # on the bounce, both trace kernels (cudaLaunchKernel, cuLaunchKernel) on
    # the trace, thread 2's kernel on its own trace span.
    assert (p["dev_ops"], p["dev_s"]) == (1, pytest.approx(2 * us))
    assert (b["dev_ops"], b["dev_s"]) == (1, pytest.approx(6 * us))
    assert (t["dev_ops"], t["dev_s"]) == (3, pytest.approx(17 * us))
    assert got["pbrs.camera_rays"]["dev_ops"] == 1
    # Children included: everything launched inside the pass.
    assert (p["dev_ops_in"], p["dev_s_in"]) == (5, pytest.approx(28 * us))
    assert b["dev_ops_in"] == 3
    assert got[spans.OUTSIDE]["dev_ops"] == 2  # k_late and the unmatched


def test_merge_sums_ranks():
    a = spans.reduce(EVENTS)
    m = spans.merge([a, a])
    for name, row in a.items():
        for k in spans.FIELDS:
            assert m[name][k] == pytest.approx(2 * row[k])
    s = spans.SpanSummary(1.0, 4.0, {"k": 1.0}, {}, spans=a,
                          lanes={"live": 3, "launched": 8})
    both = spans.SpanSummary.merge([s, s])
    assert (both.busy_s, both.window_s, both.device_ops) == (1.0, 4.0,
                                                             {"k": 2.0})
    assert both.lanes == {"live": 6, "launched": 16}
    assert both.spans["pbrs.pass"]["count"] == 2


def test_span_events_leave_the_summary_unchanged():
    """busy_s, window_s and device_ops read the same with and without the
    spans; only idle gaps in Python time inside a stage take its name."""
    bare = [e for e in EVENTS if e.get("cat") != "user_annotation"]
    with_spans = trace.summarize(EVENTS, window_s=1.0)
    without = trace.summarize(bare, window_s=1.0)
    assert with_spans.busy_s == without.busy_s
    assert with_spans.window_s == without.window_s
    assert with_spans.device_ops == without.device_ops
    assert with_spans.idle_gaps.get(trace.NO_OP, 0.0) < \
        without.idle_gaps[trace.NO_OP]
    assert any(k.startswith("pbrs.") for k in with_spans.idle_gaps)


def test_readings_per_pass():
    a = spans.reduce(EVENTS)
    r = spans.readings(a, {"live": 30, "launched": 40}, passes=2,
                       window_s=1e-3, ranks=1)
    assert r["raygen_ms_per_pass"] == pytest.approx(10e-3 / 2)
    assert r["bounce_self_ms_per_pass"] == pytest.approx(30e-3 / 2)
    assert r["trace_host_ms_per_pass"] == pytest.approx(23e-3 / 2)
    assert r["launches_per_pass"] == 2.5
    assert r["live_lane_share"] == 75.0
    assert r["all_reduce_share"] is None
    ar = {"pbrs.all_reduce": dict(spans._row(), count=1, dev_s_in=2e-4)}
    assert spans.readings(ar, {}, 1, 1e-3, 2)["all_reduce_share"] == \
        pytest.approx(10.0)


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path)


def test_tool_on_a_tiny_final_frame(root):
    mix = json.loads((root / "portbench/traffic/final.json").read_text())
    mix.update(profile_after_seconds=0.1, profile_min_passes=1,
               profile_seconds=0.2)
    name = tiny.add_cell(root, "tiny_cornell",
                         tiny.tiny_config(frame_spp=4096), "final_quick",
                         traffic_file=mix)
    cell = harness.load_cell(name, root)
    rec = spans.run_traced(cell, 2**31 + 31, 1.5, "cpu", time.time())
    assert trace.Window is not spans.SpanWindow  # put back
    out = spans.report(cell, rec)
    r = out["readings"]
    for k in ("raygen_ms_per_pass", "bounce_self_ms_per_pass",
              "trace_host_ms_per_pass", "live_lane_share"):
        assert r[k] is not None and r[k] > 0, k
    # No device on the CPU, one rank.
    assert r["launches_per_pass"] is None and r["all_reduce_share"] is None
    assert out["spans"]["pbrs.pass"]["count"] == rec.profiled_passes
    assert out["coverage"]["pass_child_share"] > 80.0
    assert out["lanes"]["launched"] == (rec.profiled_passes * 16 * 16
                                        * cell.config["max_depth"])
    assert out["checks"]["film_rel_l1"]["value"] <= 1e-6
    json.dumps(out)


def test_tool_on_a_tiny_sharded_cell(root):
    cfg = tiny.tiny_config("interior_1080p_sp4", frame_spp=4,
                           layout={"dp": 1, "sp": 2}, chips=2,
                           scene=tiny.tiny_config()["scene"])
    mix = json.loads((root / "portbench/traffic/frames16.json").read_text())
    mix["profile_after_frames"] = 0
    cell = harness.load_cell(tiny.add_cell(root, "tiny_sp2", cfg,
                                           "frames_now", chips=2,
                                           traffic_file=mix), root)
    rec = spans.run_traced(cell, 23, 0.5, "cpu", time.time())
    s = rec.trace.spans
    # One batch of 2 sample indices over sp 2: a pass and an all_reduce a
    # rank, summed over the ranks.
    assert rec.profiled_passes == 2
    assert s["pbrs.pass"]["count"] == 2 and s["pbrs.all_reduce"]["count"] == 2
    assert s["pbrs.bounce"]["count"] == 2 * cfg["max_depth"]
    assert rec.trace.lanes["launched"] == 2 * 16 * 16 * cfg["max_depth"]
    assert spans.report(cell, rec)["readings"]["live_lane_share"] > 0
