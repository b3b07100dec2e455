"""The program's spans and lane counters in a traced stretch.

``pbrs_tpu_torch.profiling`` names the stages of a render with
``pbrs.*`` spans (``torch.profiler.record_function``: ``user_annotation``
events on the host's clock, the device's kernels, copies and fills on the
same one) and counts each bounce's live and launched lanes. ``reduce``
turns a trace's events into, for each span name:

- count, host_s (wall time summed) and self_s (less what its child spans
  cover);
- dev_s / dev_ops: the device seconds and op count of the kernels, copies
  and fills it caused itself. An op belongs to the innermost ``pbrs.*``
  span open, on the launching thread, at the CUDA API call that launched
  it, matched by the trace's ``correlation`` id; ops launched outside
  every span go to ``OUTSIDE``;
- dev_s_in / dev_ops_in: the same with its child spans' ops included.

``readings`` divides them into the per-pass numbers below. The benchmark's
own profiler window (``trace.Window``) does not turn the recorder on, so
the cells' result lines do not carry them yet; this module's tool does,
over the same traced stretch of the same loops:

    python3 -m portbench.spans --workload interior_1080p_d8.final \\
        --seed 7 --seconds 30

It runs the cell as ``--trace 1`` does, with a window that turns the
recorder on at its start and reads the counters at its close, and prints
one JSON line: the readings, the spans (ranks summed), the lanes, the
cell's per-layer metrics and checks, and two checks of coverage, also on
standard error: the share of the stretch's idle time that no host event
names (``host: no profiled op (Python)``) and the share of the
``pbrs.pass`` wall its child spans cover.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field, fields

from portbench import trace
from portbench.loops.sharded_frames import rank_main as _rank_main
from portbench.trace import TraceSummary, Window

PREFIX = "pbrs."
OUTSIDE = "(outside every pbrs span)"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
FIELDS = ("count", "host_s", "self_s", "dev_s", "dev_ops", "dev_s_in",
          "dev_ops_in")


def _row():
    return dict.fromkeys(FIELDS, 0)


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def reduce(events) -> dict:
    """{span name: {FIELDS}} over the trace's ``pbrs.*`` spans; OUTSIDE
    holds the device ops no span caused."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)]
    launch = {}  # correlation -> (tid, ts) of the launching call
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and \
                _corr(e) is not None:
            launch[_corr(e)] = (e.get("tid"), float(e["ts"]))
    # Each device op at the launching call's thread and time.
    queries = {}
    outside = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        at = launch.get(_corr(e))
        sec = float(e.get("dur", 0.0)) * 1e-6
        if at is None:
            outside.append(sec)
        else:
            queries.setdefault(at[0], []).append((at[1], sec))
    out = {}
    by_tid = {}
    for e in spans:
        by_tid.setdefault(e.get("tid"), []).append(e)
    for tid in set(by_tid) | set(queries):
        outside += _sweep(by_tid.get(tid, []), queries.get(tid, []), out)
    if outside:
        row = out.setdefault(OUTSIDE, _row())
        row["dev_s"] = row["dev_s_in"] = sum(outside)
        row["dev_ops"] = row["dev_ops_in"] = len(outside)
    return out


def _sweep(spans, queries, out) -> list:
    """Add one thread's spans, and the device ops launched on it, to
    `out`; returns the seconds of the ops no span holds. Spans on one
    thread nest, so the open ones form a stack whose top is the innermost:
    a span starting opens a child of the top; an op launched lands on the
    top, and on every name in the stack for the inclusive sums."""
    items = [(float(e["ts"]), 0, -float(e.get("dur", 0.0)), i)
             for i, e in enumerate(spans)]
    items += [(ts, 1, 0.0, sec) for ts, sec in queries]
    items.sort()
    covered = [0.0] * len(spans)
    stack = []  # (end, span index)
    unheld = []
    for t, kind, neg_dur, x in items:
        while stack and stack[-1][0] < t:
            stack.pop()
        if kind == 0:
            end = t - neg_dur
            if stack:
                top_end, top = stack[-1]
                covered[top] += min(end, top_end) - t
            stack.append((end, x))
            continue
        if not stack:
            unheld.append(x)
            continue
        names = {spans[i]["name"] for _, i in stack}
        inner = out.setdefault(spans[stack[-1][1]]["name"], _row())
        inner["dev_s"] += x
        inner["dev_ops"] += 1
        for name in names:
            row = out.setdefault(name, _row())
            row["dev_s_in"] += x
            row["dev_ops_in"] += 1
    for i, e in enumerate(spans):
        dur = float(e.get("dur", 0.0)) * 1e-6
        row = out.setdefault(e["name"], _row())
        row["count"] += 1
        row["host_s"] += dur
        row["self_s"] += dur - covered[i] * 1e-6
    return unheld


def merge(parts) -> dict:
    """Several ranks' ``reduce`` results, every field summed."""
    out = {}
    for part in parts:
        for name, row in part.items():
            acc = out.setdefault(name, _row())
            for k in FIELDS:
                acc[k] += row[k]
    return out


def readings(spans: dict, lanes: dict, passes: int, window_s: float,
             ranks: int) -> dict:
    """The per-pass numbers of a traced stretch of `passes` passes (summed
    over ranks), a name each; None where the stretch holds nothing to read
    (no device ops on the CPU, no all_reduce on one rank):

    - raygen_ms_per_pass: ``pbrs.camera_rays`` host wall;
    - bounce_self_ms_per_pass: ``pbrs.bounce`` self wall, its trace spans
      left out;
    - trace_host_ms_per_pass: ``pbrs.trace`` + ``pbrs.occlude`` host wall;
    - launches_per_pass: device ops caused inside ``pbrs.pass``;
    - live_lane_share: live over launched lane-bounces, in percent;
    - all_reduce_share: device time caused inside ``pbrs.all_reduce``
      over the window times the ranks, in percent."""
    def get(name, key):
        row = spans.get(PREFIX + name)
        return None if row is None or not row["count"] else row[key]

    def per_pass_ms(*values):
        got = [v for v in values if v is not None]
        return 1e3 * sum(got) / passes if got and passes > 0 else None

    ops = get("pass", "dev_ops_in")
    ar = get("all_reduce", "dev_s_in")
    return {
        "raygen_ms_per_pass": per_pass_ms(get("camera_rays", "host_s")),
        "bounce_self_ms_per_pass": per_pass_ms(get("bounce", "self_s")),
        "trace_host_ms_per_pass": per_pass_ms(get("trace", "host_s"),
                                              get("occlude", "host_s")),
        "launches_per_pass": (ops / passes if ops and passes > 0 else None),
        "live_lane_share": (100.0 * lanes["live"] / lanes["launched"]
                            if lanes.get("launched") else None),
        "all_reduce_share": (100.0 * ar / (window_s * ranks)
                             if ar and window_s > 0 else None),
    }


def coverage(summary) -> dict:
    """The two checks of what the spans name: the share of the stretch's
    idle time in gaps no host event covers, and the share of the
    ``pbrs.pass`` wall that its child spans cover, both in percent."""
    idle = sum(summary.idle_gaps.values())
    p = summary.spans.get(PREFIX + "pass")
    return {
        "unnamed_idle_share": (100.0 * summary.idle_gaps.get(trace.NO_OP, 0.0)
                               / idle if idle > 0 else None),
        "pass_child_share": (100.0 * (1.0 - p["self_s"] / p["host_s"])
                             if p and p["host_s"] > 0 else None),
        "pass_self_ms": (1e3 * p["self_s"] / p["count"]
                         if p and p["count"] else None),
    }


def _base(summary) -> dict:
    """The fields of trace.TraceSummary."""
    return {f.name: getattr(summary, f.name) for f in fields(TraceSummary)}


@dataclass
class SpanSummary(TraceSummary):
    """A window's summary with its spans and lane counters."""
    spans: dict = field(default_factory=dict)
    lanes: dict = field(default_factory=dict)

    @staticmethod
    def merge(parts):
        base = TraceSummary.merge(parts)
        lanes = {}
        for p in parts:
            for k, v in p.lanes.items():
                lanes[k] = lanes.get(k, 0) + v
        return SpanSummary(**_base(base), spans=merge(p.spans for p in parts),
                           lanes=lanes)


class SpanWindow(Window):
    """The benchmark's profiler window with the program's recorder on
    inside it: the same synchronised start and close, the counters read
    at the close, and the spans reduced beside the trace's summary."""

    def start(self):
        from pbrs_tpu_torch import profiling

        super().start()
        profiling.recording(True)

    def close(self):
        from pbrs_tpu_torch import profiling

        super().close()
        self.lanes = profiling.counters()
        profiling.recording(False)

    def summary(self) -> SpanSummary:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.closed = False
        base = trace.summarize(events, self.window_s)
        return SpanSummary(**_base(base), spans=reduce(events),
                           lanes=self.lanes)


def _span_rank_main(dev, spec):
    """sharded_frames' rank body with SpanWindow as its profiler window
    (a spawned rank imports this module afresh)."""
    trace.Window = SpanWindow
    return _rank_main(dev, spec)


def run_traced(cell, seed: int, seconds: float, device: str, t0: float):
    """The cell's loop with --trace 1 and SpanWindow: its RunRecord, whose
    trace is a SpanSummary (ranks merged)."""
    from portbench.loops import sharded_frames

    loop = importlib.import_module(f"portbench.loops.{cell.traffic['loop']}")
    from portbench import harness

    saved = (trace.Window, trace.TraceSummary, sharded_frames.rank_main)
    trace.Window, trace.TraceSummary = SpanWindow, SpanSummary
    sharded_frames.rank_main = _span_rank_main
    try:
        ctx = harness.Ctx(cell=cell, seed=int(seed), seconds=float(seconds),
                          trace=True, device=device, t0=t0)
        return loop.run(ctx)
    finally:
        trace.Window, trace.TraceSummary, sharded_frames.rank_main = saved


def report(cell, rec) -> dict:
    """The JSON line of a traced run: readings, spans, lanes, coverage,
    the cell's per-layer metrics and its checks."""
    from portbench import harness

    tr = rec.trace
    out = {"workload": cell.name, "passes": rec.profiled_passes,
           "ranks": rec.ranks}
    if tr is None:
        return out
    out["readings"] = readings(tr.spans, tr.lanes, rec.profiled_passes,
                               tr.window_s, rec.ranks)
    out["coverage"] = coverage(tr)
    out["lanes"] = tr.lanes
    out["spans"] = tr.spans
    out["reference_live_share"] = (
        100.0 * sum(rec.live_per_bounce) / len(rec.live_per_bounce)
        if rec.live_per_bounce else None)
    out["metrics"] = {m["name"]: harness._load_reader(cell.root, m["name"])
                      .read(rec, cell) for m in cell.per_layer}
    out["breakdown"] = tr.breakdown()
    out["device"] = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                     "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in rec.checks.items()}
    return out


def main(argv=None) -> int:
    t0 = time.time()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    harness.cache_env(cell.root)
    rec = run_traced(cell, args.seed, args.seconds, args.device, t0)
    out = report(cell, rec)
    for k, v in out.get("coverage", {}).items():
        print(f"coverage {k}: {v!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
