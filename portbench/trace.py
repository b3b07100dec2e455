"""The benchmark's own torch.profiler window and its reduction.

``Window.start()`` / ``Window.close()`` bracket a stretch of passes, each
after a synchronise so that the device's queue is empty at both ends. The
window's Chrome trace goes to a temporary file under TMPDIR, is read and
deleted. ``summarize`` reduces its events to what the metrics read:

- busy_s: the union of the device's activity intervals (kernels, copies,
  fills) in seconds; window_s: the window's length on the host's clock;
- device ops: device seconds summed by the profiler's name;
- idle gaps: each stretch of the window in which the device ran nothing,
  named by the innermost host event running at its midpoint (a torch op
  or a CUDA runtime call), seconds summed by name.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NO_OP = "host: no profiled op (Python)"
TOP = 10
NAME_CHARS = 160  # a name's first characters (kernel signatures run long)


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: dict = field(default_factory=dict)  # name -> seconds
    idle_gaps: dict = field(default_factory=dict)  # name -> seconds

    def device_s(self, patterns) -> float:
        """Device seconds of the ops whose name holds any of `patterns`."""
        return sum(s for name, s in self.device_ops.items()
                   if any(p in name for p in patterns))

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_ops),
                "idle_gaps": top(self.idle_gaps)}

    @staticmethod
    def merge(parts):
        """Several ranks' windows: busy_s and window_s averaged, device
        ops and idle gaps summed."""
        n = len(parts)
        ops, gaps = {}, {}
        for p in parts:
            for k, v in p.device_ops.items():
                ops[k] = ops.get(k, 0.0) + v
            for k, v in p.idle_gaps.items():
                gaps[k] = gaps.get(k, 0.0) + v
        return TraceSummary(busy_s=sum(p.busy_s for p in parts) / n,
                            window_s=sum(p.window_s for p in parts) / n,
                            device_ops=ops, idle_gaps=gaps)


def _spans(events, cats):
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", "?")[:NAME_CHARS]) for e in events
            if e.get("ph") == "X" and e.get("cat") in cats]


def _union(spans):
    """Disjoint [start, end] intervals covering the spans, sorted."""
    out = []
    for a, b, _ in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _name_gaps(gaps, host):
    """{name: us}: each gap named by the innermost host span covering its
    midpoint (the one that started last among those still running)."""
    host = sorted(host)
    out = {}
    active = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = max(active, key=lambda h: h[0])[2] if active else NO_OP
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def summarize(events, window_s: float) -> TraceSummary:
    dev = _spans(events, DEVICE_CATS)
    host = _spans(events, HOST_CATS)
    busy = _union(dev)
    ops = {}
    for a, b, name in dev:
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
    every = dev + host
    gaps = []
    if every:
        lo = min(s[0] for s in every)
        hi = max(s[1] for s in every)
        t = lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
    idle = {k: v * 1e-6 for k, v in _name_gaps(gaps, host).items()}
    return TraceSummary(busy_s=sum(b - a for a, b in busy) * 1e-6,
                        window_s=window_s, device_ops=ops, idle_gaps=idle)


def warm_up(device):
    """Start and stop the profiler once, so that its tracer's first start
    (seconds of set-up on the card) falls outside the measured window."""
    import torch

    w = Window(device)
    w.start()
    torch.ones(8, device=w.device).sum()
    w.stop()


class Window:
    """A torch.profiler window over the host's ops and, on the card, the
    device's activity. ``close()`` only stops the profiler (its events are
    not parsed into Python objects there, as ``acc_events`` would: 25 s
    on the interior's route), so a loop can go on rendering at once;
    ``summary()`` exports and reduces the trace (seconds on a busy route),
    once the measured window is over."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self.prof = None
        self.t = 0.0
        self.window_s = 0.0
        self.closed = False

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t = time.perf_counter()
        self.closed = False

    @property
    def running(self) -> bool:
        return self.prof is not None and not self.closed

    def close(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self.t
        self.prof.stop()
        self.closed = True

    def summary(self) -> TraceSummary:
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
        return summarize(events, self.window_s)

    def stop(self) -> TraceSummary:
        self.close()
        return self.summary()
