"""One final frame, preempted at the deadline (a closed loop, one client).

Set-up builds the scene, moves it to the card and renders one pass of the
frame through the same route (``render_image(spp=1)``): that builds the
kernels and the host BVH builder on a checkout's first run and warms
every shape the window uses, and its traced rays are the rays a pass.

The window is one ``render_image`` call of the configuration's frame spp,
on a film of the harness's own (``PassFilm``, which notes each pass as
the render loop commits it), with a checkpoint path under TMPDIR. At
``--seconds`` the harness sends its own process SIGTERM: the program's
preemption finishes the pass it is on, saves the film and raises
KeyboardInterrupt. The window runs from the call to that return, and
counts every pass the film holds: samples_done x the frame's pixels.

With --trace 1 a torch.profiler window (``trace.Window``, its tracer
started once in set-up) opens at the first pass boundary
``profile_after_seconds`` into the window with ``profile_after_passes``
or more passes done, and closes at the first boundary ``profile_seconds``
later with ``profile_min_passes`` or more passes in it. Its trace is
exported and reduced once the window is over, so the passes after it
render at their own pace.

Then, with the program's state freed, the film is compared with the
reference at the check pixels (``check.py``); the reference's count of
lanes alive at each bounce there gives the lane-bounce rooflines their
work (``counts.py``).
"""

from __future__ import annotations

import gc
import math
import os
import signal
import sys
import tempfile
import time

from portbench import check, scenes, trace
from portbench.harness import RunRecord
from portbench.reference import render as reference


class Preempt:
    """SIGTERM to this process `seconds` from now, once the render loop's
    own handler is in place. A SIGTERM outside that loop is ignored."""

    def __init__(self, seconds: float):
        self.fired = False
        self.prev_term = signal.signal(signal.SIGTERM, self._term)
        self.prev_alarm = signal.signal(signal.SIGALRM, self._alarm)
        signal.setitimer(signal.ITIMER_REAL, max(seconds, 1e-3))

    def _term(self, signum, frame):
        pass

    def _alarm(self, signum, frame):
        if signal.getsignal(signal.SIGTERM) == self._term:
            signal.setitimer(signal.ITIMER_REAL, 0.01)  # loop not yet in
            return
        self.fired = True
        os.kill(os.getpid(), signal.SIGTERM)

    def close(self):
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, self.prev_alarm)
        signal.signal(signal.SIGTERM, self.prev_term)


def film_class():
    from pbrs_tpu_torch.render import Film

    class PassFilm(Film):
        """The program's film, calling `hook(samples_done)` each time the
        render loop commits a pass."""
        hook = None

        def __setattr__(self, name, value):
            super().__setattr__(name, value)
            if name == "samples_done" and self.hook is not None:
                self.hook(value)
    return PassFilm


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def msaa_of(spp: int) -> int:
    """render_image's strata a side for a frame of `spp` samples."""
    return max(1, int(math.ceil(math.sqrt(spp))))


def render_kw(config: dict, dev) -> dict:
    return dict(max_depth=config["max_depth"], device=dev,
                sampler_kind=config["sampler"], **config["route"])


def setup(ctx, rec: RunRecord):
    """The scene on the device, warmed: (scene, render_image keywords)."""
    import torch
    from pbrs_tpu_torch import render as rnd

    cfg = ctx.cell.config
    dev = torch.device(ctx.device)
    t = time.perf_counter()
    scene = scenes.build(cfg, ctx.cell.root).to(dev)
    _sync(dev)
    rec.scene_load_s = time.perf_counter() - t
    kw = render_kw(cfg, dev)
    if ctx.trace:
        trace.warm_up(dev)
    _, warm = rnd.render_image(scene, spp=1, seed=ctx.seed, **kw)
    _sync(dev)
    rec.rays_per_pass = int(warm.traced_rays)
    rec.frame_lanes = cfg["width"] * cfg["height"]
    return scene, kw


def measure(ctx, rec: RunRecord, scene, kw, seed: int, seconds: float):
    """The window: one preempted frame. Returns the film."""
    import torch
    from pbrs_tpu_torch import render as rnd

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = torch.device(ctx.device)
    film = film_class()(width=cfg["width"], height=cfg["height"])
    prof = trace.Window(dev) if ctx.trace else None
    marks = []  # (passes done, host clock, process CPU) at each commit
    span = {}

    def hook(done):
        now = time.perf_counter()
        marks.append((done, now, time.process_time()))
        if prof is None or "to" in span:
            return
        if not prof.running and done >= tr["profile_after_passes"] and \
                now - t0 >= tr["profile_after_seconds"]:
            span["from"] = len(marks) - 1
            prof.start()
            span["t"] = time.perf_counter()
        elif prof.running and done - marks[span["from"]][0] >= \
                tr["profile_min_passes"] and now - span["t"] >= \
                tr["profile_seconds"]:
            prof.close()
            span["to"] = len(marks) - 1
            marks.append((done, time.perf_counter(), time.process_time()))
    film.hook = hook

    with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
        pre = Preempt(seconds)
        t0 = time.perf_counter()
        try:
            rnd.render_image(scene, spp=cfg["frame_spp"], seed=seed,
                             film=film,
                             checkpoint_path=os.path.join(tmp, "film.npz"),
                             **kw)
        except KeyboardInterrupt:
            if not pre.fired:
                raise
        finally:
            pre.close()
        t1 = time.perf_counter()
    if prof is not None and prof.running:  # the window closed first
        prof.close()
        span["to"] = len(marks) - 1
    if prof is not None and "to" in span:
        t = time.perf_counter()
        rec.trace = prof.summary()
        print(f"portbench: traced passes {marks[span['from']][0]}-"
              f"{marks[span['to']][0]} of {marks[-1][0]}, "
              f"from {marks[span['from']][1] - t0:.3f} s into the window "
              f"(pass 1 ended at {marks[0][1] - t0:.3f} s); "
              f"its trace reduced in {time.perf_counter() - t:.3f} s",
              file=sys.stderr)
    rec.window_s = t1 - t0
    rec.passes = rec.attempted = film.samples_done
    rec.samples = film.samples_done * cfg["width"] * cfg["height"]
    rec.host_cpu_s, rec.host_passes = _steady_cpu(marks, span)
    if "to" in span:
        rec.profiled_passes = marks[span["to"]][0] - marks[span["from"]][0]
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    film.hook = None
    return film


def _steady_cpu(marks, span):
    """(CPU seconds, passes) over the passes after the first (which holds
    the call's own set-up), less the traced stretch and the profiler's
    start and stop."""
    if len(marks) < 2:
        return 0.0, 0
    pieces = [(0, len(marks) - 1)]
    if "from" in span:
        pieces = [(0, span["from"]), (span["to"] + 1, len(marks) - 1)]
    cpu = sum(marks[b][2] - marks[a][2] for a, b in pieces if b > a)
    passes = sum(marks[b][0] - marks[a][0] for a, b in pieces if b > a)
    return cpu, passes


def judge(ctx, film, seed: int, ray_dtype=None, live=None) -> float:
    """film_rel_l1 of the film at the check pixels against the reference
    (with ray_dtype, the control's). live, a list of max_depth numbers,
    gets the reference's samples alive at each bounce added."""
    cfg = ctx.cell.config
    pixels = check.check_pixels(seed, cfg["width"] * cfg["height"],
                                cfg["check"]["pixels"])
    ref = reference.film_sums(scenes.reference_scene(cfg, ctx.cell.root),
                              seed, pixels, film.samples_done,
                              cfg["max_depth"], msaa_of(cfg["frame_spp"]),
                              ctx.device, ray_dtype=ray_dtype, live=live)
    return check.rel_l1(film.accum[pixels], ref)


def free_device():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx) -> RunRecord:
    rec = RunRecord()
    scene, kw = setup(ctx, rec)
    rec.setup_s = time.time() - ctx.t0
    film = measure(ctx, rec, scene, kw, ctx.seed, ctx.seconds)
    del scene, kw
    free_device()
    live = [0] * ctx.cell.config["max_depth"]
    rec.checks = {check.NAME: (judge(ctx, film, ctx.seed, live=live),
                               check.limit(ctx.cell.config))}
    # The estimator's share of lanes alive at each bounce, over every pass
    # at the check pixels: what the lane-bounce rooflines count.
    n = check.check_pixels(ctx.seed, rec.frame_lanes,
                           ctx.cell.config["check"]["pixels"]).size
    rec.live_per_bounce = [c / (n * film.samples_done) if film.samples_done
                           else 0.0 for c in live]
    return rec
