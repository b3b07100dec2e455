"""Where the time goes on the card, for one scene and route.

    python -m pbrs_tpu_torch.profiling --scene_name cornell_box --depth 8
    python -m pbrs_tpu_torch.profiling --scene_name plates \\
        --resolution 1024x1024 --depth 5 --msaa 2 --route auto general
    python -m pbrs_tpu_torch.profiling --scene_name mesh_ball --levels 5 \\
        --resolution 800x600 --depth 6 --route auto
    python -m pbrs_tpu_torch.profiling \\
        --pbrt_file scenes/interior/interior.pbrt --resolution 1024x1024 \\
        --depth 5 --route auto general

For each route: wall time per sample index (host clock around work that
ends in a synchronize), device busy time per sample (the self device time
of every kernel in a torch.profiler window), the busy share, the kernels
that take most of the device time, and the device time of camera-ray
generation alone (CUDA events), and the shrink schedule of a compacted
route (``profile_route(..., compact=True)``). On route auto through a
fused bounce (K2
for Cornell, K3 for plates), also each of that kernel's launches in sample
0, replayed: its live lanes and device ms, and their sum a sample, drawing
PCG and Sobol'. Prints one JSON line per route, with the card's name. CUDA
only.

Also the JAX package's two profiler hooks (pbrs_tpu/profiling.py):
``profile_phases``, the device ms of one launch of each phase run on its
own (camera rays, closest hit, shadow any hit, one bounce, the full path;
``render_image``'s CLI prints them with --phase_timings), and
``profiler_trace``, a torch.profiler window written as a Chrome trace
(``render_image(profile_dir=)``, --profile_dir).

And the program's recorder, off unless a caller turns it on
(``recording(True)``; ``profiler_trace`` does for its window): ``span``
names a stage of the render (``pbrs.pass``, ``pbrs.camera_rays``,
``pbrs.bounce``, ``pbrs.trace``, ``pbrs.occlude``, ``pbrs.all_reduce``)
as a ``torch.profiler.record_function``, so it lands in a running
profiler's trace on the clock of the device's work; ``count_lanes`` adds
each bounce's live and launched lanes (``counters``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch


class _Recorder:
    """The recorder's state: whether it is on, each device's live-lane
    counts (int64 scalars on the device, one a bounce, summed when read)
    and the launched lanes (a host int)."""

    def __init__(self):
        self.on = False
        self.live = {}
        self.launched = 0


_REC = _Recorder()
_NO_SPAN = contextlib.nullcontext()


def recording(on: bool) -> None:
    """Turn the recorder on, its counters from zero, or off."""
    _REC.on = bool(on)
    if _REC.on:
        _REC.live = {}
        _REC.launched = 0


def span(name: str):
    """A context naming a stage ``name`` ("pbrs.<stage>"): with the
    recorder off, one shared no-op context; on, a
    ``torch.profiler.record_function``, which a running profiler records
    as a ``user_annotation`` event."""
    if not _REC.on:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def count_lanes(alive, launched: int) -> None:
    """With the recorder on, add a bounce's live lanes (``alive != 0``,
    counted on the device by one launch, with no sync) and the `launched`
    lanes of its batch to the counters; off, nothing."""
    if not _REC.on:
        return
    _REC.live.setdefault(alive.device, []).append(torch.count_nonzero(alive))
    _REC.launched += int(launched)


def counters() -> dict:
    """{live, launched}: lane-bounces counted since the recorder was
    turned on (reading the live count syncs each device once)."""
    return {"live": sum(int(torch.stack(c).sum()) for c in
                        _REC.live.values()),
            "launched": _REC.launched}


@contextlib.contextmanager
def profiler_trace(profile_dir: str | None):
    """A torch.profiler window (host ops, the recorder's spans, and the
    card's kernels where there is a card) written on exit as a Chrome
    trace, ``<profile_dir>/trace_<pid>_<ns>.json``; a no-op when
    profile_dir is falsy. The recorder is on for the window (and left on
    if a caller had turned it on)."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    was_on = _REC.on
    if not was_on:
        recording(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield
    finally:
        if not was_on:
            recording(False)
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _time_ms(fn, *args, iters=3, cuda=False):
    """Median ms of fn(*args) after one warm-up call: CUDA events on the
    card (cuda=True), the host's clock elsewhere."""
    fn(*args)
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile_phases(scene, n_pixels: int = 1 << 20, max_depth: int = 5,
                   seed: int = 0, device="cuda", iters: int = 3) -> dict:
    """Per-phase device timings, ms a launch of `n_pixels` lanes, with
    pbrs_tpu.profiling.profile_phases' keys: raygen (camera rays), trace
    (closest hit) and occlude (shadow any hit) of those rays through the
    kernels, bounce1 (one whole bounce of the general path: trace, shade,
    NEE) and full (max_depth bounces); shade_nee_ms = bounce1 - trace -
    occlude; Mrays/s of trace and occlude. Each phase runs on its own, so
    the numbers do not decompose a render."""
    from .accel import dispatch
    from .core import sampler as smp
    from .integrators import wavefront

    scene = scene.to(device)
    dev = scene.device
    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n_pixels, dtype=torch.int32, device=dev) % n
    sid = torch.zeros((), dtype=torch.int32, device=dev)
    sampler = smp.PCGSampler(seed)
    isect_fn, occl_fn = dispatch.make_trace_fns(scene, True)

    def raygen(p, s):
        return wavefront.camera_rays(scene, sampler, p, s, 1)

    rays = raygen(pix, sid)

    def bounce(depth):
        def run(p, s):
            return wavefront.path_radiance(scene, raygen(p, s), sampler, p,
                                           s, isect_fn, occl_fn,
                                           max_depth=depth)
        return run

    kw = {"iters": iters, "cuda": dev.type == "cuda"}
    out = {"lanes": int(n_pixels)}
    out["raygen_ms"] = _time_ms(raygen, pix, sid, **kw)
    out["trace_ms"] = _time_ms(isect_fn, rays, **kw)
    out["occlude_ms"] = _time_ms(occl_fn, rays, **kw)
    out["bounce1_ms"] = _time_ms(bounce(1), pix, sid, **kw)
    out["full_ms"] = _time_ms(bounce(max_depth), pix, sid, **kw)
    out["shade_nee_ms"] = round(
        max(out["bounce1_ms"] - out["trace_ms"] - out["occlude_ms"], 0.0), 3)
    out["trace_mrays_s"] = round(n_pixels / out["trace_ms"] / 1e3, 2)
    out["occlude_mrays_s"] = round(n_pixels / out["occlude_ms"] / 1e3, 2)
    for k in ("raygen_ms", "trace_ms", "occlude_ms", "bounce1_ms", "full_ms"):
        out[k] = round(out[k], 3)
    return out


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def fused_launches(scene, depth, msaa, sampler, sample=0):
    """Every launch of the fused bounce (K2 or K3, as route auto picks) in
    one sample index of the scene: (integrator name, the wrapper, [(args,
    kwargs)] of each launch in bounce order). The kernels only write their
    outputs, so a recorded launch's inputs stay as they were."""
    from . import render
    from .accel import fused_kernel as fk
    from .accel import fused_single_lobe as fsl

    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=scene.device)
    name, step = render.make_integrator(scene, sampler, depth, msaa, "auto")
    mod, attr = {"fused": (fk, "bounce"),
                 "fused_single_lobe": (fsl, "bounce2")}[name]
    wrapper, launches = getattr(mod, attr), []

    def record(*args, **kw):
        launches.append((args, kw))
        return wrapper(*args, **kw)

    setattr(mod, attr, record)
    try:
        step(pix, sample)
    finally:
        setattr(mod, attr, wrapper)
    return name, wrapper, launches


def replay(wrapper, args, kw):
    """One recorded launch again, adding its ray count to a fresh counter
    (the count tensor is the second to last argument)."""
    args = list(args)
    args[-1] = torch.zeros_like(args[-1])
    return wrapper(*args, **kw)


def per_bounce_ms(scene, depth, msaa, sampler, iters=20):
    """[{bounce, live lanes in, device ms}] of every fused-bounce launch of
    sample 0, each replayed `iters` times (CUDA events), and their sum."""
    from .tools.prof_rounds import cuda_ms

    _, wrapper, launches = fused_launches(scene, depth, msaa, sampler)
    rows = []
    for b, (args, kw) in enumerate(launches):
        alive = args[2]
        rows.append({"bounce": b, "live": int((alive > 0).sum()),
                     "ms": cuda_ms(lambda: replay(wrapper, args, kw),
                                   iters)})
    return rows, sum(r["ms"] for r in rows)


def profile_route(scene, route, depth, msaa, samples=4, warmup=2,
                  nee_mode="twoarm", compact=False):
    from . import render
    from .core import sampler as smp
    from .integrators import wavefront

    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=scene.device)
    sampler = smp.PCGSampler(0)
    name, step = render.make_integrator(
        scene, sampler, depth, msaa, route, nee_mode=nee_mode,
        compact_pilot=pix if compact else None)
    for s in range(warmup):
        step(pix, s)
    torch.cuda.synchronize()
    t0 = time.time()
    for s in range(warmup, warmup + samples):
        step(pix, s)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / samples

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for s in range(warmup, warmup + samples):
            step(pix, s)
        torch.cuda.synchronize()
    # Kernel events only: an aten op's row repeats its kernels' time.
    events = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU
              and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in events) / 1e3 / samples
    top = sorted(events, key=_device_us, reverse=True)[:6]

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wavefront.camera_rays(scene, sampler, pix, warmup, msaa)
    end.record()
    torch.cuda.synchronize()
    return {
        "route": route, "integrator": name, "lanes": n, "depth": depth,
        "schedule": getattr(step, "schedule", None),
        "wall_ms_per_sample": wall_ms,
        "device_busy_ms_per_sample": busy_ms,
        "busy_share": busy_ms / wall_ms,
        "camera_rays_ms": start.elapsed_time(end),
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "ms_per_sample": _device_us(e) / 1e3 / samples}
                        for e in top],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pbrs_tpu_torch.profiling")
    p.add_argument("--scene_name", default="plates")
    p.add_argument("--pbrt_file", default=None,
                   help="profile a PBRT scene file instead of a preset")
    p.add_argument("--resolution", default="1024x1024", metavar="WxH")
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--msaa", type=int, default=2)
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--route", nargs="+", default=["auto"])
    p.add_argument("--levels", type=int, default=None,
                   help="subdivision levels of a mesh preset (mesh_ball)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("pbrs_tpu_torch.profiling: no CUDA device")
    from . import render
    from .cli import with_resolution
    from .scene import presets

    w, h = (int(x) for x in args.resolution.lower().split("x"))
    if args.pbrt_file:
        from .scene.pbrt import loader

        scene, label = loader.build_scene(args.pbrt_file), args.pbrt_file
    else:
        kw = {} if args.levels is None else {"levels": args.levels}
        scene = presets.PRESETS[args.scene_name](**kw)
        label = args.scene_name
    scene = with_resolution(scene, w, h).to("cuda")
    for route in args.route:
        out = profile_route(scene, route, args.depth, args.msaa,
                            samples=args.samples)
        if route == "auto" and out["integrator"] in ("fused",
                                                     "fused_single_lobe"):
            for rng in ("pcg", "sobol"):
                rows, total = per_bounce_ms(scene, args.depth, args.msaa,
                                            render.SAMPLERS[rng](0))
                out[f"per_bounce_{rng}"] = rows
                out[f"per_bounce_{rng}_sum_ms"] = total
        out.update(scene=label, levels=args.levels,
                   resolution=args.resolution,
                   device=torch.cuda.get_device_name(0))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
