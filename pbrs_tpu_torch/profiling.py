"""Where the time goes on the card, for one scene and route.

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
generation alone (CUDA events). Prints one JSON line per route, with the
card's name. CUDA only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def single_lobe_bounce_ms(scene, depth, msaa, sample=0):
    """[(alive lanes in, K3 device ms)] per bounce of one sample index."""
    from .accel import fused_single_lobe as fsl
    from .core import sampler as smp
    from .integrators import wavefront

    tab = fsl.SingleLobeTables.from_scene(scene)
    n = scene.camera.width * scene.camera.height
    dev = scene.device
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    rays = wavefront.camera_rays(scene, smp.PCGSampler(0), pix, sample, msaa)
    fin = torch.cat([rays.origin.T, rays.dir.T,
                     torch.ones(3, n, device=dev)]).contiguous()
    alive = torch.ones(n, dtype=torch.int32, device=dev)
    spec = torch.zeros(n, dtype=torch.int32, device=dev)
    samp = torch.full((n,), sample, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    out = []
    for b in range(depth):
        live = int((alive > 0).sum())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fout, alive, spec = fsl.bounce2(
            tab, fin, alive, spec, pix, samp, count, seed=0, bounce=b,
            bounce_is_first=b == 0, rr_active=b > 3)
        end.record()
        torch.cuda.synchronize()
        out.append((live, start.elapsed_time(end)))
        fin = fout[3:]
    return out


def profile_route(scene, route, depth, msaa, samples=4, warmup=2):
    from . import render
    from .core import sampler as smp
    from .integrators import wavefront

    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=scene.device)
    sampler = smp.PCGSampler(0)
    name, step = render.make_integrator(scene, sampler, depth, msaa, route)
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
        if out["integrator"] == "fused_single_lobe":
            out["k3_per_bounce"] = single_lobe_bounce_ms(scene, args.depth,
                                                         args.msaa)
        out.update(scene=label, levels=args.levels,
                   resolution=args.resolution,
                   device=torch.cuda.get_device_name(0))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
