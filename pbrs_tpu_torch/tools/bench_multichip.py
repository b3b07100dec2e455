"""Multi-rank scaling benchmark of the sharded renderer. Mirrors
tools/bench_multichip.py.

Times ``parallel.render_image_sharded`` at dp1xsp1 on one rank and at the
layouts dpNxsp1, dp(N/2)xsp2 and dp1xspN on N ranks, on two configs:
Cornell size^2 and a compact scene of the fused-wave class at
(size/2)^2, both at `spp` samples, depth 5. Each row: wall_s (the best of
ITERS renders after a warm-up, synchronized, every rank between two
barriers), overhead_ratio (wall_s over dp1xsp1's), checksum (sum of
|image|), the device (the card's name and power limit) and measured_at.
All layouts do the same total work; ranks that share one card (gloo) show
the cost of the sharding (processes, collectives, the host film), ranks
on cards of their own (NCCL) the scaling. dp rows' checksums equal
dp1xsp1's (each pixel's arithmetic is unchanged); sp rows re-associate
each pixel's sum and may round the batch up to the sp size, so theirs
differ.

    python -m pbrs_tpu_torch.tools.bench_multichip [--ranks N] [--size 128]
        [--spp 16] [--device cuda] [--out FILE]

writes FILE (default build/multichip_bench_torch.json); the repo's root
MULTICHIP_BENCH.json is the JAX package's record and is refused as FILE.
``layout_rank`` is the per-rank body; the tests and chip_smoke.py reuse it.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import cli, parallel, profiling
from ..accel import dispatch as trace_dispatch
from ..accel import fused_kernel as fk
from ..accel import fused_single_lobe as fsl
from ..accel import fused_wave as fw
from ..accel import trace_kernel as tk
from ..accel import treelet as tl
from ..core import sampler as smp
from ..geometry import camera as cam_mod
from ..lights import lights as lt
from ..scene import buffers, presets

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join("build", "multichip_bench_torch.json")
DEPTH = 5
ITERS = 2  # timed renders a layout after a warm-up (tools/bench_multichip.py)
# Kernel launch counters, by the kernel's name.
COUNTERS = {"trace_flat": tk, "trace_bvh": tl, "fused_bounce": fk,
            "fused_single_lobe": fsl, "fused_wave": fw}


def wave_class_scene(size):
    """A compact scene of the fused-wave class (image environment with
    importance sampling, delta + smooth mixtures, FresnelBlend, image +
    checker textures, delta + shaped area lights), as
    tools/bench_multichip.py builds it."""
    b = buffers.SceneBuilder()
    g = b.geometry
    rng = np.random.default_rng(5)
    tex_img = b.textures.add_image(rng.random((8, 8, 3)).astype(np.float32))
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               b.materials.add_lambertian(tex_id=tex_img))
    g.add_sphere((-2, 1, 0), 1.0, b.materials.add_substrate(
        (0.5, 0.3, 0.2), (0.3, 0.3, 0.3), 0.08))
    g.add_sphere((0.5, 1, 0), 1.0, b.materials.add_uber(
        (0.3, 0.4, 0.5), (0.4, 0.4, 0.4), roughness=0.1, opacity=0.7))
    g.add_sphere((3, 1, 0), 1.0, b.materials.add_dielectric(1.5))
    light_c = (6.0, 6.0, 6.0)
    g.add_quad((-2, 7, -2), (4, 0, 0), (0, 0, 4),
               b.materials.add_diffuse_light(light_c))
    b.lights.add_area_quad(light_c, (-2, 7, -2), (4, 0, 0), (0, 0, 4))
    b.lights.add_point((6, 5, -6), (40, 35, 30))
    env = rng.random((8, 16, 3)).astype(np.float32)
    b.lights.env = lt.make_env_image(env, scale=(1.5, 1.5, 1.5))
    cam = cam_mod.make_camera((size, size), 45.0)
    b.camera = cam_mod.looking_at(cam, (0, 4, -14), (0, 1.5, 0), (0, 1, 0))
    return b.build()


def layouts(n_ranks):
    """dp1xsp1, then dpNxsp1, dp(N/2)xsp2 and dp1xspN, each once."""
    out = [(1, 1)]
    for dp, sp in ((n_ranks, 1), (n_ranks // 2, 2), (1, n_ranks)):
        if dp >= 1 and dp * sp == n_ranks and (dp, sp) not in out:
            out.append((dp, sp))
    return out


def _integrator(kind, scene, trace_fns):
    if kind == "fused_diffuse":
        return fk.FusedDiffuseIntegrator(scene)
    if kind == "fused_single_lobe":
        return fsl.FusedSingleLobeIntegrator(scene)
    if kind == "fused_wave":
        return fw.FusedWaveIntegrator(scene, trace_fns=trace_fns)
    raise ValueError(f"unknown integrator {kind!r}")


def _run_job(dev, scene, job, mesh, cache):
    """One render of `job` on this rank: an [H, W, 3] image (job "spp":
    render_image_sharded), else the [N, 3] film of job["samples"] sample
    indices from 0 over every pixel in order, msaa 2 (render_batch_sharded
    with job["integrator"], None for the general path); PCG seed 0."""
    depth = job["depth"]
    if "spp" in job:
        return parallel.render_image_sharded(scene, job["spp"], mesh,
                                             max_depth=depth)
    key = (job["scene"], job.get("integrator"))
    if key not in cache:
        trace_fns = trace_dispatch.make_trace_fns(scene)
        cache[key] = (trace_fns, None if key[1] is None
                      else _integrator(key[1], scene, trace_fns))
    trace_fns, integ = cache[key]
    n = scene.camera.width * scene.camera.height
    n_dp = mesh.shape[0]
    pix = torch.arange(n + (-n) % n_dp, dtype=torch.int32, device=dev) % n
    film = parallel.render_batch_sharded(
        scene, smp.PCGSampler(0), pix, 0, job["samples"], mesh,
        max_depth=depth, msaa=2, trace_fns=trace_fns, integrator=integ)
    return film[:n].cpu().numpy()


def _span_counts(fn):
    """fn() under a CPU torch.profiler with the recorder on: (its result,
    {pbrs.* span name: events}), read from the window's Chrome trace."""
    profiling.recording(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        profiling.recording(False)
    with tempfile.TemporaryDirectory(prefix="pbrs_spans_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    counts = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and name.startswith("pbrs."):
            counts[name] = counts.get(name, 0) + 1
    return out, counts


def _synchronize(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()


def layout_rank(dev, scenes, jobs, iters=0):
    """``parallel.run_ranks`` body: each job in turn on a mesh of its
    (dp, sp) over the first dp * sp ranks, every rank calling make_mesh.
    scenes: {name: ``buffers.scene_to_arrays`` dict}; a job is {"scene",
    "dp", "sp", "depth"} and either "spp" (render_image_sharded) or
    "samples" and "integrator" (render_batch_sharded: "fused_diffuse",
    "fused_single_lobe", "fused_wave" or None). With iters > 0 a job
    renders once to warm up and then `iters` times, timed; else once. A
    job with "spans" true renders under a CPU torch.profiler with the
    recorder on.

    Returns {"rank", "coords": this rank's mesh coordinate a job (None
    outside the mesh), "runs": a job each {"out": the image or film (rank
    0, else None), "seconds": the best render's wall time, "launches":
    {kernel: launches on this rank over the job's renders}, "spans":
    {pbrs.* span name: events on this rank}, empty without "spans"}}."""
    built = {name: buffers.scene_from_arrays(arrays).to(dev)
             for name, arrays in scenes.items()}
    cache = {}
    coords, runs = [], []
    for job in jobs:
        mesh = parallel.make_mesh(job["dp"], job["sp"], device_type=dev.type)
        coord = mesh.get_coordinate()
        coords.append(None if coord is None else tuple(coord))
        for m in COUNTERS.values():
            m.LAUNCHES = 0
        out, times, spans = None, [], {}
        for _ in range(1 + iters if iters else 1):
            _synchronize(dev)
            t0 = time.perf_counter()
            if coord is not None:
                render = (lambda: _run_job(dev, built[job["scene"]], job,
                                           mesh, cache))
                if job.get("spans"):
                    out, spans = _span_counts(render)
                else:
                    out = render()
            _synchronize(dev)
            times.append(time.perf_counter() - t0)
        best = min(times[1:] if iters else times)
        runs.append({"out": out if dist.get_rank() == 0 else None,
                     "seconds": best,
                     "launches": {k: m.LAUNCHES for k, m in COUNTERS.items()
                                  if m.LAUNCHES},
                     "spans": spans})
    return {"rank": dist.get_rank(), "coords": coords, "runs": runs}


def device_label(device):
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench_config(name, scene, spp, n_ranks, device):
    """Every layout of `n_ranks` ranks in one spawn: rows as
    tools/bench_multichip.py writes them, plus device and measured_at."""
    pairs = layouts(n_ranks)
    jobs = [{"scene": name, "dp": dp, "sp": sp, "depth": DEPTH, "spp": spp}
            for dp, sp in pairs]
    res = parallel.run_ranks(
        layout_rank, n_ranks, {name: buffers.scene_to_arrays(scene)}, jobs,
        ITERS, device=device)
    label = device_label(device)
    when = datetime.datetime.now(datetime.timezone.utc).isoformat()
    runs = res[0]["runs"]
    t1 = runs[0]["seconds"]
    rows = []
    for (dp, sp), run in zip(pairs, runs):
        rows.append({"devices": dp * sp, "layout": f"dp{dp}xsp{sp}",
                     "wall_s": run["seconds"],
                     "overhead_ratio": run["seconds"] / t1,
                     "checksum": float(np.abs(run["out"]).sum()),
                     "device": label, "measured_at": when})
        print(rows[-1], flush=True)
    return {"config": name, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: the cards, at least 2)")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    out_path = os.path.abspath(args.out)
    if out_path == os.path.join(REPO, "MULTICHIP_BENCH.json"):
        raise SystemExit("MULTICHIP_BENCH.json is the JAX package's record; "
                         "write elsewhere")
    n_cards = 0
    if torch.device(args.device).type == "cuda":
        parallel.rank_device(args.device, 0)  # raises without a card
        n_cards = torch.cuda.device_count()
    n_ranks = args.ranks or max(2, n_cards)
    size = args.size
    cornell = cli.with_resolution(presets.cornell_box(), size, size)
    configs = [
        bench_config(f"cornell_{size}x{size}_{args.spp}spp_depth{DEPTH}",
                     cornell, args.spp, n_ranks, args.device),
        bench_config(f"wave_class_{size // 2}x{size // 2}_{args.spp}spp_"
                     f"depth{DEPTH}", wave_class_scene(size // 2), args.spp,
                     n_ranks, args.device),
    ]
    out = {
        "platform": args.device,
        "backend": parallel.choose_backend(torch.device(args.device).type,
                                           n_ranks, n_cards),
        "ranks": n_ranks,
        "note": ("every layout renders the same total work; wall_s is the "
                 "best of the timed renders after a warm-up, every rank "
                 "between two barriers. Ranks that share a card show the "
                 "sharding's cost, not scaling. dp rows' checksums equal "
                 "dp1xsp1's; sp rows re-associate each pixel's sum and may "
                 "round the batch up to the sp size."),
        "configs": configs,
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"written": out_path}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
