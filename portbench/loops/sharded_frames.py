"""Back-to-back frames of the sharded renderer (a closed loop, one client).

``parallel.run_ranks`` starts one rank a card (NCCL); each rank builds the
scene, joins the configuration's dp x sp mesh (``parallel.make_mesh``) and
warms up: one pass of the general path over the whole frame through the
scene's tracers (its traced rays are the rays a pass) and one
``all_reduce`` of a film over each mesh dimension. After a barrier, rank 0
opens the window and the ranks render frames with
``parallel.render_image_sharded`` (frame k with seed + k), rank 0 saying
after each frame whether the window is over. The window closes with the
first frame that ends after ``--seconds``; every frame's samples count.

With --trace 1 every rank profiles one batch of frame
``profile_after_frames``: its passes of that batch and their
``all_reduce`` (``_trace_one_batch``).

Rank 0 keeps each frame at the check pixels; once the ranks have ended,
the reference recomputes every frame there (``check.py``).
"""

from __future__ import annotations

import importlib
import math
import time
from pathlib import Path

import numpy as np

from portbench import check, scenes, trace
from portbench.harness import RunRecord, forbidden_modules
from portbench.reference import render as reference


def rank_main(dev, spec):
    import torch
    import torch.distributed as dist
    from pbrs_tpu_torch import parallel
    from pbrs_tpu_torch.accel import dispatch
    from pbrs_tpu_torch.core import sampler as smp
    from pbrs_tpu_torch.integrators import wavefront

    if spec.get("plant"):  # a fault planted by the tests
        mod, fn = spec["plant"].split(":")
        getattr(importlib.import_module(mod), fn)()
    cfg, tr = spec["config"], spec["traffic"]
    lay = cfg["layout"]
    rank = dist.get_rank()
    spp = int(cfg["frame_spp"])
    depth = cfg["max_depth"]
    n = cfg["width"] * cfg["height"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t = time.perf_counter()
    scene = scenes.build(cfg, Path(spec["root"])).to(dev)
    sync()
    scene_load_s = time.perf_counter() - t
    mesh = parallel.make_mesh(lay["dp"], lay["sp"], dev.type)
    msaa = msaa_of(spp)
    isect_fn, occl_fn = dispatch.make_trace_fns(scene)
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    _, rays = wavefront.render_samples(scene, smp.PCGSampler(spec["seed"]),
                                       pix, 0, isect_fn, occl_fn,
                                       max_depth=depth, msaa=msaa)
    rays = int(rays)
    for dim in ("sp", "dp"):
        film = torch.zeros(n, 3, device=dev)
        dist.all_reduce(film, group=mesh.get_group(dim))
    del film, pix, isect_fn, occl_fn
    if spec["trace"]:
        trace.warm_up(dev)
    sync()
    dist.barrier()

    kept = []
    frames = 0
    traced = {}
    if spec["trace"]:
        _trace_one_batch(parallel, trace.Window(dev), lay["sp"], traced,
                         lambda: frames >= tr["profile_after_frames"])
    t_start, c0 = time.time(), time.process_time()
    while True:
        img = parallel.render_image_sharded(scene, spp, mesh, max_depth=depth,
                                            seed=spec["seed"] + frames)
        frames += 1
        if rank == 0:
            kept.append(np.array(img.reshape(-1, 3)[spec["pixels"]]))
        go = torch.tensor([int(time.time() - t_start < spec["seconds"])],
                          device=dev)
        dist.broadcast(go, src=0)
        if not int(go.item()):
            break
    t_end, c1 = time.time(), time.process_time()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {"rank": rank, "scene_load_s": scene_load_s, "t_start": t_start,
            "t_end": t_end, "frames": frames, "kept": kept, "cpu_s": c1 - c0,
            "summary": traced.get("summary"),
            "profiled_passes": traced.get("passes", 0),
            "rays_per_pass": rays, "memory_peak_bytes": int(peak),
            "forbidden": forbidden_modules()}


def _trace_one_batch(parallel, window, n_sp, out, armed):
    """Profile the first ``render_batch_sharded`` call (a rank's passes of
    one batch and their all_reduce) made once `armed()` holds: the
    harness wraps the program's function in this rank, changing nothing
    it computes. Leaves the summary and the rank's passes in `out`."""
    real = parallel.render_batch_sharded

    def batch(*args, **kw):
        if "summary" in out or not armed():
            return real(*args, **kw)
        window.start()
        result = real(*args, **kw)
        out["summary"] = window.stop()
        out["passes"] = int(kw.get("samples_per_call", args[4])) // n_sp
        return result
    parallel.render_batch_sharded = batch


def run(ctx) -> RunRecord:
    from pbrs_tpu_torch import kernels, parallel

    cfg = ctx.cell.config
    lay = cfg["layout"]
    n_ranks = lay["dp"] * lay["sp"]
    n = cfg["width"] * cfg["height"]
    spp = int(cfg["frame_spp"])
    if ctx.device == "cuda":
        kernels.build()  # once, before the ranks start
    pixels = check.check_pixels(ctx.seed, n, cfg["check"]["pixels"])
    spec = {"config": cfg, "traffic": ctx.cell.traffic,
            "root": str(ctx.cell.root), "seed": ctx.seed,
            "seconds": ctx.seconds, "trace": ctx.trace, "pixels": pixels,
            "plant": ctx.cell.traffic.get("plant")}
    outs = parallel.run_ranks(rank_main, n_ranks, spec, device=ctx.device)
    bad = sorted({m for o in outs for m in o["forbidden"]})
    if bad:
        raise RuntimeError(f"a rank loaded JAX or the JAX package: {bad}")
    r0 = outs[0]
    rec = RunRecord(ranks=n_ranks)
    rec.setup_s = r0["t_start"] - ctx.t0
    rec.scene_load_s = r0["scene_load_s"]
    rec.window_s = r0["t_end"] - r0["t_start"]
    rec.passes = r0["frames"] * spp
    rec.samples = rec.passes * n
    rec.attempted = r0["frames"]
    rec.host_cpu_s, rec.host_passes = r0["cpu_s"], rec.passes
    rec.memory_peak_bytes = max(o["memory_peak_bytes"] for o in outs)
    # A rank's work a frame: spp / sp passes over n / dp lanes.
    rec.frame_lanes = n // lay["dp"]
    rec.rays_per_pass = r0["rays_per_pass"] // lay["dp"]
    parts = [o["summary"] for o in outs if o["summary"] is not None]
    if parts:
        rec.trace = trace.TraceSummary.merge(parts)
        rec.profiled_passes = sum(o["profiled_passes"] for o in outs)
    prog, ref = [], []
    ref_scene = scenes.reference_scene(cfg, ctx.cell.root)
    for k, frame in enumerate(r0["kept"]):
        prog.append(frame * np.float32(spp))
        ref.append(reference.film_sums(ref_scene, ctx.seed + k, pixels, spp,
                                       cfg["max_depth"], msaa_of(spp),
                                       ctx.device))
    rec.checks = {check.NAME: (check.rel_l1(np.concatenate(prog),
                                            np.concatenate(ref)),
                               check.limit(cfg))}
    return rec


def msaa_of(spp: int) -> int:
    """render_image_sharded's strata a side."""
    return max(1, int(round(math.sqrt(spp))))
