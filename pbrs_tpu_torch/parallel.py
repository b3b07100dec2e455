"""Multi-device execution: the pixel-sample grid sharded over the ranks of a
``torch.distributed`` device mesh. Mirrors pbrs_tpu/parallel.py.

Path tracing is embarrassingly parallel per pixel-sample, so pixels are
split over a 'dp' mesh dimension, sample indices over an 'sp' dimension,
and one ``all_reduce`` of the film over 'sp' is the only collective of the
estimator (the JAX package's ``psum``). Every rank holds the whole scene.

A rank is a process. ``run_ranks`` starts them (the spawn start method, a
file rendezvous in a fresh temporary directory) and returns what each
rank's function returned; ``torchrun --nproc_per_node`` works as well,
given an initialized process group. Backends: NCCL when every rank has a
card of its own; gloo on the CPU and when ranks share a card (NCCL refuses
two ranks on one GPU). A failed init or collective raises; nothing falls
back to another backend or device.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from . import profiling
from .accel import dispatch as trace_dispatch
from .core import sampler as smp
from .integrators import wavefront

MESH_DIMS = ("dp", "sp")
# Seconds a collective may wait on another rank before it raises, and a
# run_ranks call on its ranks before it stops them.
COLLECTIVE_TIMEOUT_S = 600
RUN_TIMEOUT_S = 1800


def choose_backend(device_type: str, n_ranks: int, n_devices: int) -> str:
    """'nccl' when the ranks run on CUDA and each has a card of its own
    (n_ranks <= n_devices), else 'gloo': on the CPU, and for ranks that
    share a card, which NCCL refuses ("Duplicate GPU detected")."""
    if device_type == "cuda" and n_ranks <= n_devices:
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of rank `rank`: card rank % device_count for "cuda"
    (ranks share cards round robin when there are fewer cards), else
    `device` itself. Raises without a card when asked for CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, n_ranks, init_method, device, backend, threads, fn,
               args, results):
    """Body of one spawned rank: its device, the process group, fn(dev,
    *args); posts (rank, True, result) or (rank, False, traceback)."""
    try:
        torch.set_num_threads(threads)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=n_ranks,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
            device_id=dev if backend == "nccl" else None)
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, n_ranks: int, *args, device="cuda"):
    """Run fn(dev, *args) on `n_ranks` spawned ranks joined in one process
    group, dev being each rank's device (``rank_device``), and return the
    ranks' results in rank order. fn must be importable from this package
    (the spawn start method pickles it by name), and it and its results
    must pickle. The backend is ``choose_backend``'s. Each rank runs
    torch's CPU ops on its share of this process's threads. Raises
    without a card when `device` is CUDA, and when a rank fails (with its
    traceback) or the ranks outlast RUN_TIMEOUT_S; the other ranks are
    stopped then."""
    dev = torch.device(device)
    n_devices = 0
    if dev.type == "cuda":
        rank_device(dev, 0)  # raises without a card
        n_devices = torch.cuda.device_count()
    backend = choose_backend(dev.type, n_ranks, n_devices)
    threads = max(1, torch.get_num_threads() // n_ranks)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="pbrs_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rdzv")
        procs = [ctx.Process(target=_rank_main, args=(
            r, n_ranks, init, device, backend, threads, fn, args, results))
            for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + RUN_TIMEOUT_S
            while len(out) < n_ranks:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    gone = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in out]
                    if not gone and time.monotonic() <= deadline:
                        continue
                    if not gone:
                        raise TimeoutError(f"ranks ran past {RUN_TIMEOUT_S} "
                                           f"s; stopped") from None
                    try:  # a rank that failed posts its traceback first
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank(s) {gone} exited without "
                                           f"a result") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30 if len(out) == n_ranks else 1)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [out[r] for r in range(n_ranks)]


def make_mesh(n_dp: int | None = None, n_sp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh with pixel-parallel 'dp' and sample-parallel 'sp' dimensions
    over ranks 0 .. n_dp * n_sp - 1 of the initialized process group, rank
    r at (r // n_sp, r % n_sp), as pbrs_tpu's ``devices.reshape(n_dp,
    n_sp)``. n_dp None takes world_size // n_sp. Every rank of the group
    calls it, those outside the mesh too (their coordinate is None)."""
    if n_dp is None:
        n_dp = dist.get_world_size() // n_sp
    ranks = torch.arange(n_dp * n_sp).reshape(n_dp, n_sp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_DIMS)


def render_batch_sharded(scene, sampler, pixel_idx, sample_base: int,
                         samples_per_call: int, mesh: DeviceMesh,
                         max_depth=5, msaa=2, use_nee=True, trace_fns=None,
                         integrator=None):
    """Render `samples_per_call` samples for every pixel in `pixel_idx`
    ([N] int tensor, N a multiple of the dp size), sharded over the mesh:
    this rank takes the dp-th contiguous block of pixels and sample
    indices sample_base + sp * per_shard + i, i = 0 .. per_shard - 1,
    summed in that order from zeros, then summed over 'sp'. Returns the
    per-pixel radiance summed over the samples, [N, 3] float32, whole on
    every rank of the mesh (the dp blocks meet in a zero-filled film
    summed over 'dp', which leaves every value as its rank computed it).

    integrator None renders through ``wavefront.render_samples`` with
    `trace_fns` (default: the broadcast sweep over the scene's geometry
    and instance groups); else its ``render_samples`` -- a
    ``FusedDiffuseIntegrator``, ``FusedSingleLobeIntegrator`` or
    ``FusedWaveIntegrator`` -- per shard (the estimator is stateless, so
    the fused kernels compose with the mesh)."""
    n_dp, n_sp = mesh.shape
    if samples_per_call % n_sp:
        raise ValueError(f"{samples_per_call} samples do not divide the sp "
                         f"size {n_sp}")
    n = pixel_idx.shape[0]
    if n % n_dp:
        raise ValueError(f"{n} pixels do not divide the dp size {n_dp}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    dp_idx, sp_idx = coord
    per_shard = samples_per_call // n_sp
    block = n // n_dp
    pix = pixel_idx[dp_idx * block:(dp_idx + 1) * block]
    if integrator is None:
        isect_fn, occl_fn = trace_fns or trace_dispatch.make_trace_fns(
            scene, use_kernels=False)

    def render_one(s):
        if integrator is not None:
            return integrator.render_samples(sampler, pix, s,
                                             max_depth=max_depth,
                                             msaa=msaa)[0]
        return wavefront.render_samples(scene, sampler, pix, s, isect_fn,
                                        occl_fn, max_depth=max_depth,
                                        msaa=msaa, use_nee=use_nee)[0]

    acc = torch.zeros(block, 3, device=pix.device)
    for i in range(per_shard):
        with profiling.span("pbrs.pass"):
            acc = acc + render_one(sample_base + sp_idx * per_shard + i)
    if n_sp > 1:
        with profiling.span("pbrs.all_reduce"):
            dist.all_reduce(acc, group=mesh.get_group("sp"))
    if n_dp == 1:
        return acc
    film = torch.zeros(n, 3, device=pix.device)
    film[dp_idx * block:(dp_idx + 1) * block] = acc
    with profiling.span("pbrs.all_reduce"):
        dist.all_reduce(film, group=mesh.get_group("dp"))
    return film


def render_image_sharded(scene, spp: int, mesh: DeviceMesh, max_depth=5,
                         seed=0, use_nee=True):
    """Full-frame sharded render -> [H, W, 3] float32 (host numpy), on the
    rank's device (the scene's), through the scene's tracers
    (``dispatch.make_trace_fns``: the kernels on the card). As
    pbrs_tpu.parallel.render_image_sharded: msaa = round(sqrt(spp)); pixel
    ids 0 .. n + pad - 1 in order, padded to the dp size; each call takes
    a batch of sample indices rounded up to the sp size (indices past
    msaa^2 draw random strata), and the sum is divided by the sample
    indices done."""
    cam = scene.camera
    n = cam.width * cam.height
    n_dp, n_sp = mesh.shape
    pad = (-n) % n_dp
    pixel_idx = torch.arange(n + pad, dtype=torch.int32, device=scene.device)
    sampler = smp.PCGSampler(seed)
    msaa = max(1, int(round(spp ** 0.5)))
    samples_per_call = max(n_sp, msaa * msaa // max(1, (msaa * msaa) // n_sp))
    trace_fns = trace_dispatch.make_trace_fns(scene)

    total = np.zeros((n + pad, 3), np.float32)
    done = 0
    spp_total = msaa * msaa
    while done < spp_total:
        batch = min(samples_per_call, spp_total - done)
        batch = max(n_sp, batch - batch % n_sp)
        total += render_batch_sharded(
            scene, sampler, pixel_idx, done, batch, mesh,
            max_depth=max_depth, msaa=msaa, use_nee=use_nee,
            trace_fns=trace_fns).cpu().numpy()
        done += batch
    img = total[:n] / float(done)
    return img.reshape(cam.height, cam.width, 3)
