#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from pbrs_tpu_torch/csrc/ and prints what
ptxas reports for them and which host BVH builder runs, checks each kernel
against its plain PyTorch version on the card, renders golden checksums
through the kernels, drives the main paths through the port's routes --
Cornell 1024^2, depth 8, msaa 2 (fused diffuse kernel K2), plates 1024^2,
depth 5, msaa 2 (fused single-lobe kernel K3), the mesh scenes
mesh_ball(levels=5) 800x600, depth 6, and everything 800x800, depth 5,
through the wave path (shade kernel K4) and the general path, both tracing
with the flat trace (K1) and the BVH trace (K5), and the PBRT interior
(scenes/interior/interior.pbrt) 1024^2, depth 5, through K4 and the general
path, plus one timed sample of its 1920x1080, depth-8 cell; msaa 2, PCG
seed 0 -- and runs the CLI. Then the slice of the Sobol' sampler, folded
NEE and the direct integrator (phases 18-24): the Cornell, plates and
interior paths on the Sobol' sampler through K2-Sobol, K3-Sobol and
K4-Sobol and the general path, each held per lane against the general
path; every Sobol' kernel against its plain version; the interior and
mesh_ball through K4 folded and the folded general path beside their
two-arm twins, held per lane; K4 folded against its plain version; and
Cornell 256^2 through the direct integrator (benchmarks.json
cornell_direct_256_16spp) and both visualizers. The fused bounces K2 and
K3 are also replayed on every launch of one main-path sample (phases 3, 7,
19, 20): each bit-equal to its plain version, its device time by bounce
and a sample's, its bound, and the sample again with each piece of the
kernels' design changed alone or built otherwise. Then the Fourier BSDF
and compaction (phases 29-30): fourier_plastic 800x608, depth 5, through
the wave route with the Fourier override (K4 + K1), the general path and
the folded general path masked and compacted, the wave route against the
general path per lane, K4 and K1 bit-equal on its launches; compacted
against masked per lane on fourier_plastic, mesh_ball 800x608 (folded
general) and everything (wave), with K1 / K4 / K5 timed at each bounce's
lane count and held bit-equal on the compacted launches. Then route
auto's tuner (phase 31): the interior 1024^2 depth 5, mesh_ball 800x608
depth 6 and Cornell 1024^2 depth 8, each candidate's ms a launch and the
winner, a cache hit, render_image at its defaults taking the winner's
kernels to the image of the winner's route pinned through
make_integrator bit for bit, and a non-finite candidate raising; and the
CLI's --phase_timings and --profile_dir on Cornell, whose trace names
K2's kernel (phase 32). Then the sharded renderer on 2 ranks sharing
the card through gloo (phase 33): Cornell 1024^2, depth 8, spp 4 through
render_image_sharded (K1) at dp1xsp1, dp2xsp1 and dp1xsp2, and
render_batch_sharded through K2 on Cornell and through K4 (+ K1, K5) on
the interior 1024^2, depth 5, at dp1xsp1 and dp2xsp1, the dp layouts
bit-equal to dp1xsp1 and the sp layout within atol 2e-5 / rtol 1e-4; and
the persistent wavefront (phase 34) on Cornell 1024^2, depth 8 (pools of
N and N/4 lanes) and mesh_ball 800x608, depth 6 (N/4), each against the
masked general path per lane with no more traced rays. Phases that hold
a route pin render_image's compact and nee_mode, so the tuner does not
move them. Every
phase prints one line or more; a failing phase raises, so the script
exits non-zero.
There is no CPU path: without a CUDA device the script fails. The line
before the last is {"kernels": [...]}, one entry per kernel with its
launches on its main path, error against its plain version, device time,
plain time and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import glob
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pbrs_tpu_torch.tools.prof_rounds import PEAK_BYTES, cuda_ms

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_REL_TOL = 2e-3  # tests/test_golden.py REL_TOL
ATOL, RTOL = 2e-5, 1e-4  # tests/test_fused.py:38
K3_ATOL, K3_RTOL = 3e-5, 2e-4  # tests/test_fused_single_lobe.py:73
K4_ATOL, K4_RTOL = 3e-5, 2e-4  # tests/test_fused_wave.py:84-100
# Wave vs general on lanes that reach a Perlin-marble surface (phase 17):
# at most this share of them outside atol K4_ATOL, rtol MARBLE_RTOL. On
# everything at full width 472 of 40479 (1.17%) are outside (NVIDIA H100,
# sample 0; PERF.md section 6): the limit leaves less than 2x room.
MARBLE_RTOL, MARBLE_SHARE = 1e-2, 0.02
# Fused (K2, K3) vs general per lane, phase 18, whatever the sampler: at
# most this share of lanes outside the kernel's atol / rtol, and outside
# rtol 1e-2. Measured on an NVIDIA H100 (PERF.md section 6): Cornell 58
# (PCG) and 80 (Sobol') lanes, plates 574 and 563, of 1048576 (at most
# 0.055%); 68 plates lanes outside rtol 1e-2 (0.0065%).
FUSED_SHARE, FUSED_LOOSE_SHARE = 1e-3, 1e-4
N_RAYS = 1 << 20
SIZE, DEPTH, MSAA = 1024, 8, 2  # bench.py workload
PLATES_DEPTH = 5  # benchmarks.py plates_mis_microfacet_1024
WARMUP, REPS, SAMPLES = 1, 3, 4
# Float operations per primitive of one bank sweep (sphere, quad, triangle,
# disk), counted from csrc/trace_flat.cuh: each add, sub, mul, div, sqrt,
# min/max and comparison is one.
SWEEP_OPS = (58, 64, 91, 34)
# The same count for K5 (csrc/trace_bvh.cu): one conservative node test,
# and one primitive test by family kind (triangle, quad, sphere, disk).
NODE_OPS = 30
PRIM_OPS = (60, 77, 59, 34)
# Lanes a warp at which phases 2, 10 and 13 also time K1 and K5.
CLAIMS = (32, 64, 128)
MESH_LEVELS, MESH_DEPTH, EVERY_DEPTH = 5, 6, 5  # benchmarks.json cells
BVH_SET = 1 << 16  # rays of each K5 parity set
BVH_COUNT_SAMPLE = 4096  # lanes whose walk is counted for K5's bound
SHADOW_SAMPLE = 4096  # needed shadow rays a sweep whose tests are counted
# Published H100 SXM peak of FP32 outside the tensor cores (the HBM3
# bandwidth, PEAK_BYTES, and cuda_ms are prof_rounds', so the probe's Q2
# and its phase here time the same way).
PEAK_FLOPS = 67e12
# render_image's compact and nee_mode pinned: the route make_integrator
# takes, with no tuner (render_path and phases 27-28).
PINNED = {"compact": False, "nee_mode": "twoarm"}


def cornell(size):
    from pbrs_tpu_torch.geometry import camera as cam_mod
    from pbrs_tpu_torch.scene import presets

    cam = cam_mod.looking_at(cam_mod.make_camera((size, size), 40.0),
                             (278, 278, -800), (278, 278, 0), (0, 1, 0))
    return presets.cornell_box().replace(camera=cam)


def random_scene(rng):
    """Four primitives of every family, placed inside the Cornell box."""
    from pbrs_tpu_torch.scene.buffers import SceneBuilder

    b = SceneBuilder()
    m = b.materials.add_lambertian((0.5, 0.5, 0.5))
    g = b.geometry
    p = lambda: rng.uniform(50, 500, 3)  # noqa: E731
    for _ in range(4):
        g.add_sphere(p(), rng.uniform(10, 60), m)
        g.add_quad(p(), rng.normal(size=3) * 80, rng.normal(size=3) * 80, m)
        g.add_triangle(p(), p(), p(), m)
        g.add_disk(p(), rng.normal(size=3), rng.normal(size=3) * 50, m)
    b.camera = cornell(8).camera
    return b.build()


def random_rays(rng, n, dev):
    """Half camera-like rays from outside the box, half rays from inside."""
    from pbrs_tpu_torch.geometry import ray as ray_mod

    h = n // 2
    o = np.concatenate([
        np.asarray([278, 278, -800]) + rng.normal(size=(h, 3)) * 50,
        rng.uniform(5, 550, size=(n - h, 3))]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:h, 2] = np.abs(d[:h, 2]) + 1.0
    return ray_mod.make_rays(torch.from_numpy(o).to(dev),
                             torch.from_numpy(d).to(dev))


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"phase 0 device: torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {name!r} count "
          f"{torch.cuda.device_count()}")
    print(smi)
    return name, smi


def phase_build():
    from pbrs_tpu_torch import kernels

    # Build output goes to build/pbrs_tpu_torch_kernels/, which .gitignore
    # covers through build/.
    cached = kernels.library_path().exists()
    t0 = time.time()
    kernels.lib()
    print(f"phase 1 build: {time.time() - t0:.2f} s "
          f"({'cached' if cached else 'nvcc, one process per source'}) -> "
          f"{os.path.relpath(kernels.library_path(), REPO)}")
    log = kernels.ptxas_log_path()
    if log.exists():
        for line in log.read_text().splitlines():
            if (line.startswith("==") or "registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                print(f"phase 1 ptxas: {line.strip()}")
    frames = bvh_stack_frames()
    print(f"phase 1 K5 stack frame (ptxas): "
          f"{sorted(set(f[1] for f in frames))} B in each of {len(frames)} "
          f"trace_bvh_kernel instantiations; spill stores / loads "
          f"{sorted(set(f[2:] for f in frames))} B")
    if len(frames) != 8 or any(f[1] for f in frames):
        raise AssertionError(f"K5 keeps a stack frame: {frames}")
    fused_kernel_lines()
    k6_kernel_lines()
    from pbrs_tpu_torch.accel import bvh, native

    lo = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    t0 = time.time()
    tree = bvh.build_bvh(lo, lo + 0.1)
    print(f"phase 1 host BVH builder: {tree.builder} ({time.time() - t0:.2f} "
          f"s for 64 boxes, library "
          f"{os.path.relpath(native._SO, REPO) if tree.builder == 'native' else 'none'})")


def fused_kernel_lines():
    """Phase 1's lines for K2 and K3: registers, stack and spills (ptxas),
    resident warps an SM, the window and the static shared arrays (on
    Cornell's and plates' banks). Fails on a spill, or where the bank-row
    ceiling the host routes by differs from the kernels'."""
    from pbrs_tpu_torch import kernels
    from pbrs_tpu_torch.accel import fused_kernel as fk
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl
    from pbrs_tpu_torch.accel import trace_kernel as tk

    dev = torch.device("cuda", 0)
    for name, fn, tab in (
            ("K2", "fused_bounce_kernel",
             fk.FusedTables.from_scene(cornell(8).to(dev))),
            ("K3", "fused_single_lobe_kernel", fsl.SingleLobeTables.from_scene(
                preset_at("plates", 8).to(dev)))):
        stack, spill_st, spill_ld = ptxas_spills(fn)
        info = fk.kernel_info(tab)
        print(f"phase 1 {name} kernel: {info['registers']} registers, {stack} "
              f"B stack, {spill_st} / {spill_ld} B spill stores / loads "
              f"(ptxas); {info['warps_per_sm']} resident warps an SM "
              f"({info['threads']} threads a block, windows of "
              f"{info['window']} lanes, {info['static_smem']} B of static "
              f"shared arrays) with a {tab.bank.shape[0]}-row bank")
        if spill_st or spill_ld:
            raise AssertionError(f"{name} spills: {spill_st} / {spill_ld} B")
    rows = kernels.lib().pbrs_max_bank_rows()
    print(f"phase 1 K2 / K3 bank ceiling: {rows} rows (host "
          f"{tk.MAX_BANK_ROWS})")
    if rows != tk.MAX_BANK_ROWS:
        raise AssertionError("the host's bank-row ceiling is not the "
                             "kernels'")


def bound(bytes_moved, ops):
    """(bound ms, what binds): the larger of bytes over the card's memory
    rate and operations over its FP32 rate."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sweep_ops(counts):
    """Operations of primitive tests, counted by family (spheres, quads,
    triangles, disks): one full sweep over a bank with these counts."""
    return sum(c * o for c, o in zip(counts, SWEEP_OPS))


def at_claims(time_ms):
    """time_ms() with K1 and K5 launched at each of CLAIMS lanes a warp
    (kernels.TRACE_CLAIM takes 32 for a closest hit, 128 for an any hit):
    {lanes a warp: ms}."""
    from pbrs_tpu_torch import kernels

    keep = kernels.TRACE_CLAIM
    out = {}
    try:
        for c in CLAIMS:
            kernels.TRACE_CLAIM = (c, c)
            out[c] = time_ms()
    finally:
        kernels.TRACE_CLAIM = keep
    return out


def claims_text(rows):
    """The mean ms of at_claims results, as '32 / 64 / 128 lanes a warp:
    a / b / c ms'."""
    return (f"{' / '.join(str(c) for c in CLAIMS)} lanes a warp: "
            + " / ".join(f"{sum(r[c] for r in rows) / len(rows):.4f}"
                         for c in CLAIMS) + " ms")


def k1(flat, rays, any_hit=False):
    """K1 launched on a ray batch (flat: trace_kernel.FlatBank)."""
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.geometry import ray as ray_mod

    return tk.trace_planes(flat, ray_mod.to_planes(rays), any_hit)


def k1_reference(bank, counts, rays, chunk=1 << 16):
    """K1's plain version in chunks of rays, so that its [chunk, P]
    broadcast stays small at a 1007-row bank."""
    from pbrs_tpu_torch.accel import trace_kernel as tk

    n = rays.origin.shape[0]
    parts = [tk.trace_reference(bank, counts, ray_take(rays, slice(s, s + chunk)))
             for s in range(0, n, chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def k1_parity(flat, rays, shadow=None):
    """K1 (closest hit on `rays`, any hit on `shadow`, by default the same
    rays) against its plain version: lanes whose id differs, whose t
    differs (rel > 1e-6), whose t is not bit-equal or whose occlusion
    differs; max |dt|; hits."""
    bank, counts = flat.bank, flat.counts
    t_k, id_k = k1(flat, rays)
    t_p, id_p = k1_reference(bank, counts, rays)
    same_id = id_k == id_p
    both = same_id & torch.isfinite(t_k) & torch.isfinite(t_p)
    rel = ((t_k - t_p).abs() / t_p.abs().clamp_min(1e-30))[both]
    err = float((t_k - t_p).abs()[both].max()) if bool(both.any()) else 0.0
    if shadow is None:
        shadow, occ_p = rays, torch.isfinite(t_p)
    else:
        occ_p = torch.isfinite(k1_reference(bank, counts, shadow)[0])
    occ_k = torch.isfinite(k1(flat, shadow, any_hit=True)[0])
    bad = {"id": int((~same_id).sum()), "t": int((rel > 1e-6).sum()),
           "t bits": int((t_k.view(torch.int32)
                          != t_p.view(torch.int32)).sum()),
           "occlusion": int((occ_k != occ_p).sum())}
    return bad, err, int(torch.isfinite(t_p).sum())


def k1_launch_bound(flat, planes, any_hit, rng):
    """(bound ms, what binds, chunk tests, primitive tests) of one K1
    launch: t_max (4 B) and 8 B out a lane, the ray (24 B) of a live lane
    and the packed bank once, against the primitive tests that the host repeat of the chunk-culled sweep
    (trace_kernel.sweep_chunks_reference) needs on BVH_COUNT_SAMPLE of its
    lanes, scaled to all of them. The chunk box tests are the design's own
    culling, not work the function needs: counted, not bounded."""
    from pbrs_tpu_torch.accel import trace_kernel as tk

    n = planes.shape[1]
    idx = torch.from_numpy(rng.choice(n, min(n, BVH_COUNT_SAMPLE),
                                      replace=False)).to(planes.device)
    _, _, chunks, prims = tk.sweep_chunks_reference(
        flat, planes_rays(planes[:, idx]), any_hit=any_hit)
    scale = n / idx.numel()
    live = int((planes[6] > 0).sum())
    ms, by = bound(n * (4 + 8) + live * 6 * 4 + 4 * flat.packed.numel(),
                   scale * sweep_ops(prims))
    return ms, by, scale * chunks, scale * sum(prims)


def phase_trace(dev, rng):
    """K1 vs its plain version on 2^20 rays, closest hit and shadow rays."""
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.geometry import ray as ray_mod

    report = {"max_abs_err": 0.0,
              "per": {"ms": [], "plain_ms": [], "bound_ms": [],
                      "bound_by": [], "claims": []}}
    for label, scene in (("cornell", cornell(8)), ("random", random_scene(rng))):
        scene = scene.to(dev)
        flat = tk.pack_bank(*tk.prim_scalars(scene.geom))
        rays = random_rays(rng, N_RAYS, dev)
        t_max = torch.from_numpy(
            rng.uniform(0.0, 900.0, N_RAYS).astype(np.float32)).to(dev)
        bad, err, hits = k1_parity(flat, rays, rays.replace(t_max=t_max))
        report["max_abs_err"] = max(report["max_abs_err"], err)
        print(f"phase 2 K1 {label}: {N_RAYS} rays, {hits} hits, "
              f"{sum(flat.counts)}-row bank in {sum(flat.chunks)} chunks; id "
              f"differs {bad['id']}, t differs (rel>1e-6) {bad['t']}, t not "
              f"bit-equal {bad['t bits']}, occlusion differs "
              f"{bad['occlusion']}; max |dt| {err:.3g}")
        if any(bad.values()):
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{label}")
        if label == "cornell":
            ms = cuda_ms(lambda: k1(flat, rays), 20)
            plain_ms = cuda_ms(
                lambda: tk.trace_reference(flat.bank, flat.counts, rays), 3)
            planes = ray_mod.to_planes(rays)
            b_ms, b_by, chunks, prims = k1_launch_bound(flat, planes, False,
                                                        rng)
            at = at_claims(lambda: cuda_ms(
                lambda: tk.trace_planes(flat, planes), 20))
    print(f"phase 2 K1 time at {N_RAYS} rays (Cornell): kernel "
          f"{ms:.4f} ms (with to_planes), plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}: {chunks / N_RAYS:.2f} chunk and "
          f"{prims / N_RAYS:.2f} primitive tests a ray); the kernel alone "
          f"at {claims_text([at])}")
    return report


def k1_main_path_means(report):
    """K1's kernels-line numbers: the mean over every main-path launch that
    phases 10 and 13 replayed (mesh_ball's, everything's and the
    interior's banks)."""
    per = report["per"]
    k = len(per["ms"])
    for key in ("ms", "plain_ms", "bound_ms"):
        report[key] = sum(per[key]) / k
    report["bound_by"] = max(set(per["bound_by"]), key=per["bound_by"].count)
    print(f"K1 mean over the {k} main-path launches of phases 10 and 13: "
          f"kernel {report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms, "
          f"bound {report['bound_ms']:.4f} ms (by {report['bound_by']} in "
          f"{per['bound_by'].count(report['bound_by'])} of {k}); at "
          f"{claims_text(per['claims'])}")
    return report


def sky_scene(size, env):
    """An open scene for K2's other branches: two Lambert spheres on a
    floor under the Cornell light, lit by a gradient or constant sky."""
    from pbrs_tpu_torch.lights import lights
    from pbrs_tpu_torch.scene.buffers import SceneBuilder

    b = SceneBuilder()
    white = b.materials.add_lambertian((0.73, 0.73, 0.73))
    red = b.materials.add_lambertian((0.65, 0.05, 0.05))
    light = b.materials.add_diffuse_light((15.0, 15.0, 15.0))
    g = b.geometry
    g.add_quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    g.add_quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)
    g.add_quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light)
    g.add_sphere((190, 90, 190), 90, red)
    g.add_sphere((370, 120, 300), 120, white)
    b.lights.add_area_quad((15.0, 15.0, 15.0), (213, 554, 227), (130, 0, 0),
                           (0, 0, 105))
    b.lights.env = (lights.make_env_gradient((0.5, 0.7, 1.0), (1, 1, 1))
                    if env == "gradient" else
                    lights.make_env_const((0.2, 0.3, 0.4)))
    b.camera = cornell(size).camera
    return b.build()


def sampler_of(rng):
    """Seed 0 of the sampler kind `rng` ("pcg", "sobol", "threefry")."""
    from pbrs_tpu_torch import render

    return render.SAMPLERS[rng](0)


def variant(kernel, rng="pcg", folded=False):
    """A kernel's label in the phase lines: K2, K2-Sobol, K4-folded, ..."""
    return kernel + ("-Sobol" if rng == "sobol" else "") + (
        "-folded" if folded else "")


def any_hit_tests(bank, counts, planes):
    """Primitive tests by family (spheres, quads, triangles, disks) that an
    any-hit sweep (csrc/trace_flat.cuh:sweep<true>) makes on these rays
    (ox, oy, oz, dx, dy, dz, t_max planes), summed: the rows in sweep order
    up to and including its first hit, every row on a miss."""
    from pbrs_tpu_torch.accel import trace_kernel as tk

    ray = [x[:, None] for x in planes]
    hits, start = [], 0
    for fam, c in enumerate(counts):
        if c:
            rows = bank[start:start + c]
            hits.append(tk._family_t(fam, lambda j: rows[:, j][None, :],
                                     *ray) < tk.BIG)
        start += c
    hit = torch.cat(hits, dim=1)
    last = hit.shape[1] - 1
    tested = torch.where(hit.any(1), hit.to(torch.int8).argmax(1), last) + 1
    out, start = [], 0
    for c in counts:
        out.append(int((tested - start).clamp(0, c).sum()))
        start += c
    return out


def shadow_ops(tab, shadow_log, rng):
    """(operations, [rays of each sweep], primitive tests) of the shadow
    sweeps a launch needs: each sweep the plain version logged
    (bounce_reference's shadow_log: the light-sampled arm's, then the
    BSDF-sampled arm's, which the kernels queue), on the lanes whose result
    depends on it, counted to each ray's first hit on SHADOW_SAMPLE of them
    and scaled to all."""
    ops, rays, tests = 0.0, [], 0.0
    for planes, need in shadow_log:
        idx = need.nonzero()[:, 0]
        k = idx.numel()
        rays.append(k)
        if not k:
            continue
        pick = torch.from_numpy(rng.choice(k, min(k, SHADOW_SAMPLE),
                                           replace=False)).to(idx.device)
        prims = any_hit_tests(tab.bank, tab.counts,
                              [x[idx[pick]] for x in planes])
        scale = k / pick.numel()
        ops += scale * sweep_ops(prims)
        tests += scale * sum(prims)
    return ops, rays, tests


def running_warps(alive, window, key=None):
    """The warps that run in a K2 / K3 launch, whose lanes the kernel takes
    in fused_kernel.regroup_reference's order, 32 to a warp: (running
    warps, live share of their slots, warps holding more than one value of
    key [N] (a class a lane; None: not counted))."""
    from pbrs_tpu_torch.accel import fused_kernel as fk

    order = fk.regroup_reference(alive, window)
    pos = (alive[order] > 0).nonzero()[:, 0]
    if not pos.numel():
        return 0, 0.0, 0
    warp = pos // 32
    n_warps = int(torch.unique(warp).numel())
    mixed = None
    if key is not None:
        pair = torch.unique(warp * 64 + key[order[pos]].to(torch.int64))
        mixed = int((torch.unique(pair // 64, return_counts=True)[1] > 1)
                    .sum())
    return n_warps, pos.numel() / (32 * n_warps), mixed


def hit_classes(tab, fin, alive):
    """K3's shading class (fused_single_lobe.shading_class_table) of each
    live lane's closest hit, as K4 would sort it; -1 on dead lanes."""
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl
    from pbrs_tpu_torch.accel import trace_kernel as tk

    table, _ = fsl.shading_class_table(tab)
    table = torch.as_tensor(table, device=fin.device, dtype=torch.int64)
    live = (alive > 0).nonzero()[:, 0]
    f = fin[:, live]
    _, row = tk.sweep_reference(tab.bank, tab.counts, *f[0:6],
                                torch.full_like(f[0], float("inf")))
    mat = tab.bank[row.clamp_min(0), 13].to(torch.int64)
    n_mats = tab.mats.shape[0]
    ok = (row >= 0) & (mat >= 0) & (mat < n_mats)
    key = torch.full_like(alive, -1, dtype=torch.int64)
    key[live] = table[torch.where(ok, mat, n_mats)]
    return key


def sample_launches(dev, kernel, label, scene, depth, rng, phase, report):
    """Every K2 / K3 launch of sample 0 of a main path at full width
    (profiling.fused_launches), each replayed on fresh copies of its
    inputs: bit-equal to its plain version (outputs, alive / spec, traced
    rays), its device ms, the plain version's and its bound. The bound is
    bytes (every lane's planes in and out, a live lane's pixel, sample and
    spec, the tables) over PEAK_BYTES against operations over PEAK_FLOPS:
    the closest-hit sweep of every live lane and the shadow sweeps the
    plain version resolves (shadow_ops). Shading is not counted: the plain
    versions evaluate every lobe kind, light shape and NEE arm the scene
    holds on every lane, so their count would overstate a lane's own path.
    The window's packing is counted (running warps, their live share; for
    K3 the warps holding more than one shading class), not bounded. Sets
    report's per-sample numbers (mean over the launches, their sum)."""
    from pbrs_tpu_torch import profiling
    from pbrs_tpu_torch.accel import fused_kernel as fk
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl

    k2 = kernel == "K2"
    plain = fk.bounce_reference if k2 else fsl.bounce2_reference
    _, wrapper, launches = profiling.fused_launches(scene.to(dev), depth,
                                                    MSAA, sampler_of(rng))
    tab = launches[0][0][0]
    window = fk.kernel_info(tab)["window"]
    tables = sum(t.numel() for t in (
        (tab.bank, tab.mats, tab.lights, tab.env) if k2 else
        (tab.bank, tab.mats, tab.texs, tab.lights, tab.delta, tab.env)))
    nprng = np.random.default_rng(0)
    per = {"ms": [], "plain_ms": [], "bound_ms": [], "bound_by": []}
    name = variant(kernel, rng)
    for b, (args, kw) in enumerate(launches):
        args = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        cnt_k = torch.zeros(1, dtype=torch.int64, device=dev)
        res_k = wrapper(*args[:-1], cnt_k, **kw)
        log = []
        res_p = plain(*args[:-1], **kw, shadow_log=log)
        out_k, out_p = res_k[0], res_p[0]
        ints_k, ints_p = torch.stack(res_k[1:]), torch.stack(res_p[1:-1])
        not_bits = int((out_k.view(torch.int32) != out_p.view(torch.int32))
                       .any(0).sum())
        ints_bad = int((ints_k != ints_p).any(0).sum())
        err = float((out_k - out_p).abs().max())
        report["max_abs_err"] = max(report["max_abs_err"], err)
        fin, alive = args[1], args[2]
        n, live = alive.numel(), int((alive > 0).sum())
        ms = cuda_ms(lambda: profiling.replay(wrapper, args, kw), 20)
        plain_ms = cuda_ms(lambda: plain(*args[:-1], **kw), 3)
        s_ops, s_rays, s_tests = shadow_ops(tab, log, nprng)
        b_ms, b_by = bound(
            n * (9 * 4 + 4 + 12 * 4 + (4 if k2 else 8))
            + live * (8 if k2 else 12) + 4 * tables,
            live * sweep_ops(tab.counts) + s_ops)
        key = None if k2 else hit_classes(tab, fin, alive)
        warps, share, mixed = running_warps(alive, window, key)
        mix = "" if k2 else (f", {mixed} of them ({mixed / max(warps, 1):.1%})"
                             " holding more than one shading class")
        print(f"phase {phase} {name} {label} sample 0 bounce {b}: {n} lanes, "
              f"{live} live; not bit-equal {not_bits}; alive/spec differ "
              f"{ints_bad}; rays kernel {int(cnt_k)} plain {int(res_p[-1])}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; shadow rays needed: {s_rays[0]} "
              f"light-sampled, {s_rays[1]} BSDF-sampled (queued), "
              f"{s_tests / max(sum(s_rays), 1):.2f} primitive tests each); "
              f"{warps} warps run in windows of {window} lanes, "
              f"{share:.1%} of their slots live{mix}")
        if not_bits or ints_bad or int(cnt_k) != int(res_p[-1]):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {label} sample 0 bounce {b}")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("bound_by", b_by)):
            per[k].append(v)
    k = len(launches)
    report["launches_per_sample"] = k
    report["sample_ms"] = sum(per["ms"])
    report["sample_bound_ms"] = sum(per["bound_ms"])
    for key_ in ("ms", "plain_ms", "bound_ms"):
        report[key_] = sum(per[key_]) / k
    report["bound_by"] = max(set(per["bound_by"]), key=per["bound_by"].count)
    print(f"phase {phase} {name} {label} sample 0: {k} launches, device "
          f"{report['sample_ms']:.4f} ms a sample (mean "
          f"{report['ms']:.4f} ms a launch; bounce 0 alone, 20 launches, "
          f"{report['bounce0_ms']:.4f} ms), bound {report['sample_bound_ms']:.4f}"
          f" ms a sample (by {report['bound_by']} in "
          f"{per['bound_by'].count(report['bound_by'])} of {k}), plain mean "
          f"{report['plain_ms']:.4f} ms a launch")


def bounce_parity(dev, scene, label, report, rng="pcg"):
    """K2 vs its plain version on identical planes at bounces 0 and 5 (the
    planes after five plain bounces), drawing `rng`. Returns the bounce-0
    inputs."""
    from pbrs_tpu_torch.accel import fused_kernel as fk
    from pbrs_tpu_torch.integrators import wavefront

    scene = scene.to(dev)
    tab = fk.FusedTables.from_scene(scene)
    sampler = sampler_of(rng)
    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    samp = torch.zeros(n, dtype=torch.int32, device=dev)
    rays = wavefront.camera_rays(scene, sampler, pix, 0, MSAA)
    fin = torch.cat([rays.origin.T, rays.dir.T,
                     torch.ones(3, n, device=dev)]).contiguous()
    alive = torch.ones(n, dtype=torch.int32, device=dev)
    inputs = {}
    for b in range(6):
        kw = dict(seed=sampler.seed, bounce=b, bounce_is_first=b == 0,
                  rr_active=b > 3, rng=rng)
        inputs[b] = (tab, fin, alive, pix, samp, kw)
        fout, alive, _ = fk.bounce_reference(tab, fin, alive, pix, samp, **kw)
        fin = fout[3:].contiguous()
    for b in (0, 5):
        tab, fin, alive_in, pix, samp, kw = inputs[b]
        cnt_k = torch.zeros(1, dtype=torch.int64, device=dev)
        out_k, alive_k = fk.bounce(tab, fin, alive_in, pix, samp, cnt_k, **kw)
        out_p, alive_p, cnt_p = fk.bounce_reference(tab, fin, alive_in, pix,
                                                    samp, **kw)
        close = torch.isclose(out_k, out_p, atol=ATOL, rtol=RTOL).all(dim=0)
        lane_bad = int((~close).sum())
        alive_bad = int((alive_k != alive_p).sum())
        exact_bad = int((out_k != out_p).any(dim=0).sum())
        err = float((out_k - out_p).abs().max())
        report["max_abs_err"] = max(report["max_abs_err"], err)
        live = int((alive_in > 0).sum())
        print(f"phase {report['phase']} {variant('K2', rng)} {label} bounce "
              f"{b}: {n} lanes, {live} alive; "
              f"outside atol {ATOL} rtol {RTOL}: {lane_bad}; alive differs "
              f"{alive_bad}; not bit-equal {exact_bad}; max |d| {err:.3g}; "
              f"rays kernel {int(cnt_k)} plain {int(cnt_p)}")
        if (lane_bad or exact_bad or alive_bad
                or int(cnt_k) != int(cnt_p)):
            raise AssertionError(f"{variant('K2', rng)} disagrees with its "
                                 f"plain version on {label} at bounce {b}")
    return inputs[0]


def phase_bounce(dev, rng="pcg", phase=3):
    """K2 vs its plain version: Cornell at 1024^2 (the main path's shape)
    and the sphere/sky scene at 256^2 with both sky kinds, drawing `rng`;
    K2's device time at Cornell bounce 0 (for a Sobol' run, also its PCG
    twin's on the same planes); then every K2 launch of a Cornell 1024^2
    depth-8 sample, checked and timed (sample_launches)."""
    from pbrs_tpu_torch.accel import fused_kernel as fk
    from pbrs_tpu_torch.accel import trace_kernel as tk

    report = {"max_abs_err": 0.0, "phase": phase}
    tab, fin, alive, pix, samp, kw = bounce_parity(dev, cornell(SIZE),
                                                   "cornell", report, rng)
    for env in ("gradient", "const"):
        bounce_parity(dev, sky_scene(256, env), f"spheres+{env} sky", report,
                      rng)
    # The largest bank K2 takes (shared memory opted in past 48 KB); one row
    # more routes the scene to the general path.
    big = many_spheres_scene(128, tk.MAX_BANK_ROWS, True)
    over = many_spheres_scene(8, tk.MAX_BANK_ROWS + 1, True)
    if not fk.scene_supports_fused(big) or fk.scene_supports_fused(over):
        raise AssertionError("K2's eligibility does not follow its bank "
                             f"ceiling of {tk.MAX_BANK_ROWS} rows")
    bounce_parity(dev, big, f"{tk.MAX_BANK_ROWS}-row bank", report, rng)
    cnt = torch.zeros(1, dtype=torch.int64, device=dev)
    report["bounce0_ms"] = cuda_ms(
        lambda: fk.bounce(tab, fin, alive, pix, samp, cnt, **kw), 20)
    if rng != "pcg":
        report["twin_ms"] = cuda_ms(lambda: fk.bounce(
            tab, fin, alive, pix, samp, cnt, **{**kw, "rng": "pcg"}), 20)
    twin = (f", PCG twin on the same planes {report['twin_ms']:.4f} ms"
            if "twin_ms" in report else "")
    print(f"phase {phase} {variant('K2', rng)} time at {fin.shape[1]} lanes "
          f"(Cornell bounce 0, 20 launches): kernel "
          f"{report['bounce0_ms']:.4f} ms{twin}")
    sample_launches(dev, "K2", "Cornell", cornell(SIZE), DEPTH, rng, phase,
                    report)
    return report


def phase_golden(dev):
    """tests/test_golden.py's Cornell checksum through K2 and through K1."""
    from pbrs_tpu_torch import cli, render
    from pbrs_tpu_torch.core import sampler as smp
    from pbrs_tpu_torch.scene import presets

    with open(os.path.join(REPO, "tests", "golden_checksums.json")) as f:
        want = json.load(f)["cornell_box"]
    scene = cli.with_resolution(presets.cornell_box(), 48, 48).to(dev)
    pix = torch.arange(48 * 48, dtype=torch.int32, device=dev)
    for route in ("auto", "general"):
        name, fn = render.make_integrator(scene, smp.PCGSampler(0), 4, 2,
                                          route)
        got = sum(float(fn(pix, s)[0].sum()) for s in range(2))
        rel = abs(got - want) / abs(want)
        print(f"phase 4 golden via {name}: {got:.6f} vs {want:.6f} "
              f"(rel {rel:.2e})")
        if rel > GOLDEN_REL_TOL:
            raise AssertionError(f"golden checksum via {name} drifted")


def run_main_path(scene, route, pix, depth=DEPTH, reps=REPS, sampler="pcg",
                  msaa=MSAA, **kw):
    """bench.py's timing loop: 1 warm-up sample, then reps x SAMPLES, on
    seed 0 of `sampler`; kw goes to render.make_integrator. Returns (name,
    median Mrays/s, median ms/sample, checksum of the first rep, traced
    segments a sample in the first rep)."""
    from pbrs_tpu_torch import render

    name, step = render.make_integrator(scene, sampler_of(sampler), depth,
                                        msaa, route, **kw)
    for s in range(WARMUP):
        step(pix, s)
    torch.cuda.synchronize()
    rates, walls, checksum, first = [], [], 0.0, 0
    for rep in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        rays = 0
        base = WARMUP + rep * SAMPLES
        for s in range(base, base + SAMPLES):
            rad, cnt = step(pix, s)
            total = float(rad.sum())  # synchronizes
            if rep == 0:
                checksum += total
            rays += int(cnt)
        torch.cuda.synchronize()
        dt = time.time() - t0
        rates.append(rays / dt / 1e6)
        walls.append(dt / SAMPLES)
        first = first or rays // SAMPLES
    med = sorted(rates)[reps // 2]
    return name, med, sorted(walls)[reps // 2], checksum, first


def phase_main(dev, smi):
    from pbrs_tpu_torch.accel import fused_kernel as fk
    from pbrs_tpu_torch.accel import trace_kernel as tk

    scene = cornell(SIZE).to(dev)
    pix = torch.arange(SIZE * SIZE, dtype=torch.int32, device=dev)
    results = {}
    tk.LAUNCHES = 0
    fk.LAUNCHES = 0
    for route in ("auto", "general"):
        results[route] = run_main_path(scene, route, pix)
    launches = {"trace_flat": tk.LAUNCHES, "fused_bounce": fk.LAUNCHES}
    results["plain"] = run_main_path(scene, "plain", pix)
    for route, (name, mrays, wall, checksum, _) in results.items():
        print(f"phase 5 main path {route} -> {name}: Cornell {SIZE}^2 depth "
              f"{DEPTH} msaa {MSAA}: median {mrays:.3f} Mrays/s, "
              f"{wall * 1e3:.2f} ms/sample, checksum {checksum:.6e} "
              f"[{smi}]")
    print(f"phase 5 launches: K1 trace_flat {launches['trace_flat']}, K2 "
          f"fused_bounce {launches['fused_bounce']}")
    if results["auto"][0] != "fused":
        raise AssertionError("the main path did not take the fused kernel")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    sums = [r[3] for r in results.values()]
    if max(sums) - min(sums) > GOLDEN_REL_TOL * abs(sums[0]):
        raise AssertionError(f"routes disagree on the checksum: {sums}")
    return launches


def phase_cli():
    from pbrs_tpu_torch import cli
    from pbrs_tpu_torch.io import image

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.exr")
        rc = cli.main(["--scene_name", "cornell_box", "--resolution",
                       "256x256", "--msaa", "2", "--depth", "5", "--output",
                       out])
        img = image.read_exr(out)
    ok = rc == 0 and img.shape == (256, 256, 3) and bool(
        np.isfinite(img).all()) and float(img.mean()) > 0
    print(f"phase 6 cli: rc {rc}, image {img.shape}, mean {img.mean():.5f}")
    if not ok:
        raise AssertionError("the CLI render is not a finite, lit image")
    # The interior through the CLI's --pbrt_file, on route auto (K4), the
    # tuner pinned off by --compact off --nee_mode twoarm.
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "interior.png")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = cli.main(["--pbrt_file", os.path.join(
                REPO, "scenes", "interior", "interior.pbrt"), "--resolution",
                "480x270", "--msaa", "1", "--depth", "5", "--compact", "off",
                "--nee_mode", "twoarm", "--output", out])
        img = image.read_png(out)
    last = said.getvalue().strip().splitlines()[-2]
    print(f"phase 6 cli --pbrt_file interior: rc {rc}, image {img.shape}, "
          f"mean {img.mean():.3f}; {last}")
    if (rc != 0 or img.shape != (270, 480, 3) or float(img.mean()) <= 0
            or "fused_wave path" not in last):
        raise AssertionError("the CLI's interior render did not go through "
                             "K4 to a lit image")
    # The direct integrator on the Sobol' sampler through the CLI.
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "direct.exr")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = cli.main(["--scene_name", "cornell_box", "--resolution",
                           "128x128", "--msaa", "2", "--depth", "2",
                           "--integrator", "direct", "--sampler", "sobol",
                           "--output", out])
        img = image.read_exr(out)
    last = said.getvalue().strip().splitlines()[-2]
    print(f"phase 6 cli --integrator direct --sampler sobol: rc {rc}, image "
          f"{img.shape}, mean {img.mean():.5f}; {last}")
    if (rc != 0 or img.shape != (128, 128, 3) or float(img.mean()) <= 0
            or "direct path" not in last):
        raise AssertionError("the CLI's direct Sobol' render is not a finite, "
                             "lit image")


# ---------------------- K3: the fused single-lobe bounce ---------------------


def _view(b, size, fov, eye, look):
    from pbrs_tpu_torch.geometry import camera as cam_mod

    b.camera = cam_mod.looking_at(cam_mod.make_camera((size, size), fov), eye,
                                  look, (0, 1, 0))
    return b.build()


def zoo_scene(size):
    """Every single-lobe kind, point + distant lights, a quad light, a blue
    sky, a triangle and a disk (tests/test_fused_single_lobe.py:18-45)."""
    from pbrs_tpu_torch.scene import presets
    from pbrs_tpu_torch.scene.buffers import SceneBuilder

    b = SceneBuilder()
    g, m = b.geometry, b.materials
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               m.add_lambertian((0.6, 0.55, 0.5)))
    g.add_sphere((-4.5, 1, 0), 1.0,
                 m.add_metal(presets.GOLD[0], presets.GOLD[1], 0.2))
    g.add_sphere((-1.5, 1, 0), 1.0, m.add_glossy((0.8, 0.8, 0.9), 0.05))
    g.add_sphere((1.5, 1, 0), 1.0, m.add_mirror((0.95, 0.95, 0.95)))
    g.add_sphere((4.5, 1, 0), 1.0, m.add_dielectric(1.5))
    red = m.add_lambertian((0.7, 0.2, 0.2))
    g.add_triangle((-3, 0.01, -4), (0, 0.01, -2), (-1.5, 2.5, -3), red)
    g.add_disk((2.5, 1.2, -3.5), (0, 0.3, -1), (1.2, 0, 0), red)
    light_c = (6.0, 6.0, 6.0)
    g.add_quad((-2, 7, -2), (4, 0, 0), (0, 0, 4), m.add_diffuse_light(light_c))
    b.lights.add_area_quad(light_c, (-2, 7, -2), (4, 0, 0), (0, 0, 4))
    b.lights.add_point((6, 5, -6), (40, 35, 30))
    b.lights.add_distant((0.3, -1.0, 0.2), (0.5, 0.5, 0.55))
    b.lights.env = presets.BLUE_SKY
    return _view(b, size, 45.0, (0, 4, -14), (0, 1.5, 0))


def shaped_lights_scene(size):
    """Sphere, disk and triangle area lights over glossy and Lambert
    geometry (tests/test_fused_single_lobe.py:92-119)."""
    from pbrs_tpu_torch.scene.buffers import SceneBuilder

    b = SceneBuilder()
    g, m, lights = b.geometry, b.materials, b.lights
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               m.add_lambertian((0.55, 0.55, 0.6)))
    g.add_sphere((-2, 1, 0), 1.0, m.add_glossy((0.85, 0.8, 0.7), 0.03))
    g.add_sphere((2, 1, 0), 1.0, m.add_lambertian((0.3, 0.5, 0.7)))
    c1, c2, c3 = (8.0, 7.0, 6.0), (5.0, 6.0, 8.0), (7.0, 7.0, 5.0)
    g.add_sphere((-4, 5, -3), 0.8, m.add_diffuse_light(c1))
    lights.add_area_sphere(c1, (-4, 5, -3), 0.8)
    g.add_disk((4, 6, -2), (0, -1, 0.2), (1.5, 0, 0), m.add_diffuse_light(c2))
    lights.add_area_disk(c2, (4, 6, -2), (0, -1, 0.2), (1.5, 0, 0))
    g.add_triangle((-1, 7, 2), (1, 7, 2), (0, 7, 4), m.add_diffuse_light(c3))
    lights.add_area_triangle(c3, (-1, 7, 2), (1, 7, 2), (0, 7, 4))
    return _view(b, size, 45.0, (0, 4, -12), (0, 1.5, 0))


def plastic_scene(size):
    """Two-lobe mixtures: plastic and default uber
    (tests/test_fused_single_lobe.py:129-146)."""
    from pbrs_tpu_torch.scene import presets
    from pbrs_tpu_torch.scene.buffers import SceneBuilder

    b = SceneBuilder()
    g, m = b.geometry, b.materials
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               m.add_lambertian((0.6, 0.6, 0.55)))
    g.add_sphere((-2, 1, 0), 1.0,
                 m.add_plastic((0.5, 0.15, 0.12), (0.7, 0.7, 0.7), 0.08))
    g.add_sphere((2, 1, 0), 1.0, m.add_uber((0.2, 0.35, 0.55),
                                            (0.5, 0.5, 0.5), roughness=0.15))
    light_c = (9.0, 9.0, 9.0)
    g.add_quad((-2, 6, -2), (4, 0, 0), (0, 0, 4), m.add_diffuse_light(light_c))
    b.lights.add_area_quad(light_c, (-2, 6, -2), (4, 0, 0), (0, 0, 4))
    b.lights.env = presets.BLUE_SKY
    return _view(b, size, 45.0, (0, 4, -10), (0, 1, 0))


def many_spheres_scene(size, n_rows, lambert_only):
    """A floor, a quad light and n_rows - 4 small spheres on a grid, so the
    bank has n_rows rows (the empty triangle and disk families hold a
    padding row each): Lambert spheres (a K2 scene) or spheres cycling
    through Lambert, glossy, metal, mirror and glass (a K3 scene)."""
    from pbrs_tpu_torch.scene import presets
    from pbrs_tpu_torch.scene.buffers import SceneBuilder

    b = SceneBuilder()
    g, m = b.geometry, b.materials
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               m.add_lambertian((0.6, 0.55, 0.5)))
    mats = [m.add_lambertian((0.7, 0.3, 0.2)),
            m.add_lambertian((0.2, 0.5, 0.7))]
    if not lambert_only:
        mats += [m.add_glossy((0.8, 0.8, 0.9), 0.05),
                 m.add_metal(presets.GOLD[0], presets.GOLD[1], 0.2),
                 m.add_mirror((0.95, 0.95, 0.95)), m.add_dielectric(1.5)]
    n = n_rows - 4
    side = int(np.ceil(np.sqrt(n)))
    step = 20.0 / side
    for i in range(n):
        x, z = -10 + step * (i % side + 0.5), -10 + step * (i // side + 0.5)
        g.add_sphere((x, 0.4 * step, z), 0.4 * step, mats[i % len(mats)])
    light_c = (6.0, 6.0, 6.0)
    g.add_quad((-2, 7, -2), (4, 0, 0), (0, 0, 4), m.add_diffuse_light(light_c))
    b.lights.add_area_quad(light_c, (-2, 7, -2), (4, 0, 0), (0, 0, 4))
    return _view(b, size, 50.0, (0, 9, -15), (0, 0, 0))


def textured_scene(size):
    """Checker floor, Perlin-marble and solid-texture spheres
    (tests/test_fused_single_lobe.py:225-245)."""
    from pbrs_tpu_torch.scene import presets
    from pbrs_tpu_torch.scene.buffers import SceneBuilder

    b = SceneBuilder()
    g, m, t = b.geometry, b.materials, b.textures
    checker = t.add_checker((0.8, 0.2, 0.2), (0.9, 0.9, 0.85))
    perlin = t.add_perlin(2.0)
    solid = t.add_solid((0.2, 0.6, 0.3))
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               m.add_matte(tex_id=checker))
    g.add_sphere((-1.5, 1, 0), 1.0, m.add_matte(tex_id=perlin))
    g.add_sphere((1.5, 1, 0), 1.0, m.add_matte(tex_id=solid))
    light_c = (6.0, 6.0, 6.0)
    g.add_quad((-2, 7, -2), (4, 0, 0), (0, 0, 4), m.add_diffuse_light(light_c))
    b.lights.add_area_quad(light_c, (-2, 7, -2), (4, 0, 0), (0, 0, 4))
    b.lights.env = presets.BLUE_SKY
    return _view(b, size, 45.0, (0, 3, -10), (0, 1, 0))


def preset_at(name, w, h=None):
    from pbrs_tpu_torch import cli
    from pbrs_tpu_torch.scene import presets

    return cli.with_resolution(presets.PRESETS[name](), w, h or w)


def k3_inputs(dev, scene, bounce, rng="pcg"):
    """The K3 tables and the bounce-`bounce` input planes of a scene, reached
    through the plain version from sample 0's camera rays, drawing `rng`."""
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl
    from pbrs_tpu_torch.integrators import wavefront

    scene = scene.to(dev)
    if not fsl.scene_supports_single_lobe(scene):
        raise AssertionError("a K3 test scene is not single-lobe eligible")
    tab = fsl.SingleLobeTables.from_scene(scene)
    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    samp = torch.zeros(n, dtype=torch.int32, device=dev)
    rays = wavefront.camera_rays(scene, sampler_of(rng), pix, 0, MSAA)
    fin = torch.cat([rays.origin.T, rays.dir.T,
                     torch.ones(3, n, device=dev)]).contiguous()
    alive = torch.ones(n, dtype=torch.int32, device=dev)
    spec = torch.zeros(n, dtype=torch.int32, device=dev)
    for b in range(bounce + 1):
        kw = dict(seed=0, bounce=b, bounce_is_first=b == 0, rr_active=b > 3,
                  rng=rng)
        if b == bounce:
            return tab, (fin, alive, spec, pix, samp), kw
        fout, alive, spec, _ = fsl.bounce2_reference(tab, fin, alive, spec,
                                                     pix, samp, **kw)
        fin = fout[3:].contiguous()


def k3_parity(dev, label, scene, bounce, report, rng="pcg"):
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl

    tab, lanes, kw = k3_inputs(dev, scene, bounce, rng)
    fin, alive_in = lanes[0], lanes[1]
    cnt_k = torch.zeros(1, dtype=torch.int64, device=dev)
    out_k, alive_k, spec_k = fsl.bounce2(tab, *lanes, cnt_k, **kw)
    out_p, alive_p, spec_p, cnt_p = fsl.bounce2_reference(tab, *lanes, **kw)
    torch.cuda.synchronize()
    n = fin.shape[1]
    close = torch.isclose(out_k, out_p, atol=K3_ATOL, rtol=K3_RTOL).all(dim=0)
    lane_bad = int((~close).sum())
    alive_bad = int((alive_k != alive_p).sum()) + int((spec_k != spec_p).sum())
    exact_bad = int((out_k != out_p).any(dim=0).sum())
    err = float((out_k - out_p).abs().max())
    report["max_abs_err"] = max(report["max_abs_err"], err)
    print(f"phase {report['phase']} {variant('K3', rng)} {label} bounce "
          f"{bounce}: {n} lanes, "
          f"{int((alive_in > 0).sum())} alive; outside atol {K3_ATOL} rtol "
          f"{K3_RTOL}: {lane_bad}; alive/spec differ {alive_bad}; not "
          f"bit-equal {exact_bad}; max |d| {err:.3g}; rays kernel "
          f"{int(cnt_k)} plain {int(cnt_p)}")
    if lane_bad or exact_bad or alive_bad or int(cnt_k) != int(cnt_p):
        raise AssertionError(f"{variant('K3', rng)} disagrees with its plain "
                             f"version on {label} at bounce {bounce}")
    return tab, lanes, kw


def phase_single_lobe(dev, rng="pcg", phase=7):
    """K3 vs its plain version: plates at 1024^2 (the main path's shape) at
    bounces 0 and 2, then seven scenes at 256^2 that take K3's other
    branches or a 300-row bank, at bounces 0 and 1, drawing `rng`; K3's
    device time at plates bounce 0 (and, for Sobol', the PCG twin's on the
    same planes); then every K3 launch of a plates 1024^2 depth-5 sample,
    checked and timed (sample_launches)."""
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl

    report = {"max_abs_err": 0.0, "phase": phase}
    plates = preset_at("plates", SIZE)
    tab, lanes, kw = k3_parity(dev, "plates", plates, 0, report, rng)
    k3_parity(dev, "plates", plates, 2, report, rng)
    # Bounce 1 too: dead lanes and warps of mixed shading class, which the
    # window and the class sort regroup. The 300-row bank opts in to shared
    # memory past 48 KB.
    for label, scene in (("zoo", zoo_scene(256)),
                         ("plastic/uber", plastic_scene(256)),
                         ("textured", textured_scene(256)),
                         ("shaped lights", shaped_lights_scene(256)),
                         ("env_mapped", preset_at("env_mapped", 256)),
                         ("mixed_spheres", preset_at("mixed_spheres", 256)),
                         ("300-row bank", many_spheres_scene(256, 300,
                                                             False))):
        for b in (0, 1):
            k3_parity(dev, label, scene, b, report, rng)
    cnt = torch.zeros(1, dtype=torch.int64, device=dev)
    report["bounce0_ms"] = cuda_ms(
        lambda: fsl.bounce2(tab, *lanes, cnt, **kw), 20)
    if rng != "pcg":
        report["twin_ms"] = cuda_ms(lambda: fsl.bounce2(
            tab, *lanes, cnt, **{**kw, "rng": "pcg"}), 20)
    twin = (f", PCG twin on the same planes {report['twin_ms']:.4f} ms"
            if "twin_ms" in report else "")
    print(f"phase {phase} {variant('K3', rng)} time at {lanes[0].shape[1]} "
          f"lanes (plates bounce 0, 20 launches): kernel "
          f"{report['bounce0_ms']:.4f} ms{twin}")
    sample_launches(dev, "K3", "plates", plates, PLATES_DEPTH, rng, phase,
                    report)
    return report


def phase_single_lobe_golden(dev):
    """tests/test_golden.py's 48^2 checksums of the single-lobe scenes
    through K3 (route auto) and through the general path (K1)."""
    from pbrs_tpu_torch import render
    from pbrs_tpu_torch.core import sampler as smp

    with open(os.path.join(REPO, "tests", "golden_checksums.json")) as f:
        golden = json.load(f)
    for key, name, depth in (("plates", "plates", 4),
                             ("two_perlin", "two_perlin_spheres", 4),
                             ("env_mapped", "env_mapped", 4),
                             ("mixed_spheres", "mixed_spheres", 3)):
        scene = preset_at(name, 48).to(dev)
        pix = torch.arange(48 * 48, dtype=torch.int32, device=dev)
        for route in ("auto", "general"):
            got_name, fn = render.make_integrator(
                scene, smp.PCGSampler(0), depth, 2, route)
            got = sum(float(fn(pix, s)[0].sum()) for s in range(2))
            rel = abs(got - golden[key]) / abs(golden[key])
            print(f"phase 8 golden {key} via {got_name}: {got:.6f} vs "
                  f"{golden[key]:.6f} (rel {rel:.2e})")
            if route == "auto" and got_name != "fused_single_lobe":
                raise AssertionError(f"{key} did not take K3")
            if rel > GOLDEN_REL_TOL:
                raise AssertionError(f"golden {key} via {got_name} drifted")


def phase_plates_main(dev, smi):
    """The slice's main path: plates 1024^2, depth 5, msaa 2, PCG seed 0,
    through the auto (K3), general (K1) and plain routes."""
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl
    from pbrs_tpu_torch.accel import trace_kernel as tk

    scene = preset_at("plates", SIZE).to(dev)
    pix = torch.arange(SIZE * SIZE, dtype=torch.int32, device=dev)
    results = {}
    tk.LAUNCHES = 0
    fsl.LAUNCHES = 0
    for route in ("auto", "general"):
        results[route] = run_main_path(scene, route, pix, PLATES_DEPTH)
    launches = {"trace_flat": tk.LAUNCHES, "fused_single_lobe": fsl.LAUNCHES}
    results["plain"] = run_main_path(scene, "plain", pix, PLATES_DEPTH,
                                     reps=1)
    for route, (name, mrays, wall, checksum, _) in results.items():
        print(f"phase 9 main path {route} -> {name}: plates {SIZE}^2 depth "
              f"{PLATES_DEPTH} msaa {MSAA}: median {mrays:.3f} Mrays/s, "
              f"{wall * 1e3:.2f} ms/sample, checksum {checksum:.6e} "
              f"[{smi}]")
    print(f"phase 9 launches: K3 fused_single_lobe "
          f"{launches['fused_single_lobe']}, K1 trace_flat "
          f"{launches['trace_flat']}")
    if results["auto"][0] != "fused_single_lobe":
        raise AssertionError("the plates main path did not take K3")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    sums = [r[3] for r in results.values()]
    if max(sums) - min(sums) > GOLDEN_REL_TOL * abs(sums[0]):
        raise AssertionError(f"routes disagree on the checksum: {sums}")
    return launches


# ------------------------- K5: the BVH family trace --------------------------


def mesh_scene(name):
    """The full-width mesh scenes of the slice (benchmarks.json
    mesh_ball_bvh_800x600 and everything_3400prims_800)."""
    from pbrs_tpu_torch.scene import presets

    if name == "mesh_ball":
        return presets.mesh_ball(levels=MESH_LEVELS)
    return presets.everything()


def main_path_launches(dev, scene, depth, rng="pcg", nee_mode="twoarm",
                       route="auto", compact=False):
    """Every K1, K4 and K5 launch of sample 0 of a scene's main path (route
    `route`, at full width, sampler `rng`, NEE `nee_mode`, compacted to the
    measured schedule with `compact`), kept with its inputs: {"k1":
    [(packed bank, planes, any_hit)], "k5": [(family tracer, planes,
    any_hit, t_in, id_in)], "k4": [(tables, fin, iin, keywords)]}."""
    from pbrs_tpu_torch import render
    from pbrs_tpu_torch.accel import fused_wave as fw
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.accel import treelet as tl

    seen = {"k1": [], "k5": [], "k4": []}
    launch_k1, launch_k5, launch_k4 = (tk.trace_planes, tl.trace_planes,
                                       fw.shade)

    def record_k1(flat, planes, any_hit=False):
        seen["k1"].append((flat, planes, any_hit))
        return launch_k1(flat, planes, any_hit)

    def record_k5(fam, planes, any_hit=False, t_in=None, id_in=None):
        # K5 merges into the running hit in place: keep it as handed over.
        seen["k5"].append((fam, planes, any_hit, clone(t_in), clone(id_in)))
        return launch_k5(fam, planes, any_hit, t_in, id_in)

    def record_k4(tab, fin, iin, count, **kw):
        seen["k4"].append((tab, fin, iin, kw))
        return launch_k4(tab, fin, iin, count, **kw)

    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    _, step = render.make_integrator(scene, sampler_of(rng), depth, MSAA,
                                     route, nee_mode=nee_mode,
                                     compact_pilot=pix if compact else None)
    tk.trace_planes, tl.trace_planes, fw.shade = (record_k1, record_k5,
                                                   record_k4)
    try:
        step(pix, 0)
        torch.cuda.synchronize()
    finally:
        tk.trace_planes, tl.trace_planes, fw.shade = (launch_k1, launch_k5,
                                                      launch_k4)
    return seen


def clone(x):
    return None if x is None else x.clone()


def planes_rays(planes):
    from pbrs_tpu_torch.geometry import ray as ray_mod

    return ray_mod.RayBatch(planes[0:3].T, planes[3:6].T, planes[6])


def ray_take(rays, idx):
    return rays.replace(origin=rays.origin[idx], dir=rays.dir[idx],
                        t_max=rays.t_max[idx])


def box_rays(rng, n, lo, hi, dev, scale):
    """Random rays from a box, 30% of them bounded and 5% dead."""
    from pbrs_tpu_torch.geometry import ray as ray_mod

    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    t_max = np.full(n, np.inf, np.float32)
    k = int(0.3 * n)
    t_max[:k] = rng.uniform(0.0, 2.0 * scale, k)
    t_max[k:k + n // 20] = 0.0
    return ray_mod.make_rays(*(torch.from_numpy(x).to(dev)
                               for x in (o, d, t_max)))


def bvh_compare(fam, rays, t_in=None, id_in=None):
    """K5 (closest and any hit, seeded with the running hit t_in / id_in
    when given) against its plain version on one ray set: counts of lanes
    whose t is not bit-equal, whose id or hit mask differs, or whose
    any-hit mask differs from the closest hit's; max |dt|; hits; the plain
    version's device ms."""
    from pbrs_tpu_torch.accel import treelet as tl

    t_k, id_k = fam.trace(rays, False, clone(t_in), clone(id_in))
    t_a, _ = fam.trace(rays, True, clone(t_in), clone(id_in))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t_p, id_p = tl.trace_reference(fam, rays, t_in, id_in)
    end.record()
    torch.cuda.synchronize()
    hit_p = torch.isfinite(t_p)
    bad = {"t": int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum()),
           "id": int((id_k != id_p).sum()),
           "hit": int((torch.isfinite(t_k) != hit_p).sum()),
           "any-hit": int((torch.isfinite(t_a) != hit_p).sum())}
    fin = hit_p & torch.isfinite(t_k)
    err = float((t_k - t_p).abs()[fin].max()) if bool(fin.any()) else 0.0
    return bad, err, int(hit_p.sum()), start.elapsed_time(end)


def seed_take(x, idx):
    return None if x is None else x[idx]


def k5_ms(fam, planes, any_hit, t_in, id_in, iters=5):
    """K5's device ms a launch as the main path ran it: merging into a
    fresh copy of the running hit each time (cuda_ms calls it iters + 1
    times), since a launch merges in place."""
    from pbrs_tpu_torch.accel import treelet as tl

    seeds = iter([(clone(t_in), clone(id_in)) for _ in range(iters + 1)])
    return cuda_ms(lambda: tl.trace_planes(fam, planes, any_hit,
                                           *next(seeds)), iters)


def bvh_launch_bound(fam, planes, any_hit, rng, t_in=None, id_in=None):
    """(bound ms, what binds, node tests, primitive tests) of one K5 launch:
    28 B in (36 with a running hit) and 8 B out a lane and the tables once,
    against the node and primitive tests that the host walk of
    BVH_COUNT_SAMPLE of its lanes needs, scaled to all of them."""
    from pbrs_tpu_torch.accel import treelet as tl

    n = planes.shape[1]
    idx = torch.from_numpy(rng.choice(n, min(n, BVH_COUNT_SAMPLE),
                                      replace=False)).to(planes.device)
    _, _, nodes, prims = tl.traverse_reference(
        fam, planes_rays(planes[:, idx]), any_hit, seed_take(t_in, idx),
        seed_take(id_in, idx))
    scale = n / idx.numel()
    tables = 4 * (fam.nodes.numel() + fam.fields.numel()
                  + fam.slot_gid.numel())
    lane_bytes = 7 * 4 + 8 + (0 if t_in is None else 8)
    ms, by = bound(n * lane_bytes + tables,
                   scale * (nodes * NODE_OPS + prims * PRIM_OPS[fam.kind]))
    return ms, by, scale * nodes, scale * prims


def replay_k1(label, launches, k1_report, rng):
    """Every K1 launch of a main-path sample (packed bank, planes, any hit)
    replayed against the plain version, closest and any hit each; then
    K1's device time per launch on that bank (CUDA events over 5 replays of
    each launch as it ran), its plain time and its bound, added to
    k1_report's main-path lists."""
    from pbrs_tpu_torch.accel import trace_kernel as tk

    bad = {"id": 0, "t": 0, "t bits": 0, "occlusion": 0}
    for flat, planes, _ in launches:
        got, err, _ = k1_parity(flat, planes_rays(planes))
        bad = {k: bad[k] + got[k] for k in bad}
        k1_report["max_abs_err"] = max(k1_report["max_abs_err"], err)
    flat = launches[0][0]
    print(f"{label} main path, sample 0: {len(launches)} launches of "
          f"{sorted({p.shape[1] for _, p, _ in launches})} lanes on a "
          f"{sum(flat.counts)}-row bank (counts {flat.counts}, chunks "
          f"{flat.chunks}, {4 * flat.packed.numel()} B packed), closest and "
          f"any hit each; lanes differing: id {bad['id']}, t (rel>1e-6) "
          f"{bad['t']}, t not bit-equal {bad['t bits']}, occlusion "
          f"{bad['occlusion']}")
    if any(bad.values()):
        raise AssertionError(f"K1 disagrees with its plain version: {label}")
    rows = []
    for flat, planes, any_hit in launches:
        ms = cuda_ms(lambda: tk.trace_planes(flat, planes, any_hit), 5)
        plain_ms = cuda_ms(lambda: k1_reference(flat.bank, flat.counts,
                                                planes_rays(planes)), 1)
        b_ms, b_by, chunks, prims = k1_launch_bound(flat, planes, any_hit,
                                                    rng)
        at = at_claims(lambda: cuda_ms(
            lambda: tk.trace_planes(flat, planes, any_hit), 5))
        live = int((planes[6] > 0).sum())
        rows.append((ms, plain_ms, b_ms, at))
        for key, v in zip(("ms", "plain_ms", "bound_ms", "bound_by",
                           "claims"), (ms, plain_ms, b_ms, b_by, at)):
            k1_report["per"][key].append(v)
        print(f"{label} launch {len(rows) - 1} "
              f"{'any hit' if any_hit else 'closest'}: {planes.shape[1]} "
              f"lanes, {live} live; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"{chunks / max(live, 1):.2f} chunk and "
              f"{prims / max(live, 1):.2f} primitive tests a live lane; at "
              f"{claims_text([at])}")
    k = len(rows)
    print(f"{label} on its {sum(flat.counts)}-row bank: {k} launches, "
          f"kernel {sum(r[0] for r in rows) / k:.4f} ms a launch "
          f"({sum(r[0] for r in rows):.4f} ms a sample), plain "
          f"{sum(r[1] for r in rows) / k:.4f} ms, bound "
          f"{sum(r[2] for r in rows) / k:.4f} ms; at "
          f"{claims_text([r[3] for r in rows])}")


def crafted_seed(t, ids, rng):
    """A running hit per lane for K5's seeded walk: a miss, a hit nearer or
    farther than the family's own (t, ids), or one at exactly its t with a
    lower or a higher id (the flat-vs-family ties of the tracer)."""
    n = t.shape[0]
    dev = t.device
    pick = torch.from_numpy(rng.integers(0, 5, n)).to(dev)
    base = torch.where(torch.isfinite(t), t, torch.full_like(t, 5.0))
    t_in = torch.stack([torch.full_like(t, float("inf")), base * 0.5,
                        base * 2.0, base, base])
    id_in = torch.tensor([-1, 1, 2, 0, 2**30], dtype=torch.int32,
                         device=dev)[pick]
    return t_in.gather(0, pick[None]).squeeze(0).contiguous(), id_in


def phase_bvh(dev, rng, k1_report):
    """K5 vs its plain version on the card: random rays against the
    mesh_ball(levels=5) triangles, everything's quads, 2048 random spheres
    and 2048 random disks, each unseeded and seeded with a crafted running
    hit (ties at equal t included), then every K5 and K1 launch of one
    sample of each mesh scene's main path at full width (K5 seeded with the
    running hit it was handed), replayed against the plain versions. K5's
    device time, plain time and bound per launch over those launches; K5's
    time at 2^20 mesh_ball camera + bounce-1 lanes; K1's time, plain time
    and bound per launch on each bank; K1 on everything's bank beside
    Cornell's, and everything's 1005 spheres as a K5 sphere family beside
    K1 on the same planes."""
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.accel import treelet as tl

    report = {"max_abs_err": 0.0}
    fams, launches = {}, {}
    for name, depth in (("mesh_ball", MESH_DEPTH), ("everything", EVERY_DEPTH)):
        scene = mesh_scene(name).to(dev)
        tracer = tk.Tracer(scene.geom)
        if len(tracer.families) != 1:
            raise AssertionError(f"{name}: expected one K5 family, got "
                                 f"{len(tracer.families)}")
        fams[name] = tracer.families[0]
        launches[name] = main_path_launches(dev, scene, depth)
    c = rng.uniform(-10, 10, (2048, 3)).astype(np.float32)
    r = rng.uniform(0.05, 0.6, 2048).astype(np.float32)
    nrm = rng.normal(size=(2048, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    radial = np.cross(nrm, rng.normal(size=(2048, 3)))
    radial *= (rng.uniform(0.05, 0.6, 2048)
               / np.linalg.norm(radial, axis=1))[:, None]
    sets = [
        ("mesh_ball triangles", fams["mesh_ball"],
         box_rays(rng, BVH_SET, [-3, -0.5, -3], [3, 2.5, 3], dev, 3.0)),
        ("everything quads", fams["everything"],
         box_rays(rng, BVH_SET, [-1000, 0, -1000], [1000, 600, 1000], dev,
                  1000.0)),
        ("2048 random spheres", tl.sphere_tracer(c, r, 7, device=dev),
         box_rays(rng, BVH_SET, -12, 12, dev, 10.0)),
        ("2048 random disks", tl.disk_tracer(c, nrm.astype(np.float32),
                                             radial.astype(np.float32), 11,
                                             device=dev),
         box_rays(rng, BVH_SET, -12, 12, dev, 10.0)),
    ]
    for label, fam, rays in sets:
        t_p, id_p = tl.trace_reference(fam, rays)
        t_in, id_in = crafted_seed(t_p, id_p, rng)
        ties = int((torch.isfinite(t_p) & (t_in == t_p)).sum())
        for seeded, seed in (("unseeded", (None, None)),
                             (f"seeded ({ties} ties at equal t)",
                              (t_in, id_in))):
            bad, err, hits, _ = bvh_compare(fam, rays, *seed)
            report["max_abs_err"] = max(report["max_abs_err"], err)
            print(f"phase 10 K5 {label}, random rays, {seeded}: {BVH_SET} "
                  f"rays, {hits} hits, {fam.n_prims} prims ({fam.n_nodes} "
                  f"nodes in {fam.n_pairs} child pairs, depth {fam.depth}, "
                  f"{fam.builder} builder); lanes differing: t {bad['t']}, "
                  f"id {bad['id']}, hit mask {bad['hit']}, any-hit mask "
                  f"{bad['any-hit']}; max |dt| {err:.3g}")
            if any(bad.values()):
                raise AssertionError(f"K5 disagrees with its plain version "
                                     f"on {label}, {seeded}")
    # Every K5 launch of the main paths' sample 0, at full width, with the
    # running hit it was handed: parity, device time (CUDA events over 5
    # replays), plain time and bound.
    per = {"ms": [], "plain_ms": [], "bound_ms": [], "bound_by": [],
           "claims": []}
    for name, seen in launches.items():
        fam = fams[name]
        bad = {"t": 0, "id": 0, "hit": 0, "any-hit": 0}
        rows = []
        for _, planes, any_hit, t_in, id_in in seen["k5"]:
            got, err, hits, plain_ms = bvh_compare(fam, planes_rays(planes),
                                                   t_in, id_in)
            bad = {k: bad[k] + got[k] for k in bad}
            report["max_abs_err"] = max(report["max_abs_err"], err)
            ms = k5_ms(fam, planes, any_hit, t_in, id_in)
            b_ms, b_by, nodes, prims = bvh_launch_bound(fam, planes, any_hit,
                                                        rng, t_in, id_in)
            n = planes.shape[1]
            walked = (planes[6] > 0) & ~(torch.isfinite(t_in) if any_hit
                                         else torch.zeros_like(planes[6],
                                                               dtype=bool))
            at = at_claims(lambda: k5_ms(fam, planes, any_hit, t_in, id_in))
            rows.append((any_hit, int((planes[6] > 0).sum()),
                         int(walked.sum()), hits, ms, plain_ms, b_ms,
                         nodes / n, prims / n, at))
            for k, v in zip(("ms", "plain_ms", "bound_ms", "bound_by",
                             "claims"), (ms, plain_ms, b_ms, b_by, at)):
                per[k].append(v)
        n = seen["k5"][0][1].shape[1]
        print(f"phase 10 K5 {name} main path, sample 0: {len(rows)} launches "
              f"({sum(not r[0] for r in rows)} closest, "
              f"{sum(r[0] for r in rows)} any hit) of {n} lanes, seeded with "
              f"K1's hit; lanes differing: t {bad['t']}, id {bad['id']}, hit "
              f"mask {bad['hit']}, any-hit mask {bad['any-hit']}")
        for i, (any_hit, live, walked, hits, ms, plain_ms, b_ms, nd,
                pr, at) in enumerate(rows):
            print(f"phase 10 K5 {name} launch {i} "
                  f"{'any hit' if any_hit else 'closest'}: {live} live lanes, "
                  f"{walked} walked, {hits} hits; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms; {nd:.2f} node and "
                  f"{pr:.2f} primitive tests a lane; at {claims_text([at])}")
        print(f"phase 10 K5 {name} per sample: kernel "
              f"{sum(r[4] for r in rows):.4f} ms, plain "
              f"{sum(r[5] for r in rows):.4f} ms, bound "
              f"{sum(r[6] for r in rows):.4f} ms; a launch at "
              f"{claims_text([r[9] for r in rows])}")
        if any(bad.values()):
            raise AssertionError(f"K5 disagrees with its plain version on "
                                 f"{name}'s main path")
    k = len(per["ms"])
    for key in ("ms", "plain_ms", "bound_ms"):
        report[key] = sum(per[key]) / k
    report["bound_by"] = max(set(per["bound_by"]), key=per["bound_by"].count)
    print(f"phase 10 K5 mean over the {k} launches of both main paths: "
          f"kernel {report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms, "
          f"bound {report['bound_ms']:.4f} ms (by {report['bound_by']} in "
          f"{per['bound_by'].count(report['bound_by'])} of {k}); at "
          f"{claims_text(per['claims'])}")
    # K5 at 2^20 lanes: mesh_ball's camera and bounce-1 closest-hit lanes.
    fam = fams["mesh_ball"]
    closest = [planes for _, planes, a, _, _ in launches["mesh_ball"]["k5"]
               if not a]
    both = torch.cat(closest[:2], dim=1)
    big = both[:, torch.arange(N_RAYS, device=dev) % both.shape[1]]
    big = big.contiguous()
    print(f"phase 10 K5 time at {N_RAYS} rays (mesh_ball camera + bounce-1 "
          f"closest hit, unseeded): kernel "
          f"{cuda_ms(lambda: tl.trace_planes(fam, big), 20):.4f} ms")
    # K1 on every flat-bank launch of both main paths.
    for name, seen in launches.items():
        replay_k1(f"phase 10 K1 {name}", seen["k1"], k1_report, rng)
    ev = launches["everything"]["k1"]
    cb_flat = tk.pack_bank(*tk.prim_scalars(cornell(8).to(dev).geom))
    k1_ev = sum(cuda_ms(lambda: tk.trace_planes(f, p, a), 5)
                for f, p, a in ev)
    k1_cb = sum(cuda_ms(lambda: tk.trace_planes(cb_flat, p, a), 5)
                for _, p, a in ev)
    print(f"phase 10 K1 time per launch over everything's sample 0 ("
          f"{len(ev)} launches of {ev[0][1].shape[1]} lanes): everything's "
          f"bank ({sum(ev[0][0].counts)} rows) {k1_ev / len(ev):.4f} ms, "
          f"Cornell's bank ({sum(cb_flat.counts)} rows) "
          f"{k1_cb / len(ev):.4f} ms")
    # The crossover of TREELET_THRESHOLD: everything's 1005 spheres as a K5
    # sphere family, on the planes of the same K1 launches.
    geom = mesh_scene("everything").geom
    sph = tl.sphere_tracer(geom.sph_center.numpy(), geom.sph_radius.numpy(),
                           0, device=dev)
    k5_sph = sum(cuda_ms(lambda: tl.trace_planes(sph, p, a), 5)
                 for _, p, a in ev)
    print(f"phase 10 crossover on everything's sample 0 ({len(ev)} launches): "
          f"its {sph.n_prims} spheres as a K5 sphere family ({sph.n_nodes} "
          f"nodes, depth {sph.depth}) {k5_sph / len(ev):.4f} ms a launch, "
          f"K1 on its {sum(ev[0][0].counts)}-row bank "
          f"{k1_ev / len(ev):.4f} ms a launch")
    return report


def phase_bvh_golden(dev):
    """tests/test_golden.py's everything (32^2, depth 3) and mesh_ball_l2
    (48^2, depth 4, BVH threshold 64) checksums through the general path,
    whose quads / triangles take K5."""
    from pbrs_tpu_torch import cli, render
    from pbrs_tpu_torch.accel import treelet as tl
    from pbrs_tpu_torch.core import sampler as smp
    from pbrs_tpu_torch.scene import presets

    with open(os.path.join(REPO, "tests", "golden_checksums.json")) as f:
        golden = json.load(f)
    for key, scene, size, depth, thresh in (
            ("everything", presets.everything(), 32, 3, None),
            ("mesh_ball_l2", presets.mesh_ball(levels=2), 48, 4, 64)):
        scene = cli.with_resolution(scene, size, size).to(dev)
        pix = torch.arange(size * size, dtype=torch.int32, device=dev)
        tl.LAUNCHES = 0
        name, fn = render.make_integrator(scene, smp.PCGSampler(0), depth, 2,
                                          "general", bvh_threshold=thresh)
        got = sum(float(fn(pix, s)[0].sum()) for s in range(2))
        rel = abs(got - golden[key]) / abs(golden[key])
        print(f"phase 11 golden {key} via {name} (K5 launches "
              f"{tl.LAUNCHES}): {got:.6f} vs {golden[key]:.6f} (rel "
              f"{rel:.2e})")
        if not tl.LAUNCHES:
            raise AssertionError(f"golden {key} did not go through K5")
        if rel > GOLDEN_REL_TOL:
            raise AssertionError(f"golden {key} via {name} drifted")


def phase_mesh_main(dev, smi):
    """The mesh main paths: mesh_ball(levels=5) 800x600, depth 6, and
    everything 800x800, depth 5, msaa 2, PCG seed 0, through the auto and
    general routes. Route auto takes the wave path (K4 with K1 and K5 for
    the trace), route general the general wavefront (K1 and K5): two
    independent implementations of one estimator on the same random
    streams, so equal checksums are a real check (phase 17 holds them per
    lane). The plain route is left out: its sweep broadcasts [N, P] at
    P = 16384."""
    from pbrs_tpu_torch.accel import fused_wave as fw
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.accel import treelet as tl

    tk.LAUNCHES = 0
    tl.LAUNCHES = 0
    fw.LAUNCHES = 0
    for name, depth in (("mesh_ball", MESH_DEPTH), ("everything", EVERY_DEPTH)):
        scene = mesh_scene(name).to(dev)
        w, h = scene.camera.width, scene.camera.height
        pix = torch.arange(w * h, dtype=torch.int32, device=dev)
        results = {}
        k1, k5, k4 = tk.LAUNCHES, tl.LAUNCHES, fw.LAUNCHES
        for route in ("auto", "general"):
            results[route] = run_main_path(scene, route, pix, depth)
        for route, (got, mrays, wall, checksum, _) in results.items():
            print(f"phase 12 main path {route} -> {got}: {name} {w}x{h} depth "
                  f"{depth} msaa {MSAA}: median {mrays:.3f} Mrays/s, "
                  f"{wall * 1e3:.2f} ms/sample, checksum {checksum:.6e} "
                  f"[{smi}]")
        print(f"phase 12 launches on {name}: K1 trace_flat "
              f"{tk.LAUNCHES - k1}, K5 trace_bvh {tl.LAUNCHES - k5}, K4 "
              f"fused_wave {fw.LAUNCHES - k4}")
        if [r[0] for r in results.values()] != ["fused_wave", "general"]:
            raise AssertionError(f"{name}: routes auto / general did not take "
                                 f"the wave / general paths")
        if tl.LAUNCHES == k5 or fw.LAUNCHES == k4:
            raise AssertionError(f"{name}: K5 or K4 never launched")
        sums = [r[3] for r in results.values()]
        if max(sums) - min(sums) > GOLDEN_REL_TOL * abs(sums[0]):
            raise AssertionError(f"{name}: routes disagree on the checksum: "
                                 f"{sums}")
    return {"trace_bvh": tl.LAUNCHES, "trace_flat": tk.LAUNCHES}


# ----------------- K4: the shade kernel, the PBRT interior ------------------


def wave_zoo_scene(size):
    """Everything the wave path adds over K3: substrate (FresnelBlend),
    sigma > 0 matte (Oren-Nayar), full uber (delta + smooth mixture), image
    and checker textures, an image environment with its sampling
    distribution, delta lights and quad / sphere area lights
    (tests/test_fused_wave.py:21-61)."""
    from pbrs_tpu_torch.lights import lights
    from pbrs_tpu_torch.scene.buffers import SceneBuilder

    b = SceneBuilder()
    g, m = b.geometry, b.materials
    rng = np.random.default_rng(5)
    tex_img = b.textures.add_image(rng.random((8, 8, 3)).astype(np.float32))
    tex_chk = b.textures.add_checker((0.7, 0.7, 0.2), (0.1, 0.1, 0.4))
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               m.add_lambertian(tex_id=tex_img))
    g.add_sphere((-4.5, 1, 0), 1.0,
                 m.add_substrate((0.5, 0.3, 0.2), (0.3, 0.3, 0.3), 0.08))
    g.add_sphere((-1.5, 1, 0), 1.0, m.add_matte((0.6, 0.5, 0.4),
                                                sigma_deg=20.0))
    g.add_sphere((1.5, 1, 0), 1.0, m.add_uber(
        (0.3, 0.4, 0.5), (0.4, 0.4, 0.4), roughness=0.1, opacity=0.7))
    g.add_sphere((4.5, 1, 0), 1.0, m.add_dielectric(1.5))
    g.add_sphere((0.0, 1, -3), 1.0, m.add_mirror((0.9, 0.9, 0.9)))
    g.add_triangle((-3, 0.01, -5), (0, 0.01, -3), (-1.5, 2.5, -4),
                   m.add_lambertian(tex_id=tex_chk))
    light_c, c2 = (6.0, 6.0, 6.0), (8.0, 7.0, 6.0)
    g.add_quad((-2, 7, -2), (4, 0, 0), (0, 0, 4), m.add_diffuse_light(light_c))
    b.lights.add_area_quad(light_c, (-2, 7, -2), (4, 0, 0), (0, 0, 4))
    g.add_sphere((-4, 5, -5), 0.8, m.add_diffuse_light(c2))
    b.lights.add_area_sphere(c2, (-4, 5, -5), 0.8)
    b.lights.add_point((6, 5, -6), (40, 35, 30))
    b.lights.add_distant((0.3, -1.0, 0.2), (0.5, 0.5, 0.55))
    b.lights.env = lights.make_env_image(
        rng.random((8, 16, 3)).astype(np.float32), scale=(1.5, 1.5, 1.5))
    return _view(b, size, 45.0, (0, 4, -14), (0, 1.5, 0))


def interior(w, h):
    """scenes/interior/interior.pbrt through the port's PBRT loader, seen at
    w x h (benchmarks.py run_config's camera resize)."""
    from pbrs_tpu_torch import cli
    from pbrs_tpu_torch.scene.pbrt import loader

    scene = loader.build_scene(os.path.join(REPO, "scenes", "interior",
                                            "interior.pbrt"))
    return cli.with_resolution(scene, w, h)


class _OpCount:
    """Counts the float operations of a plain version's tensor program: the
    elements written by each arithmetic or comparison op on float inputs
    (the SWEEP_OPS convention). The plain version of K4 evaluates every
    lobe model and light shape the scene holds on every lane, where a lane
    of the kernel evaluates its own, so this over-counts what K4 must do."""

    ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt",
             "exp", "log", "sin", "cos", "abs", "clamp_min", "clamp_max",
             "clamp", "maximum", "minimum", "lt", "le", "gt", "ge", "eq",
             "ne", "remainder", "reciprocal", "floor", "atan2", "acos",
             "pow"}

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self
        self.ops = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.overloadpacket.__name__.rstrip("_")
                first = next((a for a in args if isinstance(a, torch.Tensor)),
                             None)
                if (name in outer.ARITH and first is not None
                        and first.is_floating_point()
                        and isinstance(out, torch.Tensor)):
                    outer.ops += out.numel()
                return out

        self.mode = Mode()


def k4_ops(tab, fin, iin, kw):
    from pbrs_tpu_torch.accel import fused_wave as fw

    counter = _OpCount()
    with counter.mode:
        fw.shade_reference(tab, fin, iin, **kw)
    return counter.ops


def k4_compare(tab, fin, iin, kw):
    """K4 against its plain version on one launch's inputs: lanes outside
    tolerance (any of the 30 float planes), lanes not bit-equal, lanes
    whose alive / spec differ, max |d|, and both shadow-ray counts."""
    from pbrs_tpu_torch.accel import fused_wave as fw

    cnt_k = torch.zeros(1, dtype=torch.int64, device=fin.device)
    out_k, iout_k = fw.shade(tab, fin, iin, cnt_k, **kw)
    out_p, iout_p, cnt_p = fw.shade_reference(tab, fin, iin, **kw)
    torch.cuda.synchronize()
    close = torch.isclose(out_k, out_p, atol=K4_ATOL, rtol=K4_RTOL,
                          equal_nan=True).all(dim=0)
    d = (out_k - out_p).abs().nan_to_num(0.0, posinf=0.0)
    return {"outside": int((~close).sum()),
            "not_bit_equal": int((out_k.view(torch.int32)
                                  != out_p.view(torch.int32)).any(0).sum()),
            "alive": int((iout_k != iout_p).any(0).sum()),
            "err": float(d.max()), "rays_k": int(cnt_k), "rays_p": int(cnt_p),
            "live": int((iin[2] > 0).sum()), "lanes": fin.shape[1]}


def ptxas_spills(function):
    """(stack frame, spill store, spill load) bytes ptxas reported for the
    kernel whose mangled name holds `function` (phase 1's log)."""
    from pbrs_tpu_torch import kernels

    lines = kernels.ptxas_log_path().read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and function in line:
            for later in lines[i + 1:i + 4]:
                if "spill stores" in later:
                    return tuple(int(w) for w in later.split()
                                 if w.isdigit())[:3]
    raise AssertionError(f"no ptxas report for {function}")


def bvh_stack_frames():
    """(function, stack frame, spill store, spill load bytes) that ptxas
    reported for every K5 instantiation (phase 1's log)."""
    from pbrs_tpu_torch import kernels

    names = [line.split("'")[1] for line in
             kernels.ptxas_log_path().read_text().splitlines()
             if "Compiling entry function" in line
             and "trace_bvh_kernel" in line]
    return [(name, *ptxas_spills(name)) for name in names]


def k4_kernel_line(phase, name, n_slots, tab):
    """Registers, spills, resident warps an SM and staged output planes of
    the K4 kernel that runs on these tables."""
    from pbrs_tpu_torch.accel import fused_wave as fw

    info = fw.kernel_info(tab)
    stack, spill_st, spill_ld = ptxas_spills(f"fused_wave_kernelILi{n_slots}E")
    print(f"phase {phase} {name} kernel, {n_slots} slots: {info['registers']} "
          f"registers, {stack} B stack, {spill_st} / {spill_ld} B spill "
          f"stores / loads (ptxas); {info['warps_per_sm']} resident warps an "
          f"SM ({info['threads']} threads a block, {info['window']} lanes "
          f"regrouped), {info['smem_bytes']} B shared memory, "
          f"{info['staged_planes']} of {fw.N_OUT + 2} output planes staged")


def phase_wave(dev, seen, rng="pcg", nee_mode="twoarm", phase=13):
    """K4 against its plain version on every K4 launch of sample 0 of the
    interior main path (1024^2, depth 5: whole windows) and of the wave
    zoo at 250^2 (62500 lanes: the last window partial), drawing `rng`
    with `nee_mode` NEE; the kernel's registers, spills and
    resident warps for each slot count seen; K4's device time per launch
    by bounce (CUDA events, the device put to sleep first), its plain
    version's, and the bound, over the interior launches (and, for a
    Sobol' or folded variant, the PCG two-arm twin's time on the same
    planes)."""
    from pbrs_tpu_torch.accel import fused_wave as fw

    folded = nee_mode == "folded"
    name = variant("K4", rng, folded)
    report = {"max_abs_err": 0.0}
    zoo = wave_zoo_scene(250).to(dev)
    if not fw.scene_supports_wave(zoo):
        raise AssertionError("the wave zoo is not wave-eligible")
    launches = {"interior": seen["k4"],
                "zoo": main_path_launches(dev, zoo, 5, rng, nee_mode)["k4"]}
    for label, rows in launches.items():
        if not rows:
            raise AssertionError(f"{label}: no K4 launch on its main path")
    window = fw.kernel_info(launches["zoo"][0][0])["window"]
    if all(fin.shape[1] % window == 0 for _, fin, _, _ in launches["zoo"]):
        raise AssertionError(f"no zoo launch ends in a partial {window}-lane "
                             f"window")
    slots = {}
    for label, rows in launches.items():
        slots.setdefault(rows[0][0].n_slots, rows[0][0])
        for i, (tab, fin, iin, kw) in enumerate(rows):
            if (kw.get("rng", "pcg"), kw.get("folded", False)) != (rng,
                                                                   folded):
                raise AssertionError(f"{label}: a K4 launch of another "
                                     f"variant: {kw}")
            got = k4_compare(tab, fin, iin, kw)
            report["max_abs_err"] = max(report["max_abs_err"], got["err"])
            print(f"phase {phase} {name} {label} launch {i} (bounce "
                  f"{kw['bounce']}, {tab.n_slots} slots): {got['lanes']} "
                  f"lanes (last window {(got['lanes'] - 1) % window + 1} of "
                  f"{window}), {got['live']} alive; outside atol {K4_ATOL} "
                  f"rtol {K4_RTOL}: {got['outside']}; not bit-equal "
                  f"{got['not_bit_equal']}; "
                  f"alive/spec differ {got['alive']}; max |d| "
                  f"{got['err']:.3g}; shadow rays kernel {got['rays_k']} "
                  f"plain {got['rays_p']}")
            if (got["outside"] or got["not_bit_equal"] or got["alive"]
                    or got["rays_k"] != got["rays_p"]):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on {label} launch {i}")
    for n_slots, tab in sorted(slots.items()):
        k4_kernel_line(phase, name, n_slots, tab)
    per = {"ms": [], "plain_ms": [], "bound_ms": [], "bound_by": [],
           "twin_ms": [], "bounce": []}
    cnt = torch.zeros(1, dtype=torch.int64, device=dev)
    # Folded, K4 need not write the second shadow query's direction and
    # side (4 planes).
    n_out = fw.N_OUT - (4 if folded else 0)
    for i, (tab, fin, iin, kw) in enumerate(launches["interior"]):
        n = fin.shape[1]
        ms = cuda_ms(lambda: fw.shade(tab, fin, iin, cnt, **kw), 5)
        twin = {**kw, "rng": "pcg", "folded": False}
        twin_ms = (cuda_ms(lambda: fw.shade(tab, fin, iin, cnt, **twin), 5)
                   if twin != kw else ms)
        plain_ms = cuda_ms(lambda: fw.shade_reference(tab, fin, iin, **kw), 1)
        ops = k4_ops(tab, fin, iin, kw)
        # Each input plane read once and each output written once a lane,
        # the tables once.
        moved = n * 4 * (fin.shape[0] + fw.N_INT + n_out + 2) + 4 * sum(
            t.numel() for t in (tab.mats, tab.lights, tab.delta))
        b_ms, b_by = bound(moved, ops)
        twin_said = (f", K4 PCG two-arm on the same planes {twin_ms:.4f} ms"
                     if twin != kw else "")
        print(f"phase {phase} {name} time, interior launch {i} (bounce "
              f"{kw['bounce']}): {n} lanes, "
              f"{int((iin[2] > 0).sum())} alive; kernel {ms:.4f} ms"
              f"{twin_said}, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}: {moved / 1e6:.1f} MB, {ops / n:.0f} plain-version "
              f"float ops a lane)")
        for key, v in zip(("ms", "plain_ms", "bound_ms", "bound_by",
                           "twin_ms", "bounce"),
                          (ms, plain_ms, b_ms, b_by, twin_ms, kw["bounce"])):
            per[key].append(v)
    k = len(per["ms"])
    for key in ("ms", "plain_ms", "bound_ms", "twin_ms"):
        report[key] = sum(per[key]) / k
    report["bound_by"] = max(set(per["bound_by"]), key=per["bound_by"].count)
    twin_said = (f", PCG two-arm twin {report['twin_ms']:.4f} ms"
                 if (rng, folded) != ("pcg", False) else "")
    print(f"phase {phase} {name} mean over the {k} interior launches: kernel "
          f"{report['ms']:.4f} ms{twin_said}, plain "
          f"{report['plain_ms']:.4f} ms, bound "
          f"{report['bound_ms']:.4f} ms ({report['bound_by']}); per sample: "
          f"kernel {sum(per['ms']):.4f} ms")
    first = [ms for ms, b in zip(per["ms"], per["bounce"]) if b == 0]
    later = [ms for ms, b in zip(per["ms"], per["bounce"]) if b > 0]
    if first and later:
        print(f"phase {phase} {name} by bounce: bounce 0 {first[0]:.4f} ms, "
              f"bounces 1-{max(per['bounce'])} "
              f"{min(later):.4f}-{max(later):.4f} ms, the slowest "
              f"{max(later) / first[0]:.2f}x bounce 0")
    return report


def phase_interior_traces(seen, k1_report, k5_report, rng):
    """Every K1 and K5 launch of sample 0 of the interior main path (the
    sample whose K4 launches phase 13 replays) against the plain versions:
    K1 on the flat bank, with its time, plain time and bound a launch, K5
    on the triangle family seeded with K1's hit, closest hit and the
    concatenated shadow batches, with K5's device time a launch."""
    from pbrs_tpu_torch.accel import treelet as tl

    if not seen["k1"] or not seen["k5"]:
        raise AssertionError("the interior main path launched no K1 or K5")
    replay_k1("phase 13 K1 interior", seen["k1"], k1_report, rng)
    bad = {"t": 0, "id": 0, "hit": 0, "any-hit": 0}
    ms_all, plain_all, claims = 0.0, 0.0, []
    for i, (fam, planes, any_hit, t_in, id_in) in enumerate(seen["k5"]):
        got, err, hits, plain_ms = bvh_compare(fam, planes_rays(planes),
                                               t_in, id_in)
        bad = {k: bad[k] + got[k] for k in bad}
        k5_report["max_abs_err"] = max(k5_report["max_abs_err"], err)
        ms = k5_ms(fam, planes, any_hit, t_in, id_in)
        ms_all, plain_all = ms_all + ms, plain_all + plain_ms
        claims.append(at_claims(
            lambda: k5_ms(fam, planes, any_hit, t_in, id_in)))
        print(f"phase 13 K5 interior launch {i} "
              f"{'any hit' if any_hit else 'closest'}: {planes.shape[1]} "
              f"lanes, {int((planes[6] > 0).sum())} live, {hits} hits, "
              f"{fam.n_prims} prims; lanes differing: t {got['t']}, id "
              f"{got['id']}, hit mask {got['hit']}, any-hit mask "
              f"{got['any-hit']}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms; at {claims_text(claims[-1:])}")
    print(f"phase 13 K5 interior main path, sample 0: {len(seen['k5'])} "
          f"launches; lanes differing: t {bad['t']}, id {bad['id']}, hit "
          f"mask {bad['hit']}, any-hit mask {bad['any-hit']}; per sample: "
          f"kernel {ms_all:.4f} ms, plain {plain_all:.4f} ms; a launch at "
          f"{claims_text(claims)}")
    if any(bad.values()):
        raise AssertionError("K5 disagrees with its plain version on the "
                             "interior's main path")


def phase_wave_golden(dev):
    """tests/test_golden.py's everything (32^2, depth 3) and mesh_ball_l2
    (48^2, depth 4, BVH threshold 64) checksums through route auto, which
    takes the wave path (K4, with K1 and K5 tracing)."""
    from pbrs_tpu_torch import cli, render
    from pbrs_tpu_torch.accel import fused_wave as fw
    from pbrs_tpu_torch.core import sampler as smp
    from pbrs_tpu_torch.scene import presets

    with open(os.path.join(REPO, "tests", "golden_checksums.json")) as f:
        golden = json.load(f)
    for key, scene, size, depth, thresh in (
            ("everything", presets.everything(), 32, 3, None),
            ("mesh_ball_l2", presets.mesh_ball(levels=2), 48, 4, 64)):
        scene = cli.with_resolution(scene, size, size).to(dev)
        pix = torch.arange(size * size, dtype=torch.int32, device=dev)
        fw.LAUNCHES = 0
        name, fn = render.make_integrator(scene, smp.PCGSampler(0), depth, 2,
                                          "auto", bvh_threshold=thresh)
        got = sum(float(fn(pix, s)[0].sum()) for s in range(2))
        rel = abs(got - golden[key]) / abs(golden[key])
        print(f"phase 14 golden {key} via {name} (K4 launches {fw.LAUNCHES}):"
              f" {got:.6f} vs {golden[key]:.6f} (rel {rel:.2e})")
        if name != "fused_wave" or not fw.LAUNCHES:
            raise AssertionError(f"golden {key} did not go through K4")
        if rel > GOLDEN_REL_TOL:
            raise AssertionError(f"golden {key} via {name} drifted")


def phase_interior_main(dev, smi):
    """The slice's main path: the PBRT interior at 1024^2, depth 5, msaa 2,
    PCG seed 0 (benchmarks.json interior_instanced_mis_1024), through route
    auto (K4, with K1 + K5 tracing and the glass egg's instance group) and
    route general (K1 + K5). Returns the kernel launches of the auto run
    and every K1 / K4 / K5 launch of its sample 0 for phase 13."""
    from pbrs_tpu_torch.accel import dispatch
    from pbrs_tpu_torch.accel import fused_wave as fw
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.accel import treelet as tl

    scene = interior(SIZE, SIZE).to(dev)
    tracer = tk.Tracer(dispatch.trace_geometry(scene)[0])
    print(f"phase 15 interior tracer: flat bank {tracer.flat_rows} rows "
          f"(counts {tracer.counts}), BVH families "
          f"{[(f.n_prims, f.n_nodes, f.depth) for f in tracer.families]} "
          f"(prims, nodes, depth)")
    if not tracer.families:
        raise AssertionError("the interior's triangles did not go to K5")
    seen = main_path_launches(dev, scene, 5)
    pix = torch.arange(SIZE * SIZE, dtype=torch.int32, device=dev)
    results, launches = {}, {}
    for route in ("auto", "general"):
        tk.LAUNCHES = tl.LAUNCHES = fw.LAUNCHES = 0
        results[route] = run_main_path(scene, route, pix, 5)
        launches[route] = {"trace_flat": tk.LAUNCHES,
                           "trace_bvh": tl.LAUNCHES,
                           "fused_wave": fw.LAUNCHES}
    for route, (name, mrays, wall, checksum, _) in results.items():
        print(f"phase 15 main path {route} -> {name}: interior {SIZE}^2 depth "
              f"5 msaa {MSAA}: median {mrays:.3f} Mrays/s, {wall * 1e3:.2f} "
              f"ms/sample, checksum {checksum:.6e} [{smi}]")
        print(f"phase 15 launches of route {route}: K1 trace_flat "
              f"{launches[route]['trace_flat']}, K4 fused_wave "
              f"{launches[route]['fused_wave']}, K5 trace_bvh "
              f"{launches[route]['trace_bvh']}")
    if results["auto"][0] != "fused_wave":
        raise AssertionError("the interior main path did not take K4")
    if not all(launches["auto"].values()):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches['auto']}")
    sums = [r[3] for r in results.values()]
    if max(sums) - min(sums) > GOLDEN_REL_TOL * abs(sums[0]):
        raise AssertionError(f"routes disagree on the checksum: {sums}")
    return launches["auto"], seen


def phase_interior_1080(dev, smi):
    """One timed sample index of benchmarks.json
    interior_pbrt_1920x1080_1024spp: 1920x1080, depth 8, msaa 32 (1024
    spp), route auto, the frame in two chunks of at most 2^20 pixels in
    Morton order (render.render_image's chunking), after one warm-up
    sample; the wall time to 1024 spp is 1024 x the sample's."""
    from pbrs_tpu_torch import render
    from pbrs_tpu_torch.core import sampler as smp
    from pbrs_tpu_torch.integrators import wavefront

    w, h, depth, spp = 1920, 1080, 8, 1024
    scene = interior(w, h).to(dev)
    name, step = render.make_integrator(scene, smp.PCGSampler(0), depth,
                                        int(spp ** 0.5), "auto")
    order = wavefront.morton_pixel_order(w, h)
    chunks = [torch.from_numpy(order[c:c + (1 << 20)]).to(dev)
              for c in range(0, w * h, 1 << 20)]
    for pix in chunks:
        step(pix, 0)
    torch.cuda.synchronize()
    t0 = time.time()
    rays, total = 0, 0.0
    for pix in chunks:
        rad, cnt = step(pix, 1)
        total += float(rad.sum())
        rays += int(cnt)
    torch.cuda.synchronize()
    dt = time.time() - t0
    print(f"phase 16 interior {w}x{h} depth {depth} via {name}: "
          f"{len(chunks)} chunks, one sample index {dt * 1e3:.2f} ms, "
          f"{rays / dt / 1e6:.3f} Mrays/s, wall to {spp} spp "
          f"{dt * spp:.1f} s, sample checksum {total:.6e} [{smi}]")
    if name != "fused_wave" or not np.isfinite(total) or total <= 0:
        raise AssertionError("the 1920x1080 interior sample is not a finite, "
                             "lit K4 render")


def wave_vs_general(dev, label, scene, depth, rng="pcg", nee_mode="twoarm",
                    phase=17):
    """The wave path (route auto's integrator) against the general path
    (route general) per lane, sample 0, at full width, on sampler `rng`
    with `nee_mode` NEE. A lane whose path reaches a Perlin-marble surface
    is counted apart: at everything's scale (coordinates to ~1000, the
    marble's top octave at 640 lattice cells a unit) one float32 ulp of
    hit position moves the marble by ~0.3%, so the two paths' rounding
    differences there exceed the per-lane tolerance; pbrs_tpu's own wave
    and general paths split the same way (ROADMAP Queue 3). Limits: at
    most 0.01% of the other lanes outside atol K4_ATOL, rtol K4_RTOL; at
    most MARBLE_SHARE of the Perlin lanes outside atol K4_ATOL, rtol
    MARBLE_RTOL; the checksums within GOLDEN_REL_TOL; a Sobol' or folded
    run also holds the traced-ray counts equal but for the segments of the
    lanes outside tolerance. Each lane outside tolerance is classified by
    lane_diff: the bounce where the two paths part, and how."""
    from pbrs_tpu_torch import lane_diff, render

    scene = scene.to(dev)
    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    name, _ = render.make_integrator(scene, sampler_of(rng), depth, MSAA,
                                     "auto", nee_mode=nee_mode)
    if not name.startswith("fused_wave"):
        raise AssertionError(f"{label}: route auto did not take K4")
    paths = lane_diff._Paths(scene, rng, nee_mode)
    wave = paths.wave
    perlin = lane_diff.perlin_materials(scene)
    touched = torch.zeros(n, dtype=torch.bool, device=dev)
    trace = wave.intersect_fn

    def traced(rays):
        hit = trace(rays)
        touched.logical_or_(hit.hit & (rays.t_max > 0.0)
                            & perlin[hit.mat_id.clamp_min(0).long()])
        return hit

    wave.intersect_fn = traced
    rad_w, cnt_w = wave.render_samples(sampler_of(rng), pix, 0,
                                       max_depth=depth, msaa=MSAA)
    wave.intersect_fn = trace
    _, general = render.make_integrator(scene, sampler_of(rng), depth, MSAA,
                                        "general", nee_mode=nee_mode)
    rad_g, cnt_g = general(pix, 0)

    def outside(rtol):
        return ~torch.isclose(rad_w, rad_g, atol=K4_ATOL,
                              rtol=rtol).all(dim=1)

    n_out = int(outside(K4_RTOL).sum())
    n_marble = int((outside(K4_RTOL) & touched).sum())
    marble = int(touched.sum())
    rest = n - marble
    loose = {r: int((outside(r) & touched).sum())
             for r in (1e-3, MARBLE_RTOL, 1e-1)}
    s_w, s_g = float(rad_w.sum()), float(rad_g.sum())
    mode = f"{rng}, {nee_mode}"
    print(f"phase {phase} wave vs general ({mode}), {label} ({n} lanes, "
          f"depth {depth}, sample 0): lanes outside atol {K4_ATOL} rtol "
          f"{K4_RTOL}: {n_out}, {n_marble} of them among the {marble} that "
          f"reach a Perlin surface, {n_out - n_marble} of the other {rest}; "
          f"Perlin lanes outside atol {K4_ATOL} and rtol "
          + ", ".join(f"{r:g}: {c}" for r, c in loose.items())
          + f"; max |d| {float((rad_w - rad_g).abs().max()):.3g}; "
          f"checksum {s_w:.6e} vs {s_g:.6e}; rays {int(cnt_w)} vs "
          f"{int(cnt_g)}")
    lanes = lane_diff.classify(scene, pix[outside(K4_RTOL)], depth, MSAA,
                               paths)
    for how in sorted({ln["how"] for ln in lanes}):
        print(f"phase {phase} {label} ({mode}), where the paths part: {how}: "
              + lane_diff.summary([ln for ln in lanes if ln["how"] == how]))
    rays_ok = (rng == "pcg" and nee_mode == "twoarm") or abs(
        int(cnt_w) - int(cnt_g)) <= n_out * (3 * depth + 1)
    if (n_out - n_marble > 1e-4 * rest
            or loose[MARBLE_RTOL] > MARBLE_SHARE * marble
            or abs(s_w - s_g) > GOLDEN_REL_TOL * abs(s_g)
            or not np.isfinite(s_w) or not rays_ok):
        raise AssertionError(f"{label}: the wave path disagrees with the "
                             f"general path ({mode})")


def phase_wave_vs_general(dev):
    """Phase 17: the wave path against the general path per lane (PCG,
    two-arm) on the interior 1024^2 depth 5, everything 800^2 depth 5 and
    mesh_ball(levels=5) 800x600 depth 6 (see wave_vs_general)."""
    for label, scene, depth in (("interior", interior(SIZE, SIZE), 5),
                                ("everything", mesh_scene("everything"),
                                 EVERY_DEPTH),
                                ("mesh_ball", mesh_scene("mesh_ball"),
                                 MESH_DEPTH)):
        wave_vs_general(dev, label, scene, depth)


# --------- the Sobol' sampler, folded NEE and the direct integrator ---------


def launch_counts():
    from pbrs_tpu_torch.accel import fused_kernel as fk
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl
    from pbrs_tpu_torch.accel import fused_wave as fw
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.accel import treelet as tl

    return {"trace_flat": tk, "fused_bounce": fk, "fused_single_lobe": fsl,
            "trace_bvh": tl, "fused_wave": fw}


def render_path(phase, label, scene, depth, smi, route="auto",
                sampler="pcg", reps=REPS, msaa=MSAA, **kw):
    """One path at full size: timed per sample as phases 5-15 time theirs
    (run_main_path), every launch count set to 0 just before and read just
    after; then once through render_image (msaa^2 spp), which must take
    the same integrator to a finite, lit image. kw (integrator, nee_mode)
    goes to both. Returns {name, launches, ms (a sample), segs (traced
    segments a sample), checksum (of the first rep), image}."""
    from pbrs_tpu_torch import render

    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=scene.device)
    mods = launch_counts()
    for m in mods.values():
        m.LAUNCHES = 0
    name, mrays, wall, checksum, segs = run_main_path(
        scene, route, pix, depth, reps, sampler, msaa, **kw)
    launches = {k: m.LAUNCHES for k, m in mods.items() if m.LAUNCHES}
    img, stats = render.render_image(scene, spp=msaa * msaa, max_depth=depth,
                                     route=route, sampler_kind=sampler,
                                     **{**PINNED, **kw})
    w, h = scene.camera.width, scene.camera.height
    opts = ", ".join(f"{k}={v}" for k, v in
                     {"route": route, "sampler": sampler, **kw}.items())
    print(f"phase {phase} {label} {w}x{h} depth {depth} msaa {msaa} ({opts})"
          f" -> {name}: median {mrays:.3f} Mrays/s, {wall * 1e3:.2f} "
          f"ms/sample, {segs} traced segments a sample, checksum "
          f"{checksum:.6e}; launches {launches}; render_image "
          f"{stats.spp} spp -> {stats.integrator}, image mean "
          f"{float(img.mean()):.6e} [{smi}]")
    if (stats.integrator != name or not np.isfinite(img).all()
            or float(img.mean()) <= 0):
        raise AssertionError(f"{label}: render_image did not take {name} to "
                             "a finite, lit image")
    return {"name": name, "launches": launches, "ms": wall * 1e3,
            "segs": segs, "checksum": checksum, "image": img}


def fused_vs_general(dev, label, scene, depth, atol, rtol, phase):
    """Route auto's fused kernel against the general path per lane, sample
    0, at full width, drawing Sobol' and (its twin) PCG. The two
    implementations round apart on a few lanes whatever the sampler (on
    plates ~0.02% at atol 3e-5 rtol 2e-4, each side matching pbrs_tpu's on
    some: ROADMAP Queue 3), so the Sobol' run is held to its PCG twin: at
    most max(2 x the PCG count, 0.01%) lanes outside atol / rtol, at most
    0.01% outside atol / rtol 1e-2, checksums within GOLDEN_REL_TOL. Both
    runs are held to absolute ceilings as well: at most FUSED_SHARE of the
    lanes outside atol / rtol and FUSED_LOOSE_SHARE outside rtol 1e-2."""
    from pbrs_tpu_torch import render

    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    got = {}
    for rng in ("pcg", "sobol"):
        out = {}
        for route in ("auto", "general"):
            name, fn = render.make_integrator(scene, sampler_of(rng), depth,
                                              MSAA, route)
            out[route] = (name,) + tuple(fn(pix, 0))
        (name, rad_f, cnt_f), (_, rad_g, cnt_g) = out["auto"], out["general"]

        def outside(r):
            return int((~torch.isclose(rad_f, rad_g, atol=atol, rtol=r)
                        .all(1)).sum())

        s_f, s_g = float(rad_f.sum()), float(rad_g.sum())
        got[rng] = (outside(rtol), outside(1e-2), s_f, s_g)
        print(f"phase {phase} {name} vs general ({rng}), {label} ({n} lanes, "
              f"depth {depth}, sample 0): lanes outside atol {atol} rtol "
              f"{rtol}: {got[rng][0]}, rtol 1e-2: {got[rng][1]}; max |d| "
              f"{float((rad_f - rad_g).abs().max()):.3g}; checksum "
              f"{s_f:.6e} vs {s_g:.6e}; rays {int(cnt_f)} vs {int(cnt_g)}")
    for rng, (bad, loose, _, _) in got.items():
        if bad > FUSED_SHARE * n or loose > FUSED_LOOSE_SHARE * n:
            raise AssertionError(f"{label}: {name} parts from the general "
                                 f"path on too many lanes ({rng}: {bad}, "
                                 f"{loose} of {n})")
    bad, loose, s_f, s_g = got["sobol"]
    if (bad > max(2 * got["pcg"][0], 1e-4 * n) or loose > 1e-4 * n
            or abs(s_f - s_g) > GOLDEN_REL_TOL * abs(s_g)
            or not np.isfinite(s_f)):
        raise AssertionError(f"{label}: {name} disagrees with the general "
                             f"path under Sobol'")
    return name


def phase_sobol_main(dev, smi):
    """Phase 18, the Sobol' sampler on the three fused paths at their
    benchmark sizes: Cornell 1024^2 depth 8 through K2, plates 1024^2
    depth 5 through K3 and the interior 1024^2 depth 5 through K4, each
    through render_image on route auto and route general (the general
    path on the same Sobol' streams), then the fused route against the
    general route per lane. Returns the launches of the fused runs and
    every launch of the interior's sample 0 for phase 21."""
    runs = (("Cornell", cornell(SIZE), DEPTH, "fused", "fused_bounce",
             (ATOL, RTOL)),
            ("plates", preset_at("plates", SIZE), PLATES_DEPTH,
             "fused_single_lobe", "fused_single_lobe", (K3_ATOL, K3_RTOL)),
            ("interior", interior(SIZE, SIZE), 5, "fused_wave", "fused_wave",
             None))
    launches = {}
    for label, scene, depth, want, kernel, tol in runs:
        scene = scene.to(dev)
        fused = render_path(18, label, scene, depth, smi, sampler="sobol")
        general = render_path(18, label, scene, depth, smi, route="general",
                              sampler="sobol", reps=1)
        got = fused["launches"]
        if fused["name"] != want or not got.get(kernel):
            raise AssertionError(f"{label}: the Sobol' path did not take "
                                 f"{want}: {fused['name']}, {got}")
        launches[kernel] = got[kernel]
        a, b = fused["checksum"], general["checksum"]
        print(f"phase 18 {label} Sobol' checksums: {want} {a:.6e}, general "
              f"{b:.6e} (rel {abs(a - b) / abs(b):.2e})")
        if abs(a - b) > GOLDEN_REL_TOL * abs(b):
            raise AssertionError(f"{label}: Sobol' routes disagree")
        if tol:
            fused_vs_general(dev, label, scene, depth, *tol, 18)
        else:
            wave_vs_general(dev, label, scene, depth, "sobol", phase=18)
    seen = main_path_launches(dev, interior(SIZE, SIZE).to(dev), 5, "sobol")
    return launches, seen


def phase_folded_main(dev, smi):
    """Phase 22, folded NEE: the interior 1024^2 depth 5 through K4 folded
    (route auto) and the folded general path, mesh_ball(levels=5) 800x600
    depth 6 through the folded general path (benchmarks.json's tuned
    route for it) and K4 folded, each through render_image beside its
    two-arm twin on the same call; then wave-folded against
    general-folded per lane on both. Returns the K4 folded launches and
    every launch of the interior's folded sample 0 for phase 23."""
    launches = 0
    for label, scene, depth in (("interior", interior(SIZE, SIZE), 5),
                                ("mesh_ball", mesh_scene("mesh_ball"),
                                 MESH_DEPTH)):
        scene = scene.to(dev)
        rows = {}
        for key, kw in (("auto", {}),
                        ("general", {"route": "general", "reps": 1}),
                        ("auto folded", {"nee_mode": "folded"}),
                        ("general folded", {"nee_mode": "folded",
                                            "route": "general", "reps": 1})):
            rows[key] = render_path(22, label, scene, depth, smi, **kw)
        got = rows["auto folded"]["launches"]
        if (rows["auto folded"]["name"] != "fused_wave_folded"
                or not got.get("fused_wave")):
            raise AssertionError(f"{label}: folded route auto did not take K4 "
                                 f"folded: {rows['auto folded']['name']}, "
                                 f"{got}")
        if rows["general folded"]["name"] != "general_folded":
            raise AssertionError(f"{label}: no folded general path")
        launches += got["fused_wave"]
        for a, b in (("auto folded", "auto"),
                     ("general folded", "general")):
            ra, rb = rows[a], rows[b]
            print(f"phase 22 {label} {a} vs two-arm: {ra['ms']:.2f} vs "
                  f"{rb['ms']:.2f} ms/sample, {ra['segs']} vs {rb['segs']} "
                  f"traced segments a sample, checksum "
                  f"{ra['checksum']:.6e} vs {rb['checksum']:.6e}")
        a, b = (rows[k]["checksum"] for k in ("auto folded", "general folded"))
        if abs(a - b) > GOLDEN_REL_TOL * abs(b):
            raise AssertionError(f"{label}: folded routes disagree")
        wave_vs_general(dev, label, scene, depth, "pcg", "folded", phase=22)
    seen = main_path_launches(dev, interior(SIZE, SIZE).to(dev), 5,
                              nee_mode="folded")
    return launches, seen


def phase_direct(dev, smi):
    """Phase 24, benchmarks.json cornell_direct_256_16spp: Cornell 256^2,
    depth 2, 16 spp, the direct integrator through render_image (K1
    traces) against its plain route per pixel; then the normal and
    material visualizers."""
    from pbrs_tpu_torch import render

    scene = preset_at("cornell_box", 256).to(dev)
    row = render_path(24, "cornell_direct", scene, 2, smi, msaa=4,
                      integrator="direct")
    name, got, img = row["name"], row["launches"], row["image"]
    plain, _ = render.render_image(scene, spp=16, max_depth=2,
                                   integrator="direct", route="plain")
    n = img.shape[0] * img.shape[1]
    bad = int((~np.isclose(img, plain, atol=ATOL, rtol=RTOL).all(-1)).sum())
    print(f"phase 24 direct via K1 vs the plain route: pixels outside atol "
          f"{ATOL} rtol {RTOL}: {bad} of {n}; max |d| "
          f"{float(np.abs(img - plain).max()):.3g}")
    if name != "direct" or not got.get("trace_flat") or bad > 1e-4 * n:
        raise AssertionError("the direct integrator did not go through K1 "
                             "to the plain route's image")
    for kind in ("normals", "materials"):
        vis, stats = render.render_image(scene, spp=1, integrator=kind)
        print(f"phase 24 {kind} visualizer: mean {float(vis.mean()):.5f}, "
              f"{stats.traced_rays} traced")
        if not np.isfinite(vis).all() or float(vis.mean()) <= 0:
            raise AssertionError(f"the {kind} visualizer is not a finite "
                                 "image")


# ---------- K6, the gather-matmul probe, the render loop's options ----------


# K6's float operations (csrc/trace_prim_bvh.cu): one node's slab test, and
# one primitive test by kind (triangle, quad, sphere, disk); each add, sub,
# mul, div, sqrt, min/max and comparison is one.
K6_NODE_OPS = 26
K6_PRIM_OPS = (94, 69, 60, 36)
K6_SUBSET = 1 << 16  # lanes of each K6 ray set held against the plain walk
# K6 against K5 on mesh_ball's triangles (different triangle tests, so a
# ray at an edge or at a grazing angle may hit on one only): at most this
# share of lanes may differ in whether they hit, or in t beyond rtol 1e-5.
K6_K5_SHARE = 1e-4
# The stack depth at which phase 1 reports K6's resident warps (phase 25
# reports each tracer's own).
K6_INFO_DEPTH = 16
K6_KINDS = ("triangle", "quad", "sphere", "disk")


def k6_kernel_lines():
    """Phase 1's lines for K6's eight instances (kind x closest / any hit):
    registers, stack and spills (ptxas), resident warps an SM at a
    K6_INFO_DEPTH-entry stack. Fails on a stack frame or a spill."""
    from pbrs_tpu_torch.accel import mesh_bvh as mb

    for kind, name in enumerate(K6_KINDS):
        for any_hit in (False, True):
            stack, spill_st, spill_ld = ptxas_spills(
                f"trace_prim_bvh_kernelILi{kind}ELb{int(any_hit)}E")
            info = mb.kernel_info(kind, any_hit, K6_INFO_DEPTH)
            print(f"phase 1 K6 kernel, {name} "
                  f"{'any hit' if any_hit else 'closest'}: "
                  f"{info['registers']} registers, {stack} B stack, "
                  f"{spill_st} / {spill_ld} B spill stores / loads (ptxas); "
                  f"{info['warps_per_sm']} resident warps an SM at a "
                  f"{K6_INFO_DEPTH}-entry stack ({info['threads']} threads a "
                  f"block, {info['dynamic_smem']} B dynamic shared memory)")
            if stack or spill_st or spill_ld:
                raise AssertionError(f"K6 ({name}, any_hit={any_hit}) keeps "
                                     f"a stack frame or spills: {stack} B, "
                                     f"{spill_st} / {spill_ld} B")


def k6_check(tracer, rays, any_hit, subset):
    """K6 through the tracer (sorted lanes) against its plain walk on the
    lanes `subset` (None: all): (lanes whose t bits differ, whose id
    differs, hits, plain ms, {node_tests, prim_tests} of the checked
    lanes, kernel (t, id), the checked planes)."""
    from pbrs_tpu_torch.accel import mesh_bvh as mb
    from pbrs_tpu_torch.geometry import ray as ray_mod

    t_k, id_k = tracer.trace(rays, any_hit=any_hit)
    planes = ray_mod.to_planes(rays)
    if subset is not None:
        planes, t_c, id_c = planes[:, subset], t_k[subset], id_k[subset]
    else:
        t_c, id_c = t_k, id_k
    planes = planes.contiguous()
    work = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t_p, id_p = mb.walk_reference(tracer, planes, any_hit, work)
    end.record()
    torch.cuda.synchronize()
    bad_t = int((t_c.view(torch.int32) != t_p.view(torch.int32)).sum())
    bad_id = int((id_c != id_p).sum())
    return (bad_t, bad_id, int(torch.isfinite(t_c).sum()),
            start.elapsed_time(end), work, (t_k, id_k), (planes, id_c))


def left_turns(tracer):
    """Per leaf-order slot, the pairs above its leaf whose left child holds
    it: the right children that a pair walk ending in that leaf has tested
    and that K6's earlier skip-link walk does not reach."""
    refs = tracer.nodes[:, 12:16].cpu().contiguous().view(torch.int32).numpy()
    above = np.zeros(tracer.n_pairs, np.int64)
    turns = np.zeros(tracer.n_prims, np.int64)
    for p in range(1, tracer.n_pairs):
        for side in (0, 1):
            ref, cnt = refs[p, 2 * side], refs[p, 2 * side + 1]
            k = above[p] + (side == 0)
            if cnt > 0:
                turns[ref:ref + cnt] = k
            else:
                above[ref] = k
    return turns


def skip_walk_node_tests(tracer, planes, ids, work, any_hit, turns):
    """The node tests the skip-link walk makes for these lanes: the pair
    walk's, less the NaN box beside the root (one a live lane) and, for an
    any hit, the right children tested ahead of the hit
    (tests/test_torch_mesh_bvh.py holds this count against that walk)."""
    ahead = 0
    if any_hit:
        hit = ids[ids >= 0].long().cpu().numpy()
        slot_of = np.zeros(int(tracer.slot_gid.max()) + 1, np.int64)
        slot_of[tracer.slot_gid.cpu().numpy()] = np.arange(tracer.n_prims)
        ahead = int(turns[slot_of[hit]].sum())
    return work["node_tests"] - int((planes[6] > 0).sum()) - ahead


def phase_k6(dev, smi):
    """Phase 25, K6 (csrc/trace_prim_bvh.cu) on its own path, the
    PrimBVHTracer / MeshBVHTracer entry points (no render path reaches
    it): each tracer of prof_rounds.k6_sets on 2^20 coherent and 2^20
    incoherent rays, closest and any hit, against the plain walk on every
    16th lane (all lanes of mesh_ball's coherent closest hit, the timed
    entry); mesh_ball's closest hits against K5's, and K5's ms on the
    same planes; the whole MeshBVHTracer.trace call; a poisoned pair table;
    the device ms a launch and its bound. Returns the kernel's report and
    its launches."""
    import copy

    from pbrs_tpu_torch.accel import mesh_bvh as mb
    from pbrs_tpu_torch.accel import treelet as tl
    from pbrs_tpu_torch.geometry import ray as ray_mod
    from pbrs_tpu_torch.tools import prof_rounds as pr

    sets = pr.k6_sets(dev)
    for label, (tracer, _, _) in sets.items():
        info = [mb.kernel_info(tracer.kind, ah, tracer.stack_depth)
                for ah in (False, True)]
        print(f"phase 25 K6 {label}: {tracer.n_prims} prims, "
              f"{tracer.num_nodes} nodes, {tracer.n_pairs} pairs, a "
              f"{tracer.stack_depth}-entry stack; {info[0]['warps_per_sm']} "
              f"/ {info[1]['warps_per_sm']} resident warps an SM (closest / "
              f"any hit; {info[0]['dynamic_smem']} B dynamic shared memory "
              f"a block)")
    subset = torch.arange(0, N_RAYS, N_RAYS // K6_SUBSET, device=dev)
    mb.LAUNCHES = 0
    results = {}
    for label, (tracer, coherent, incoherent) in sets.items():
        for rays_label, rays in (("coherent", coherent),
                                 ("incoherent", incoherent)):
            for any_hit in (False, True):
                entry = (label == "mesh_ball triangles"
                         and rays_label == "coherent" and not any_hit)
                results[label, rays_label, any_hit] = k6_check(
                    tracer, rays, any_hit, None if entry else subset)
    launches = mb.LAUNCHES
    report = {"max_abs_err": 0.0}
    bad_total = 0
    set_ms, set_bound = [], []
    for (label, rays_label, any_hit), res in results.items():
        bad_t, bad_id, hits, plain_ms, work, _, (checked, ids) = res
        tracer, rays = sets[label][0], sets[label][1 if rays_label ==
                                                      "coherent" else 2]
        planes = pr.k6_launch_planes(tracer, rays)
        ms = cuda_ms(lambda: mb.trace_planes(tracer, planes, any_hit), 10)
        entry = (label, rays_label, any_hit) == ("mesh_ball triangles",
                                                 "coherent", False)
        scale = 1 if entry else N_RAYS / K6_SUBSET
        tables = 4 * (tracer.nodes.numel() + tracer.fields.numel()
                      + tracer.slot_gid.numel())
        # The bound as K6's skip-link walk counted it: ray bytes and the
        # tables against that walk's node tests (the pair walk's beside it).
        skip_nodes = skip_walk_node_tests(tracer, checked, ids, work,
                                          any_hit, left_turns(tracer))
        prims = scale * work.get("prim_tests", 0)
        b_ms, by = bound(N_RAYS * (7 * 4 + 8) + tables, scale * skip_nodes
                         * K6_NODE_OPS + prims * K6_PRIM_OPS[tracer.kind])
        b_pair, by_pair = bound(N_RAYS * (7 * 4 + 8) + tables, scale * work[
            "node_tests"] * K6_NODE_OPS + prims * K6_PRIM_OPS[tracer.kind])
        mode = "any hit" if any_hit else "closest"
        print(f"phase 25 K6 {label}, {rays_label} {mode}: {N_RAYS} rays, "
              f"{hits} hits of {int(N_RAYS / scale)} checked; lanes "
              f"differing from the plain walk: t bits {bad_t}, id {bad_id}; "
              f"{ms:.4f} ms a launch, plain {plain_ms:.2f} ms, bound "
              f"{b_ms:.4f} ms ({by}; {scale * skip_nodes:.6g} node tests of "
              f"the skip-link walk, {prims:.6g} primitive tests; the pair "
              f"walk's {scale * work['node_tests']:.6g} node tests: "
              f"{b_pair:.4f} ms, {by_pair}) [{smi}]")
        bad_total += bad_t + bad_id
        set_ms.append(ms)
        set_bound.append(b_ms)
        if entry:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=by)
    if bad_total:
        raise AssertionError("K6 disagrees with its plain walk")
    report.update(sets_mean_ms=sum(set_ms) / len(set_ms),
                  sets_mean_bound_ms=sum(set_bound) / len(set_bound))
    print(f"phase 25 K6 over the {len(set_ms)} sets: mean "
          f"{report['sets_mean_ms']:.4f} ms a launch, mean bound "
          f"{report['sets_mean_bound_ms']:.4f} ms [{smi}]")
    # K6 against K5 on the same triangles. K5 settles exact-t ties by the
    # lowest id, K6 by the first leaf visited; their triangle tests differ,
    # so only t and whether a ray hits are compared.
    tracer, coherent, incoherent = sets["mesh_ball triangles"]
    g = tracer.fields.cpu().numpy()
    order = np.argsort(tracer.slot_gid.cpu().numpy())
    p0, p1, p2 = (g[order, 3 * k:3 * k + 3] for k in range(3))
    fam = tl.tri_tracer(p0, p1, p2, 0, device=dev)
    for rays_label, rays in (("coherent", coherent),
                             ("incoherent", incoherent)):
        t6 = results["mesh_ball triangles", rays_label, False][5][0]
        t5, _ = fam.trace(rays)
        h5, h6 = torch.isfinite(t5), torch.isfinite(t6)
        hit_diff = int((h5 != h6).sum())
        both = h5 & h6
        t_diff = int((both & ~torch.isclose(t6, t5, rtol=1e-5,
                                            atol=0.0)).sum())
        err = float((t6 - t5).abs()[both].max()) if bool(both.any()) else 0.0
        planes = pr.k6_launch_planes(tracer, rays)
        k5_ms = cuda_ms(lambda: tl.trace_planes(fam, planes), 10)
        k6_ms = cuda_ms(lambda: mb.trace_planes(tracer, planes), 10)
        print(f"phase 25 K6 vs K5 on mesh_ball, {rays_label} closest: "
              f"lanes hitting on one only {hit_diff}, t beyond rtol 1e-5 "
              f"{t_diff} of {int(both.sum())} hit by both; max |dt| "
              f"{err:.3g}; on the same planes K6 {k6_ms:.4f} ms, K5 "
              f"{k5_ms:.4f} ms a launch [{smi}]")
        if max(hit_diff, t_diff) > K6_K5_SHARE * N_RAYS:
            raise AssertionError("K6 and K5 disagree on mesh_ball")
    call_ms = cuda_ms(lambda: tracer.trace(coherent), 10)
    print(f"phase 25 K6 MeshBVHTracer.trace on mesh_ball's {N_RAYS} "
          f"coherent rays (sort, K6, un-permute): {call_ms:.4f} ms, K6 "
          f"alone {report['ms']:.4f} ms [{smi}]")
    # A poisoned pair table (every interior child below pair 0 points back
    # to the root's pair) terminates: rays missing the root box miss; rays
    # that enter it cycle, fill their stack and stop at the cap of n_pairs
    # pair fetches, as the plain walk does.
    bad = copy.copy(tracer)
    bad.nodes = tracer.nodes.clone()
    refs = bad.nodes[:, 12:16].view(torch.int32)
    root_pair = int(refs[0, 0])
    for side in (0, 1):
        inner = refs[1:, 2 * side + 1] == 0
        refs[1:, 2 * side][inner] = root_pair
    n = K6_SUBSET
    miss = ray_mod.make_rays(torch.full((n, 3), 100.0, device=dev),
                             torch.tensor([[1.0, 0.0, 0.0]],
                                          device=dev).expand(n, 3))
    # Camera rays that hit the mesh enter the root box and a child box.
    entry_t = results["mesh_ball triangles", "coherent", False][5][0]
    cam = ray_take(coherent, torch.nonzero(torch.isfinite(entry_t))[:n, 0])
    t0 = time.time()
    t_m, id_m = bad.trace(miss)
    t_c, id_c = bad.trace(cam, sort_rays=False)
    torch.cuda.synchronize()
    secs = time.time() - t0
    work = {}
    t_p, id_p = mb.walk_reference(bad, ray_mod.to_planes(cam), False, work)
    differ = int(((t_c.view(torch.int32) != t_p.view(torch.int32))
                  | (id_c != id_p)).sum())
    n_cam = cam.origin.shape[0]
    fetches = work["node_tests"] / 2 / n_cam
    print(f"phase 25 K6 poisoned pair table ({bad.n_pairs} pairs, a "
          f"{bad.stack_depth}-entry stack): {n} rays missing the root -> "
          f"{int(torch.isinf(t_m).sum())} inf, {int((id_m == -1).sum())} id "
          f"-1; {n_cam} camera rays that hit the mesh ended after {fetches} "
          f"pair fetches a ray (the cap: {bad.n_pairs}), lanes differing "
          f"from the plain walk {differ}; {secs:.2f} s")
    if not (bool(torch.isinf(t_m).all()) and bool((id_m == -1).all())
            and differ == 0 and n_cam == n and fetches == bad.n_pairs):
        raise AssertionError("a poisoned pair table did not end at the cap "
                             "as the plain walk does")
    return report, launches


def phase_mm(dev, smi):
    """Phase 26, the gather-matmul probe (csrc/mm_probe.cu) on its own
    path, tools/prof_rounds.py Q2: its tile, then [1728, 128] x [128, 1024]
    bf16 at reps 100 and 400 against the plain version (bit-equal, as
    measured: rounding the running sum absorbs the reps-1 products'
    last-bit differences), then Q2's
    own timings: the probe's ms a launch and a round, its bound, and
    cuBLAS: one torch.matmul of the operands a round, and the probe's
    library time, one torch.matmul of the operands stacked `reps` times
    along k (the same sum of products in one call). At reps 1 the
    product is the result, and where a column sums three or more table
    entries the tensor cores' sum may round otherwise than the float32
    matmul's: held to one unit in the last place of the plain value."""
    from pbrs_tpu_torch.tools import prof_rounds as pr

    tab, mask = pr.probe_operands(0, dev)
    rows, cols = pr.TILE_ROWS, pr.TILE_COLS
    blocks = tab.shape[0] // rows * (mask.shape[1] // cols)
    print(f"phase 26 mm probe tile: {rows} x {cols} of the "
          f"{tab.shape[0]} x {mask.shape[1]} result a block (one warpgroup, "
          f"wgmma m64n{cols}k16), {blocks} blocks")
    pr.LAUNCHES = 0
    outs = {reps: pr.mm_probe(tab, mask, reps) for reps in (100, 400)}
    launches = pr.LAUNCHES
    report = {"max_abs_err": 0.0}
    plain = {}
    for reps, got in outs.items():
        want = pr.mm_reference(tab, mask, reps)
        diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        err = float((got - want).abs().max())
        plain[reps] = cuda_ms(lambda: pr.mm_reference(tab, mask, reps), 2)
        print(f"phase 26 mm probe reps {reps}: elements not bit-equal to the "
              f"plain version {diff}, max |d| {err:.3g}")
        if diff:
            raise AssertionError("the probe disagrees with its plain version")
        report["max_abs_err"] = max(report["max_abs_err"], err)
    one, want = pr.mm_probe(tab, mask, 1), pr.mm_reference(tab, mask, 1)
    d = (one - want).abs()
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"),
                                                   device=dev)) - want.abs()
    beyond = int((d > ulp).sum())
    print(f"phase 26 mm probe reps 1: elements not bit-equal "
          f"{int((one.view(torch.int32) != want.view(torch.int32)).sum())}, "
          f"more than one ulp apart {beyond}, max |d| {float(d.max()):.3g}")
    if beyond:
        raise AssertionError("the probe's product at reps 1 is more than one "
                             "ulp from the plain version's")
    for row in pr.q2(dev):
        reps = row["reps"]
        print(f"phase 26 mm probe reps {reps}: {row['ms']:.4f} ms a launch "
              f"({row['us_per_round']:.3f} us a round), plain "
              f"{plain[reps]:.3f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), cuBLAS one round "
              f"{row['cublas_matmul_us']:.3f} us, k-stacked call "
              f"{row['cublas_stacked_ms']:.4f} ms [{smi}]")
        if reps == 100:
            report.update(ms=row["ms"], plain_ms=plain[reps],
                          bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                          library_ms=row["cublas_stacked_ms"])
    return report, launches


def phase_options(dev, smi):
    """Phase 27, the render loop's options on the card: Cornell 256^2,
    depth 8, 4 spp through render_image with a Gaussian filter, with
    use_nee=False and with debug_checks (each on the general path through
    K1, finite, the audit clean); a checkpoint written at sample 4 of 16
    and resumed equals an uninterrupted film (route auto, K2) bit for bit;
    the CLI with --checkpoint, --filter and --debug_checks, resumed."""
    from pbrs_tpu_torch import cli, render

    scene = cornell(256).to(dev)
    mods = launch_counts()
    for kw in ({"pixel_filter": ("gaussian", 1.5)}, {"use_nee": False},
               {"debug_checks": True}):
        for m in mods.values():
            m.LAUNCHES = 0
        img, stats = render.render_image(scene, spp=4, max_depth=DEPTH,
                                         **PINNED, **kw)
        got = {k: m.LAUNCHES for k, m in mods.items() if m.LAUNCHES}
        print(f"phase 27 Cornell 256^2 {kw}: {stats.integrator}, launches "
              f"{got}, image mean {float(img.mean()):.5f}, audit "
              f"{stats.audit}")
        if (stats.integrator != "general" or not got.get("trace_flat")
                or not np.isfinite(img).all() or float(img.mean()) <= 0
                or (stats.audit is not None and sum(stats.audit.values()))):
            raise AssertionError(f"render_image with {kw} failed")
    full = render.Film(256, 256)
    _, stats = render.render_image(scene, spp=16, max_depth=DEPTH, film=full,
                                   **PINNED)
    make = render.make_integrator

    def stop_at_4(*a, **k):
        name, fn = make(*a, **k)

        def fn4(pix, s):
            if s == 4:
                raise KeyboardInterrupt
            return fn(pix, s)
        return name, fn4

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "film.npz")
        render.make_integrator = stop_at_4
        try:
            render.render_image(scene, spp=16, max_depth=DEPTH,
                                checkpoint_path=ckpt, **PINNED)
            raise AssertionError("the interrupt did not reach the caller")
        except KeyboardInterrupt:
            pass
        finally:
            render.make_integrator = make
        film = render.Film.load(ckpt)
        at = film.samples_done
        render.render_image(scene, spp=16, max_depth=DEPTH, film=film,
                            checkpoint_path=ckpt, **PINNED)
        same = int((film.accum.view(np.int32)
                    != full.accum.view(np.int32)).sum())
        print(f"phase 27 checkpoint at sample {at} of 16 ({stats.integrator})"
              f", resumed: film values not bit-equal to the uninterrupted "
              f"film {same} of {full.accum.size}")
        if at != 4 or same or stats.integrator != "fused":
            raise AssertionError("a resumed film differs from an "
                                 "uninterrupted one")
        out = os.path.join(tmp, "c.exr")
        argv = ["--resolution", "256x256", "--msaa", "2", "--depth", "5",
                "--filter", "gaussian:1.5", "--checkpoint", ckpt,
                "--checkpoint_every", "2", "--debug_checks", "--output", out]
        os.remove(ckpt)
        lines = []
        for _ in range(2):
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                rc = cli.main(argv)
            lines.append(said.getvalue())
            if rc:
                raise AssertionError(f"the CLI exited {rc}")
        resumed = [ln for ln in lines[1].splitlines() if "resuming" in ln]
        print(f"phase 27 cli --filter --checkpoint --debug_checks: rc 0, "
              f"then {resumed}; "
              f"{[ln for ln in lines[0].splitlines() if 'violation' in ln]}")
        if not resumed or "debug_checks: 0 violation(s)" not in lines[0]:
            raise AssertionError("the CLI did not resume from its checkpoint")


def phase_accuracy(dev, smi):
    """Phase 28, the accuracy check of tools/regen_accuracy.py on the card:
    Cornell 256^2, depth 8, 1024 spp, its camera, route auto (K2); seed 3
    against out/accuracy/cornell_1024spp_seed2.exr (the JAX package's
    render) must be below out/accuracy/summary.json's bar; seed 2 (the
    reference's own seed) is printed as a parity figure."""
    from pbrs_tpu_torch import render
    from pbrs_tpu_torch.io import image

    ref = image.read_exr(os.path.join(REPO, "out", "accuracy",
                                      "cornell_1024spp_seed2.exr"))
    with open(os.path.join(REPO, "out", "accuracy", "summary.json")) as f:
        bar = json.load(f)["bar"]
    scene = cornell(256).to(dev)
    mse = {}
    for seed in (3, 2):
        t0 = time.time()
        img, stats = render.render_image(scene, spp=1024, max_depth=DEPTH,
                                         seed=seed, **PINNED)
        mse[seed] = float(((img - ref) ** 2).mean())
        print(f"phase 28 accuracy: Cornell 256^2 depth {DEPTH} 1024 spp seed "
              f"{seed} via {stats.integrator}: MSE vs the JAX package's "
              f"seed-2 render {mse[seed]:.4e} (bar {bar}); "
              f"{time.time() - t0:.1f} s [{smi}]")
        if stats.integrator != "fused" or not np.isfinite(img).all():
            raise AssertionError("the accuracy render did not take K2")
    if not mse[3] < bar:
        raise AssertionError(f"MSE {mse[3]} is not below {bar}")


# ------------- the Fourier BSDF and compaction (phases 29-30) ---------------

# benchmarks.json's checksums of the same configs (the JAX package's own
# sample ids and lane order): printed beside the port's, a cross-check only.
BENCH_CHECKSUM = {"fourier_plastic": 1192460.9, "mesh_ball": 1759034.8,
                  "everything": 4219447.5}
FOURIER_DEPTH = 5  # benchmarks.json fourier_plastic_800x600


def bench_scene(name):
    """A scene at its benchmarks.json size: fourier_plastic and
    mesh_ball(levels=5) at 800x608, everything at 800x800."""
    from pbrs_tpu_torch import cli

    if name == "fourier_plastic":
        return preset_at(name, 800, 608)
    if name == "mesh_ball":
        return cli.with_resolution(mesh_scene(name), 800, 608)
    return mesh_scene(name)


def route_figures(phase, label, scene, depth, smi, route="auto",
                  nee_mode="twoarm", compact=False, want=()):
    """One route of a scene at full width: bench.py's timing loop
    (run_main_path, one rep of SAMPLES sample indices) with every launch
    count set to 0 just before and read just after, then the busy share of
    a one-sample torch.profiler window
    (profiling.profile_route) and, compacted, the schedule. Fails unless
    each kernel in `want` launched and the checksum is finite and lit."""
    from pbrs_tpu_torch import profiling

    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=scene.device)
    mods = launch_counts()
    for m in mods.values():
        m.LAUNCHES = 0
    name, mrays, wall, checksum, segs = run_main_path(
        scene, route, pix, depth, 1, "pcg", MSAA, nee_mode=nee_mode,
        compact_pilot=pix if compact else None)
    launches = {k: m.LAUNCHES for k, m in mods.items() if m.LAUNCHES}
    prof = profiling.profile_route(scene, route, depth, MSAA, samples=1,
                                   warmup=1, nee_mode=nee_mode,
                                   compact=compact)
    w, h = scene.camera.width, scene.camera.height
    print(f"phase {phase} {label} {w}x{h} depth {depth} msaa {MSAA} "
          f"({route}, {nee_mode}{', compact' if compact else ''}) -> {name}: "
          f"median {mrays:.3f} Mrays/s, {wall * 1e3:.2f} ms/sample, "
          f"{wall * MSAA * MSAA:.4f} s to 4 spp; busy share "
          f"{prof['busy_share']:.3f} ({prof['device_busy_ms_per_sample']:.2f}"
          f" of {prof['wall_ms_per_sample']:.2f} ms a sample); schedule "
          f"{prof['schedule']}; {segs} traced segments a sample; launches "
          f"{launches}; checksum {checksum:.6e} (benchmarks.json "
          f"{BENCH_CHECKSUM.get(label)}, a cross-check only) [{smi}]")
    missing = [k for k in want if not launches.get(k)]
    if missing or not np.isfinite(checksum) or checksum <= 0:
        raise AssertionError(f"{label} ({route}, {nee_mode}): kernels "
                             f"{missing} not launched or an unlit image")
    if compact and (prof["schedule"] is None or not name.endswith(
            "_compact")):
        raise AssertionError(f"{label}: the compacted route did not compact")
    return {"name": name, "launches": launches, "ms": wall * 1e3,
            "schedule": prof["schedule"], "checksum": checksum}


def sample0(scene, depth, route="auto", nee_mode="twoarm", compact=False):
    """(name, radiance, traced segments, schedule, compacted launches) of
    sample 0 through make_integrator."""
    from pbrs_tpu_torch import render

    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=scene.device)
    name, fn = render.make_integrator(scene, sampler_of("pcg"), depth, MSAA,
                                      route, nee_mode=nee_mode,
                                      compact_pilot=pix if compact else None)
    rad, cnt = fn(pix, 0)
    return name, rad, int(cnt), getattr(fn, "schedule", None), getattr(
        fn, "compacted", 0)


def fourier_vs_general(phase, label, scene, depth):
    """The wave route with the Fourier override (route auto) against the
    general path per lane, sample 0, at full width: at most FUSED_SHARE of
    the lanes outside atol K4_ATOL, rtol K4_RTOL and FUSED_LOOSE_SHARE
    outside rtol 1e-2 (phase 18's caps), the checksums within
    GOLDEN_REL_TOL."""
    name, rad_w, cnt_w, _, _ = sample0(scene, depth)
    _, rad_g, cnt_g, _, _ = sample0(scene, depth, "general")
    n = rad_w.shape[0]

    def outside(rtol):
        return int((~torch.isclose(rad_w, rad_g, atol=K4_ATOL, rtol=rtol)
                    .all(1)).sum())

    bad, loose = outside(K4_RTOL), outside(1e-2)
    s_w, s_g = float(rad_w.sum()), float(rad_g.sum())
    print(f"phase {phase} {name} vs general, {label} ({n} lanes, depth "
          f"{depth}, sample 0): lanes outside atol {K4_ATOL} rtol {K4_RTOL}: "
          f"{bad}, rtol 1e-2: {loose}; max |d| "
          f"{float((rad_w - rad_g).abs().max()):.3g}; checksum {s_w:.6e} vs "
          f"{s_g:.6e}; rays {cnt_w} vs {cnt_g}")
    if (name != "fused_wave" or bad > FUSED_SHARE * n
            or loose > FUSED_LOOSE_SHARE * n or not np.isfinite(s_w)
            or abs(s_w - s_g) > GOLDEN_REL_TOL * abs(s_g)):
        raise AssertionError(f"{label}: the Fourier override parts from the "
                             "general path")


def compacted_vs_masked(phase, label, scene, depth, route, nee_mode):
    """A route compacted to its measured schedule against the same route
    masked, per lane, sample 0, at full width: no lane outside atol ATOL,
    rtol RTOL, equal traced segments. A launch that does not tile into
    8-lane blocks takes the masked loop, and the line says so."""
    from pbrs_tpu_torch.integrators import wavefront

    name_m, rad_m, cnt_m, _, _ = sample0(scene, depth, route, nee_mode)
    name_c, rad_c, cnt_c, sched, k = sample0(scene, depth, route, nee_mode,
                                             compact=True)
    n = rad_m.shape[0]
    bad = int((~torch.isclose(rad_c, rad_m, atol=ATOL, rtol=RTOL).all(1))
              .sum())
    bits = int((rad_c.view(torch.int32) != rad_m.view(torch.int32)).any(1)
               .sum())
    tiles = n % wavefront.COMPACT_BLOCK == 0
    print(f"phase {phase} {label} ({route}, {nee_mode}) {name_c} vs "
          f"{name_m}, sample 0, {n} lanes: schedule {sched}"
          + ("" if tiles else " (the batch does not tile into 8-lane "
             "blocks: the masked loop ran)")
          + f"; lanes outside atol {ATOL} rtol {RTOL}: {bad}, not "
          f"bit-equal {bits}; max |d| {float((rad_c - rad_m).abs().max()):.3g}"
          f"; traced segments {cnt_c} vs {cnt_m}")
    if bad or cnt_c != cnt_m or sched is None or k != int(tiles):
        raise AssertionError(f"{label}: compacted and masked {route} "
                             "disagree")


def replay_launches(phase, label, seen, check):
    """Every K4, K1 and K5 launch that main_path_launches recorded, timed
    at its lane count (CUDA events); with `check`, each also held against
    its plain version (K4 on all 30 planes, K1 closest and any hit, K5
    seeded with the running hit it was handed): every lane bit-equal."""
    from pbrs_tpu_torch.accel import fused_wave as fw
    from pbrs_tpu_torch.accel import trace_kernel as tk

    cnt = None
    for i, (tab, fin, iin, kw) in enumerate(seen["k4"]):
        cnt = torch.zeros(1, dtype=torch.int64, device=fin.device)
        ms = cuda_ms(lambda: fw.shade(tab, fin, iin, cnt, **kw), 5)
        said = ""
        if check:
            got = k4_compare(tab, fin, iin, kw)
            said = (f"; outside atol {K4_ATOL} rtol {K4_RTOL}: "
                    f"{got['outside']}, not bit-equal {got['not_bit_equal']},"
                    f" alive/spec differ {got['alive']}, shadow rays kernel "
                    f"{got['rays_k']} plain {got['rays_p']}")
            if (got["outside"] or got["not_bit_equal"] or got["alive"]
                    or got["rays_k"] != got["rays_p"]):
                raise AssertionError(f"{label}: K4 launch {i} disagrees")
        print(f"phase {phase} {label} K4 launch {i} (bounce {kw['bounce']}):"
              f" {fin.shape[1]} lanes, {int((iin[2] > 0).sum())} alive; "
              f"{ms:.4f} ms{said}")
    for i, (flat, planes, any_hit) in enumerate(seen["k1"]):
        ms = cuda_ms(lambda: tk.trace_planes(flat, planes, any_hit), 5)
        said = ""
        if check:
            bad, _, _ = k1_parity(flat, planes_rays(planes))
            said = f"; lanes differing (closest and any hit) {bad}"
            if any(bad.values()):
                raise AssertionError(f"{label}: K1 launch {i} disagrees")
        print(f"phase {phase} {label} K1 launch {i} "
              f"({'any hit' if any_hit else 'closest'}): {planes.shape[1]} "
              f"lanes, {int((planes[6] > 0).sum())} live; {ms:.4f} ms{said}")
    for i, (fam, planes, any_hit, t_in, id_in) in enumerate(seen["k5"]):
        ms = k5_ms(fam, planes, any_hit, t_in, id_in)
        said = ""
        if check:
            bad, _, _, _ = bvh_compare(fam, planes_rays(planes), t_in, id_in)
            said = f"; lanes differing {bad}"
            if any(bad.values()):
                raise AssertionError(f"{label}: K5 launch {i} disagrees")
        print(f"phase {phase} {label} K5 launch {i} "
              f"({'any hit' if any_hit else 'closest'}): {planes.shape[1]} "
              f"lanes, {int((planes[6] > 0).sum())} live; {ms:.4f} ms{said}")


def phase_fourier(dev, smi):
    """Phase 29, the Fourier BSDF: fourier_plastic at 800x608
    (benchmarks.json fourier_plastic_800x600), 4 spp, depth 5, through the
    wave route with the Fourier override (route auto, two-arm), the
    general path (two-arm) and the folded general path masked and
    compacted; the wave route against the general path per lane; every K4
    and K1 launch of the wave route's sample 0 (the override's occlusion
    rays included) bit-equal to the plain versions. Returns the launches
    of the four runs."""
    scene = bench_scene("fourier_plastic").to(dev)
    launches = {}
    for route, nee_mode, compact, want in (
            ("auto", "twoarm", False, ("fused_wave", "trace_flat")),
            ("general", "twoarm", False, ("trace_flat",)),
            ("general", "folded", False, ("trace_flat",)),
            ("general", "folded", True, ("trace_flat",))):
        row = route_figures(29, "fourier_plastic", scene, FOURIER_DEPTH, smi,
                            route, nee_mode, compact, want)
        if route == "auto" and row["name"] != "fused_wave":
            raise AssertionError("fourier_plastic: route auto did not take "
                                 f"the wave route: {row['name']}")
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    fourier_vs_general(29, "fourier_plastic", scene, FOURIER_DEPTH)
    replay_launches(29, "fourier_plastic wave",
                    main_path_launches(dev, scene, FOURIER_DEPTH), True)
    return launches


def phase_compaction(dev, smi):
    """Phase 30, compaction at the benchmarks.json sizes, on the routes the
    JAX package tuned them to: fourier_plastic (the folded general path,
    and the wave route under the Fourier override), mesh_ball(levels=5)
    800x608 depth 6 (the folded general path) and everything 800x800
    depth 5 (the wave path), compacted against masked per lane; masked and
    compacted figures for mesh_ball and everything (phase 29 has
    fourier_plastic's); every K4 / K1 / K5 launch of sample 0 timed at its
    lane count, masked and compacted, the compacted ones of all three
    held bit-equal to the plain versions. Returns the launches of the
    timed runs."""
    launches = {}
    runs = (("fourier_plastic", FOURIER_DEPTH, "general", "folded", ()),
            ("fourier_plastic", FOURIER_DEPTH, "auto", "twoarm", ()),
            ("mesh_ball", MESH_DEPTH, "general", "folded",
             ("trace_flat", "trace_bvh")),
            ("everything", EVERY_DEPTH, "auto", "twoarm",
             ("trace_flat", "trace_bvh", "fused_wave")))
    for label, depth, route, nee_mode, want in runs:
        scene = bench_scene(label).to(dev)
        if want:
            for compact in (False, True):
                row = route_figures(30, label, scene, depth, smi, route,
                                    nee_mode, compact, want)
                for k, v in row["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        compacted_vs_masked(30, label, scene, depth, route, nee_mode)
        for compact in (False, True):
            seen = main_path_launches(dev, scene, depth, nee_mode=nee_mode,
                                      route=route, compact=compact)
            replay_launches(
                30, f"{label} ({route}, {nee_mode}, "
                f"{'compacted' if compact else 'masked'})", seen,
                check=compact)
        del scene
    return launches


# ------------------- the tuner and the profiler (phases 31-32) ---------------

# Phase 31's scenes and depths: the interior's K4 main path (phase 15),
# mesh_ball at benchmarks.json's 800x608, and Cornell (K2, phase 5).
TUNER_SCENES = (("interior", 5), ("mesh_ball", MESH_DEPTH), ("cornell", DEPTH))


def tuner_scene(label):
    if label == "interior":
        return interior(SIZE, SIZE)
    if label == "mesh_ball":
        return bench_scene("mesh_ball")
    return cornell(SIZE)


def tuner_kernels(tuned):
    """The launch counts a tuned route must show: K2 or K3 for their
    shortcut, else K1 (and K4 on the wave path), and K5 where a family is
    above the BVH threshold."""
    from pbrs_tpu_torch import tuner

    if tuned.route == "auto":
        return {"fused_diffuse": ["fused_bounce"],
                "fused_single_lobe": ["fused_single_lobe"]}[tuned.label]
    want = ["trace_flat"] + (["fused_wave"] if tuned.route == "wave" else [])
    if tuner._scene_bvh_scale(tuned.scene):
        want.append("trace_bvh")
    return want


def tuner_row(dev, smi, label, depth):
    """One scene of phase 31 (see phase_tuner). Returns its figures."""
    from pbrs_tpu_torch import render, tuner
    from pbrs_tpu_torch.integrators import wavefront

    scene = tuner_scene(label).to(dev)
    w, h = scene.camera.width, scene.camera.height
    n = w * h
    # render_image's first chunk: the whole frame's lanes in Morton order.
    order = wavefront.morton_pixel_order(w, h)
    pix = torch.from_numpy(order).to(dev)
    sampler = sampler_of("pcg")
    torch.cuda.synchronize()
    t0 = time.time()
    tuned = tuner.tune(scene, sampler, pix, 0, depth=depth, msaa=MSAA)
    torch.cuda.synchronize()
    pilot_s = time.time() - t0
    times = "; ".join(f"{k} {v * 1e3:.3f}" for k, v in tuned.times.items())
    print(f"phase 31 tuner {label} {w}x{h} depth {depth} msaa {MSAA}: "
          f"{tuned.measured} candidates timed, ms a launch (median of 2 "
          f"after a warm-up): {times or 'none (K2 / K3, unmeasured)'}; "
          f"winner {tuned.label} -> {tuned.name}, schedule {tuned.schedule};"
          f" the tune took {pilot_s:.3f} s [{smi}]")
    t0 = time.time()
    again = tuner.tune(scene, sampler, pix, 0, depth=depth, msaa=MSAA)
    again_s = time.time() - t0
    mods = launch_counts()
    for m in mods.values():
        m.LAUNCHES = 0
    t0 = time.time()
    img, stats = render.render_image(scene, spp=MSAA * MSAA, max_depth=depth,
                                     device=dev)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = {k: m.LAUNCHES for k, m in mods.items() if m.LAUNCHES}
    _, fn = render.make_integrator(scene, sampler, depth, MSAA, tuned.route,
                                   nee_mode=tuned.nee_mode,
                                   schedule=tuned.schedule,
                                   resort=tuned.resort)
    acc = torch.zeros(n, 3, device=dev)
    for s in range(MSAA * MSAA):
        acc = acc + fn(pix, s)[0]
    film = render.Film(w, h, samples_done=MSAA * MSAA)
    film.accum[order] = acc.cpu().numpy()
    pinned = film.mean_image()
    bits = int((img.view(np.int32) != pinned.view(np.int32)).sum())
    missing = [k for k in tuner_kernels(tuned) if not launches.get(k)]
    print(f"phase 31 tuner {label}: second tune -> {again.label}, cache hit "
          f"{again.cache_hit}, {again.measured} measurements, {again_s:.3f} "
          f"s; render_image at its defaults, {stats.spp} spp -> "
          f"{stats.integrator} (tuned {stats.tuned}) in {render_s:.3f} s, "
          f"launches {launches}; image values not bit-equal to the winner's "
          f"route pinned through make_integrator: {bits} of {img.size}")
    shortcut = label == "cornell"
    if (again.label != tuned.label or again.measured
            or again.cache_hit == shortcut
            or (tuned.measured == 0) != shortcut
            or (shortcut and tuned.label != "fused_diffuse")
            or stats.tuned != tuned.label or stats.integrator != tuned.name
            or bits or missing or not np.isfinite(img).all()
            or float(img.mean()) <= 0):
        raise AssertionError(f"{label}: the tuned render is not the winner's "
                             f"route (kernels {missing} not launched)")
    return {"scene": label, "winner": tuned.label, "name": tuned.name,
            "ms": {k: v * 1e3 for k, v in tuned.times.items()},
            "tune_s": pilot_s, "render_s": render_s, "launches": launches}


def tuner_refuses(dev):
    """A candidate whose radiance is not finite (the wave path patched
    here, and only here) raises out of render_image."""
    from pbrs_tpu_torch import cli, render, tuner
    from pbrs_tpu_torch.accel import fused_wave as fw

    scene = cli.with_resolution(mesh_scene("mesh_ball"), 256, 256).to(dev)
    real = fw.FusedWaveIntegrator.render_samples

    def non_finite(self, *a, **k):
        rad, cnt = real(self, *a, **k)
        return torch.full_like(rad, float("nan")), cnt

    fw.FusedWaveIntegrator.render_samples = non_finite
    try:
        render.render_image(scene, spp=1, max_depth=MESH_DEPTH,
                            compact=False, device=dev)
    except tuner.CandidateError as e:
        print(f"phase 31 a wave candidate patched to a non-finite radiance: "
              f"render_image raises {type(e).__name__}: {e}")
    else:
        raise AssertionError("a non-finite candidate did not raise")
    finally:
        fw.FusedWaveIntegrator.render_samples = real


def phase_tuner(dev, smi):
    """Phase 31, route auto's tuner at full width: the interior 1024^2
    depth 5 and mesh_ball 800x608 depth 6 (every candidate's ms a launch,
    the winner, what the tune took) and Cornell 1024^2 depth 8 (K2,
    unmeasured), each on render_image's first chunk (the frame in Morton
    order). For each: a second tune is a cache hit with no measurement;
    render_image at its defaults, 4 spp, takes the same winner, launches
    its kernels (every launch count set to 0 just before and read just
    after) and equals bit for bit the image of the winner's route pinned
    through make_integrator. Then a candidate made non-finite raises out of
    render_image. The decision cache lives in a directory of this phase."""
    keys = ("PBRS_TUNER_CACHE", "PBRS_TUNER_NOCACHE")
    saved = {k: os.environ.get(k) for k in keys}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["PBRS_TUNER_CACHE"] = tmp
        os.environ.pop("PBRS_TUNER_NOCACHE", None)
        try:
            rows = [tuner_row(dev, smi, label, depth)
                    for label, depth in TUNER_SCENES]
            tuner_refuses(dev)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return rows


def phase_profiler(dev, smi):
    """Phase 32, the CLI's --phase_timings and --profile_dir on Cornell
    1024^2, depth 8, msaa 2 (route auto, K2): the per-phase device timings
    printed before the render, and a torch.profiler Chrome trace of the
    render that names K2's kernel (fused_bounce_kernel)."""
    from pbrs_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "prof")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = cli.main(["--scene_name", "cornell_box", "--resolution",
                           "1024x1024", "--msaa", str(MSAA), "--depth",
                           str(DEPTH), "--phase_timings", "--profile_dir",
                           prof, "--output", os.path.join(tmp, "c.exr")])
        traces = sorted(glob.glob(os.path.join(prof, "*.json")))
        names = set()
        for path in traces:
            with open(path) as f:
                names |= {e.get("name", "") for e in
                          json.load(f)["traceEvents"]}
        size = sum(os.path.getsize(p) for p in traces)
    lines = said.getvalue().splitlines()
    phases = [ln.strip() for ln in lines if ln.startswith("  ")
              and not ln.strip().startswith("sample")]
    last = [ln for ln in lines if "whole render time" in ln]
    k2 = sorted(nm for nm in names if "fused_bounce_kernel" in nm)
    print(f"phase 32 cli --phase_timings --profile_dir, Cornell 1024^2 depth "
          f"{DEPTH} msaa {MSAA}: rc {rc}; per-phase device timings (1 "
          f"launch): {'; '.join(phases)}; {last}; trace: {len(traces)} "
          f"file(s), {size} bytes, {len(names)} event names, K2's kernel "
          f"{k2} [{smi}]")
    if rc or len(phases) < 9 or not k2 or len(traces) != 1:
        raise AssertionError("the CLI's phase timings or its trace of K2 "
                             "are missing")


SHARDED_RANKS = 2  # ranks of phase 33, sharing the one card (gloo)


def sharded_jobs():
    """Phase 33's jobs (bench_multichip.layout_rank): Cornell 1024^2, depth
    8, spp 4 through render_image_sharded (general path, K1) at dp1xsp1
    (rank 0 alone), dp2xsp1 and dp1xsp2; render_batch_sharded of 4 sample
    indices with K2 on Cornell (depth 8) and with K4 on the interior
    1024^2 (depth 5, K1 + K5 tracing), each at dp1xsp1 and dp2xsp1."""
    jobs = [{"scene": "cornell", "dp": dp, "sp": sp, "depth": DEPTH,
             "spp": MSAA * MSAA} for dp, sp in ((1, 1), (2, 1), (1, 2))]
    for scene, kind, depth in (("cornell", "fused_diffuse", DEPTH),
                               ("interior", "fused_wave", 5)):
        jobs += [{"scene": scene, "dp": dp, "sp": 1, "depth": depth,
                  "samples": MSAA * MSAA, "integrator": kind}
                 for dp in (1, 2)]
    return jobs


def phase_sharded(dev, smi):
    """Phase 33, the sharded renderer (parallel.py) on 2 ranks sharing the
    card (gloo; NCCL refuses two ranks on one GPU), every job of
    sharded_jobs() in one spawn, each rendered once to warm up and once
    timed. dp layouts must equal dp1xsp1 bit for bit and dp1xsp2 within
    atol 2e-5 / rtol 1e-4; each row prints in bench_multichip's format.
    Returns every kernel's launches over all ranks and renders."""
    from pbrs_tpu_torch import parallel
    from pbrs_tpu_torch.scene import buffers
    from pbrs_tpu_torch.tools import bench_multichip as bm

    scenes = {"cornell": buffers.scene_to_arrays(cornell(SIZE)),
              "interior": buffers.scene_to_arrays(interior(SIZE, SIZE))}
    jobs = sharded_jobs()
    backend = parallel.choose_backend("cuda", SHARDED_RANKS,
                                      torch.cuda.device_count())
    t0 = time.time()
    res = parallel.run_ranks(bm.layout_rank, SHARDED_RANKS, scenes, jobs, 1,
                             device="cuda")
    spawn_s = time.time() - t0
    runs = res[0]["runs"]
    when = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    total = {}
    base = {}
    failures = []
    for i, (job, run) in enumerate(zip(jobs, runs)):
        launches = {}
        for r in res:
            for k, v in r["runs"][i]["launches"].items():
                launches[k] = launches.get(k, 0) + v
                total[k] = total.get(k, 0) + v
        what = job.get("integrator") or "render_image_sharded"
        key = (job["scene"], what)
        out = run["out"]
        if job["dp"] * job["sp"] == 1:
            base[key] = (out, run["seconds"])
        ref, t1 = base[key]
        row = {"config": f"{job['scene']}_{SIZE}x{SIZE}_depth{job['depth']}_"
                         f"{what}",
               "devices": job["dp"] * job["sp"],
               "layout": f"dp{job['dp']}xsp{job['sp']}",
               "wall_s": run["seconds"],
               "overhead_ratio": run["seconds"] / t1,
               "checksum": float(np.abs(out).sum()), "device": smi,
               "measured_at": when}
        if job["sp"] > 1:
            bad = int((~np.isclose(out, ref, atol=ATOL, rtol=RTOL)).sum())
            parity = f"vs dp1xsp1: {bad} values outside atol/rtol"
        else:
            bad = int((out != ref).sum())
            parity = f"vs dp1xsp1: {bad} values not bit-equal"
        print(f"phase 33 {json.dumps(row)} {parity}; launches {launches}")
        needs = {"render_image_sharded": ("trace_flat",),
                 "fused_diffuse": ("fused_bounce",),
                 "fused_wave": ("fused_wave", "trace_flat", "trace_bvh")}
        if (bad or not np.isfinite(out).all() or float(out.mean()) <= 0
                or any(not launches.get(k) for k in needs[what])):
            failures.append(row["config"] + " " + row["layout"])
    print(f"phase 33 sharded: {SHARDED_RANKS} ranks on one card, backend "
          f"{backend}; spawn and all renders {spawn_s:.1f} s; launches over "
          f"all ranks {total} [{smi}]")
    if backend != "gloo" or failures:
        raise AssertionError(f"sharded renders failed: {failures}")
    return total


def phase_persistent(dev, smi):
    """Phase 34, the persistent wavefront (integrators/persistent.py)
    through dispatch.make_trace_fns: Cornell 1024^2, depth 8, sample 0 of
    every pixel on a pool of N and N/4 lanes (K1), and mesh_ball 800x608,
    depth 6, on N/4 lanes (K1 + K5), each against the masked general path
    on the same tracers (rtol 1e-5, atol 1e-5: tests/test_persistent.py)
    with no more traced rays than 1.01x the masked loop's. Prints wall
    time (one synchronized run after a masked warm-up), iterations and ray
    counts. Returns the launches of the persistent runs."""
    from pbrs_tpu_torch.accel import dispatch
    from pbrs_tpu_torch.integrators import persistent, wavefront

    counters = launch_counts()
    total = {}
    failures = []
    for label, scene, depth, pools in (
            ("cornell", cornell(SIZE), DEPTH, (1, 4)),
            ("mesh_ball", bench_scene("mesh_ball"), MESH_DEPTH, (4,))):
        scene = scene.to(dev)
        w, h = scene.camera.width, scene.camera.height
        n = w * h
        pix = torch.arange(n, dtype=torch.int32, device=dev)
        samp = torch.zeros(n, dtype=torch.int32, device=dev)
        isect, occl = dispatch.make_trace_fns(scene)
        sampler = sampler_of("pcg")

        def masked():
            return wavefront.render_samples(scene, sampler, pix, samp, isect,
                                            occl, max_depth=depth, msaa=MSAA)

        masked()
        torch.cuda.synchronize()
        t0 = time.time()
        want, want_count = masked()
        torch.cuda.synchronize()
        masked_ms = (time.time() - t0) * 1e3
        for div in pools:
            calls = [0]

            def counting(rays):
                calls[0] += 1
                return isect(rays)

            for m in counters.values():
                m.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.time()
            got, count = persistent.render_tasks_persistent(
                scene, sampler, pix, samp, n_lanes=n // div,
                max_depth=depth, msaa=MSAA, intersect_fn=counting,
                occlude_fn=occl, return_ray_count=True)
            torch.cuda.synchronize()
            ms = (time.time() - t0) * 1e3
            launches = {k: m.LAUNCHES for k, m in counters.items()
                        if m.LAUNCHES}
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            bad = int((~torch.isclose(got, want, rtol=1e-5, atol=1e-5))
                      .any(dim=1).sum())
            ratio = float(count) / int(want_count)
            print(f"phase 34 persistent {label} {w}x{h} depth {depth}, "
                  f"{n // div} lanes for {n} tasks: {ms:.2f} ms ({calls[0]} "
                  f"iterations) vs masked {masked_ms:.2f} ms; traced rays "
                  f"{float(count):.0f} vs masked {int(want_count)} "
                  f"({ratio:.4f}x); lanes outside rtol/atol 1e-5: {bad}; "
                  f"checksum {float(got.sum()):.6e} vs "
                  f"{float(want.sum()):.6e}; launches {launches} [{smi}]")
            if (bad or ratio > 1.01 or not torch.isfinite(got).all()
                    or not launches.get("trace_flat")
                    or (label == "mesh_ball"
                        and not launches.get("trace_bvh"))):
                failures.append(f"{label} {n // div} lanes")
    if failures:
        raise AssertionError(f"persistent runs failed: {failures}")
    return total


def kernel_entry(name, source, replaces, launches, report):
    return {"name": name, "route": "cuda",
            "source": f"pbrs_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": report["max_abs_err"],
            "ms": report["ms"], "plain_ms": report["plain_ms"],
            "bound_ms": report["bound_ms"], "bound_by": report["bound_by"],
            # No single PyTorch call computes a bounce or a BVH closest
            # hit; the probe's is a matmul (phase 26).
            "library_ms": report.get("library_ms"),
            # K2 / K3: ms, plain_ms and bound_ms are means over the
            # launches of one main-path sample; beside them its sum and the
            # bounce-0 launch alone.
            # K6: ms, plain_ms and bound_ms are the entry set's (mesh_ball's
            # coherent closest hit); beside them the means over its 16 sets.
            **{k: report[k] for k in ("bounce0_ms", "sample_ms",
                                      "sample_bound_ms",
                                      "launches_per_sample", "sets_mean_ms",
                                      "sets_mean_bound_ms")
               if k in report}}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    t0 = time.time()

    def run(fn, *args, **kw):
        """fn(*args, **kw), then the seconds since the start."""
        out = fn(*args, **kw)
        print(f"[{fn.__name__} done at {time.time() - t0:.1f} s]")
        return out

    name, smi = run(phase_device)
    run(phase_build)
    k1 = run(phase_trace, dev, rng)
    k2 = run(phase_bounce, dev)
    run(phase_golden, dev)
    launches = run(phase_main, dev, smi)
    run(phase_cli)
    k3 = run(phase_single_lobe, dev)
    run(phase_single_lobe_golden, dev)
    k3_launches = run(phase_plates_main, dev, smi)
    k5 = run(phase_bvh, dev, rng, k1)
    run(phase_bvh_golden, dev)
    k5_launches = run(phase_mesh_main, dev, smi)
    k4_launches, seen = run(phase_interior_main, dev, smi)
    k4 = run(phase_wave, dev, seen)
    run(phase_interior_traces, seen, k1, k5, rng)
    k1_main_path_means(k1)
    del seen
    run(phase_wave_golden, dev)
    run(phase_interior_1080, dev, smi)
    run(phase_wave_vs_general, dev)
    sobol_launches, seen = run(phase_sobol_main, dev, smi)
    k2_sobol = run(phase_bounce, dev, "sobol", phase=19)
    k3_sobol = run(phase_single_lobe, dev, "sobol", phase=20)
    k4_sobol = run(phase_wave, dev, seen, "sobol", phase=21)
    folded_launches, seen = run(phase_folded_main, dev, smi)
    k4_folded = run(phase_wave, dev, seen, nee_mode="folded", phase=23)
    del seen
    run(phase_direct, dev, smi)
    k6, k6_launches = run(phase_k6, dev, smi)
    mm, mm_launches = run(phase_mm, dev, smi)
    run(phase_options, dev, smi)
    run(phase_accuracy, dev, smi)
    fourier_launches = run(phase_fourier, dev, smi)
    compact_launches = run(phase_compaction, dev, smi)
    tuned_rows = run(phase_tuner, dev, smi)
    run(phase_profiler, dev, smi)
    sharded_launches = run(phase_sharded, dev, smi)
    persistent_launches = run(phase_persistent, dev, smi)
    slice_launches = {k: fourier_launches.get(k, 0)
                      + compact_launches.get(k, 0)
                      for k in ("trace_flat", "trace_bvh", "fused_wave")}
    k2_src = "pbrs_tpu/accel/fused_kernel.py:329"
    k3_src = "pbrs_tpu/accel/fused_single_lobe.py:506"
    k4_src = "pbrs_tpu/accel/fused_wave.py:158"
    kernels = [
        kernel_entry("trace_flat", "trace_flat.cu",
                     "pbrs_tpu/accel/trace_pallas.py:127",
                     k5_launches["trace_flat"] + k4_launches["trace_flat"],
                     k1),
        kernel_entry("fused_bounce", "fused_bounce.cu", k2_src,
                     launches["fused_bounce"], k2),
        kernel_entry("fused_single_lobe", "fused_single_lobe.cu", k3_src,
                     k3_launches["fused_single_lobe"], k3),
        kernel_entry("trace_bvh", "trace_bvh.cu",
                     "pbrs_tpu/accel/treelet.py:310 and :479",
                     k5_launches["trace_bvh"], k5),
        kernel_entry("fused_wave", "fused_wave.cu", k4_src,
                     k4_launches["fused_wave"], k4),
        kernel_entry("fused_bounce_sobol", "fused_bounce.cu", k2_src,
                     sobol_launches["fused_bounce"], k2_sobol),
        kernel_entry("fused_single_lobe_sobol", "fused_single_lobe.cu",
                     k3_src, sobol_launches["fused_single_lobe"], k3_sobol),
        kernel_entry("fused_wave_sobol", "fused_wave.cu", k4_src,
                     sobol_launches["fused_wave"], k4_sobol),
        kernel_entry("fused_wave_folded", "fused_wave.cu", k4_src,
                     folded_launches, k4_folded),
        kernel_entry("trace_prim_bvh", "trace_prim_bvh.cu",
                     "pbrs_tpu/accel/mesh_pallas.py:113", k6_launches, k6),
        kernel_entry("mm_probe", "mm_probe.cu", "tools/_prof_rounds.py:72",
                     mm_launches, mm),
    ]
    tuned_launches = {}
    for row in tuned_rows:
        for k, v in row["launches"].items():
            tuned_launches[k] = tuned_launches.get(k, 0) + v
    for entry in kernels:
        if entry["name"] in slice_launches:
            # Launches on the Fourier and compacted routes of phases 29-30.
            entry["fourier_compact_launches"] = slice_launches[entry["name"]]
        if entry["name"] in tuned_launches:
            # Launches of phase 31's renders through the tuned route auto.
            entry["tuned_launches"] = tuned_launches[entry["name"]]
        # Launches of phase 33's sharded renders (both ranks) and of phase
        # 34's persistent loops; 0 for a kernel they do not reach.
        entry["sharded_launches"] = sharded_launches.get(entry["name"], 0)
        entry["persistent_launches"] = persistent_launches.get(
            entry["name"], 0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
