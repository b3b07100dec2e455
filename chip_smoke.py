#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from pbrs_tpu_torch/csrc/ and prints what
ptxas reports for them and which host BVH builder runs, checks each kernel
against its plain PyTorch version on the card, renders golden checksums
through the kernels, drives the main paths through the port's routes --
Cornell 1024^2, depth 8, msaa 2 (fused diffuse kernel K2), plates 1024^2,
depth 5, msaa 2 (fused single-lobe kernel K3), and the mesh scenes through
the general path with the flat trace (K1) and the BVH trace (K5):
mesh_ball(levels=5) 800x600, depth 6, and everything 800x800, depth 5,
msaa 2, PCG seed 0 -- and runs the CLI. Every phase prints
one line or more; a failing phase raises, so the script exits non-zero.
There is no CPU path: without a CUDA device the script fails. The line
before the last is {"kernels": [...]}, one entry per kernel with its
launches on its main path, error against its plain version, device time,
plain time and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_REL_TOL = 2e-3  # tests/test_golden.py REL_TOL
ATOL, RTOL = 2e-5, 1e-4  # tests/test_fused.py:38
K3_ATOL, K3_RTOL = 3e-5, 2e-4  # tests/test_fused_single_lobe.py:73
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
MESH_LEVELS, MESH_DEPTH, EVERY_DEPTH = 5, 6, 5  # benchmarks.json cells
BVH_SET = 1 << 16  # rays of each K5 parity set
BVH_COUNT_SAMPLE = 4096  # lanes whose walk is counted for K5's bound
SLEEP_CYCLES = 20_000_000  # ~10 ms of device clock ahead of a timed loop
# Published H100 SXM peaks: FP32 outside the tensor cores and HBM3
# bandwidth.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def cuda_ms(fn, iters):
    """Mean device time of fn over iters launches (CUDA events). The device
    first sleeps for SLEEP_CYCLES, so the host queues the launches before
    the start event and short kernels are not timed by their launch gaps."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
            if line.startswith("==") or "registers" in line or "spill" in line:
                print(f"phase 1 ptxas: {line.strip()}")
    from pbrs_tpu_torch.accel import bvh, native

    lo = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    t0 = time.time()
    tree = bvh.build_bvh(lo, lo + 0.1)
    print(f"phase 1 host BVH builder: {tree.builder} ({time.time() - t0:.2f} "
          f"s for 64 boxes, library "
          f"{os.path.relpath(native._SO, REPO) if tree.builder == 'native' else 'none'})")


def bound(bytes_moved, ops):
    """(bound ms, what binds): the larger of bytes over the card's memory
    rate and operations over its FP32 rate."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sweep_ops(counts):
    """Operations of one full sweep over a bank with these family counts."""
    return sum(c * o for c, o in zip(counts, SWEEP_OPS))


def k1(bank, counts, rays, any_hit=False):
    """K1 launched on a ray batch."""
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.geometry import ray as ray_mod

    return tk.trace_planes(bank, counts, ray_mod.to_planes(rays), any_hit)


def k1_reference(bank, counts, rays, chunk=1 << 16):
    """K1's plain version in chunks of rays, so that its [chunk, P]
    broadcast stays small at a 1007-row bank."""
    from pbrs_tpu_torch.accel import trace_kernel as tk

    n = rays.origin.shape[0]
    parts = [tk.trace_reference(bank, counts, ray_take(rays, slice(s, s + chunk)))
             for s in range(0, n, chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def k1_parity(bank, counts, rays, shadow=None):
    """K1 (closest hit on `rays`, any hit on `shadow`, by default the same
    rays) against its plain version: lanes whose id differs, whose t
    differs (rel > 1e-6) or whose occlusion differs; max |dt|; hits."""
    t_k, id_k = k1(bank, counts, rays)
    t_p, id_p = k1_reference(bank, counts, rays)
    same_id = id_k == id_p
    both = same_id & torch.isfinite(t_k) & torch.isfinite(t_p)
    rel = ((t_k - t_p).abs() / t_p.abs().clamp_min(1e-30))[both]
    err = float((t_k - t_p).abs()[both].max()) if bool(both.any()) else 0.0
    if shadow is None:
        shadow, occ_p = rays, torch.isfinite(t_p)
    else:
        occ_p = torch.isfinite(k1_reference(bank, counts, shadow)[0])
    occ_k = torch.isfinite(k1(bank, counts, shadow, any_hit=True)[0])
    bad = {"id": int((~same_id).sum()), "t": int((rel > 1e-6).sum()),
           "occlusion": int((occ_k != occ_p).sum())}
    return bad, err, int(torch.isfinite(t_p).sum())


def phase_trace(dev, rng):
    """K1 vs its plain version on 2^20 rays, closest hit and shadow rays."""
    from pbrs_tpu_torch.accel import trace_kernel as tk

    report = {"max_abs_err": 0.0}
    for label, scene in (("cornell", cornell(8)), ("random", random_scene(rng))):
        scene = scene.to(dev)
        bank, counts = tk.prim_scalars(scene.geom)
        rays = random_rays(rng, N_RAYS, dev)
        t_max = torch.from_numpy(
            rng.uniform(0.0, 900.0, N_RAYS).astype(np.float32)).to(dev)
        bad, err, hits = k1_parity(bank, counts, rays,
                                   rays.replace(t_max=t_max))
        report["max_abs_err"] = max(report["max_abs_err"], err)
        print(f"phase 2 K1 {label}: {N_RAYS} rays, {hits} hits; id differs "
              f"{bad['id']}, t differs (rel>1e-6) {bad['t']}, occlusion "
              f"differs {bad['occlusion']}; max |dt| {err:.3g}")
        if (bad["id"] > 1e-4 * N_RAYS or bad["t"]
                or bad["occlusion"] > 1e-4 * N_RAYS):
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{label}")
        if label == "cornell":
            report["ms"] = cuda_ms(lambda: k1(bank, counts, rays), 20)
            report["plain_ms"] = cuda_ms(
                lambda: tk.trace_reference(bank, counts, rays), 3)
            # Every closest-hit ray sweeps the whole bank; 7 floats in, t
            # and id out per ray, the bank read once.
            report["bound_ms"], report["bound_by"] = bound(
                N_RAYS * (7 * 4 + 8) + bank.numel() * 4,
                N_RAYS * sweep_ops(counts))
    print(f"phase 2 K1 time at {N_RAYS} rays (Cornell): kernel "
          f"{report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms, bound "
          f"{report['bound_ms']:.4f} ms ({report['bound_by']})")
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


def bounce_parity(dev, scene, label, report):
    """K2 vs its plain version on identical planes at bounces 0 and 5 (the
    planes after five plain bounces). Returns the bounce-0 inputs."""
    from pbrs_tpu_torch.accel import fused_kernel as fk
    from pbrs_tpu_torch.core import sampler as smp
    from pbrs_tpu_torch.integrators import wavefront

    scene = scene.to(dev)
    tab = fk.FusedTables.from_scene(scene)
    sampler = smp.PCGSampler(0)
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
                  rr_active=b > 3)
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
        print(f"phase 3 K2 {label} bounce {b}: {n} lanes, {live} alive; "
              f"outside atol {ATOL} rtol {RTOL}: {lane_bad}; alive differs "
              f"{alive_bad}; not bit-equal {exact_bad}; max |d| {err:.3g}; "
              f"rays kernel {int(cnt_k)} plain {int(cnt_p)}")
        if (lane_bad > 1e-3 * n or alive_bad > 1e-3 * n
                or int(cnt_k) != int(cnt_p)):
            raise AssertionError(f"K2 disagrees with its plain version on "
                                 f"{label} at bounce {b}")
    return inputs[0]


def phase_bounce(dev):
    """K2 vs its plain version: Cornell at 1024^2 (the main path's shape)
    and the sphere/sky scene at 256^2 with both sky kinds."""
    from pbrs_tpu_torch.accel import fused_kernel as fk

    report = {"max_abs_err": 0.0}
    tab, fin, alive, pix, samp, kw = bounce_parity(dev, cornell(SIZE),
                                                   "cornell", report)
    for env in ("gradient", "const"):
        bounce_parity(dev, sky_scene(256, env), f"spheres+{env} sky", report)
    cnt = torch.zeros(1, dtype=torch.int64, device=dev)
    report["ms"] = cuda_ms(
        lambda: fk.bounce(tab, fin, alive, pix, samp, cnt, **kw), 20)
    report["plain_ms"] = cuda_ms(
        lambda: fk.bounce_reference(tab, fin, alive, pix, samp, **kw), 3)
    n = fin.shape[1]
    # 9 floats + 3 ints in, 12 floats + 1 int out per lane, tables once;
    # operations: the closest-hit sweep of every live lane (shadow sweeps
    # and shading not counted, so this bound is a floor).
    report["bound_ms"], report["bound_by"] = bound(
        n * (9 * 4 + 3 * 4 + 12 * 4 + 4)
        + 4 * (tab.bank.numel() + tab.mats.numel() + tab.lights.numel()),
        int((alive > 0).sum()) * sweep_ops(tab.counts))
    print(f"phase 3 K2 time at {n} lanes (Cornell bounce 0): "
          f"kernel {report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms, "
          f"bound {report['bound_ms']:.4f} ms ({report['bound_by']})")
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


def run_main_path(scene, route, pix, depth=DEPTH, reps=REPS):
    """bench.py's timing loop: 1 warm-up sample, then reps x SAMPLES."""
    from pbrs_tpu_torch import render
    from pbrs_tpu_torch.core import sampler as smp

    name, step = render.make_integrator(scene, smp.PCGSampler(0), depth, MSAA,
                                        route)
    for s in range(WARMUP):
        step(pix, s)
    torch.cuda.synchronize()
    rates, walls, checksum = [], [], 0.0
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
    med = sorted(rates)[reps // 2]
    return name, med, sorted(walls)[reps // 2], checksum


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
    for route, (name, mrays, wall, checksum) in results.items():
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


def k3_inputs(dev, scene, bounce):
    """The K3 tables and the bounce-`bounce` input planes of a scene, reached
    through the plain version from sample 0's camera rays."""
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl
    from pbrs_tpu_torch.core import sampler as smp
    from pbrs_tpu_torch.integrators import wavefront

    scene = scene.to(dev)
    if not fsl.scene_supports_single_lobe(scene):
        raise AssertionError("a K3 test scene is not single-lobe eligible")
    tab = fsl.SingleLobeTables.from_scene(scene)
    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    samp = torch.zeros(n, dtype=torch.int32, device=dev)
    rays = wavefront.camera_rays(scene, smp.PCGSampler(0), pix, 0, MSAA)
    fin = torch.cat([rays.origin.T, rays.dir.T,
                     torch.ones(3, n, device=dev)]).contiguous()
    alive = torch.ones(n, dtype=torch.int32, device=dev)
    spec = torch.zeros(n, dtype=torch.int32, device=dev)
    for b in range(bounce + 1):
        kw = dict(seed=0, bounce=b, bounce_is_first=b == 0, rr_active=b > 3)
        if b == bounce:
            return tab, (fin, alive, spec, pix, samp), kw
        fout, alive, spec, _ = fsl.bounce2_reference(tab, fin, alive, spec,
                                                     pix, samp, **kw)
        fin = fout[3:].contiguous()


def k3_parity(dev, label, scene, bounce, report):
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl

    tab, lanes, kw = k3_inputs(dev, scene, bounce)
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
    print(f"phase 7 K3 {label} bounce {bounce}: {n} lanes, "
          f"{int((alive_in > 0).sum())} alive; outside atol {K3_ATOL} rtol "
          f"{K3_RTOL}: {lane_bad}; alive/spec differ {alive_bad}; not "
          f"bit-equal {exact_bad}; max |d| {err:.3g}; rays kernel "
          f"{int(cnt_k)} plain {int(cnt_p)}")
    if lane_bad or alive_bad or int(cnt_k) != int(cnt_p):
        raise AssertionError(f"K3 disagrees with its plain version on "
                             f"{label} at bounce {bounce}")
    return tab, lanes, kw


def phase_single_lobe(dev):
    """K3 vs its plain version: plates at 1024^2 (the main path's shape) at
    bounces 0 and 2, then six scenes at 256^2 that take K3's other
    branches; K3's and the plain version's device time at plates bounce
    0."""
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl

    report = {"max_abs_err": 0.0}
    plates = preset_at("plates", SIZE)
    tab, lanes, kw = k3_parity(dev, "plates", plates, 0, report)
    k3_parity(dev, "plates", plates, 2, report)
    for label, scene in (("zoo", zoo_scene(256)),
                         ("plastic/uber", plastic_scene(256)),
                         ("textured", textured_scene(256)),
                         ("shaped lights", shaped_lights_scene(256)),
                         ("env_mapped", preset_at("env_mapped", 256)),
                         ("mixed_spheres", preset_at("mixed_spheres", 256))):
        k3_parity(dev, label, scene, 0, report)
    cnt = torch.zeros(1, dtype=torch.int64, device=dev)
    report["ms"] = cuda_ms(lambda: fsl.bounce2(tab, *lanes, cnt, **kw), 20)
    report["plain_ms"] = cuda_ms(
        lambda: fsl.bounce2_reference(tab, *lanes, **kw), 3)
    n = lanes[0].shape[1]
    # 9 floats + 4 ints in, 12 floats + 2 ints out per lane, tables once;
    # operations: the closest-hit sweep of every live lane (shadow sweeps
    # and shading not counted, so this bound is a floor).
    tables = sum(t.numel() for t in (tab.bank, tab.mats, tab.texs,
                                     tab.lights, tab.delta, tab.env))
    report["bound_ms"], report["bound_by"] = bound(
        n * (9 * 4 + 4 * 4 + 12 * 4 + 2 * 4) + 4 * tables,
        int((lanes[1] > 0).sum()) * sweep_ops(tab.counts))
    print(f"phase 7 K3 time at {n} lanes (plates bounce 0): kernel "
          f"{report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms, bound "
          f"{report['bound_ms']:.4f} ms ({report['bound_by']})")
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
    for route, (name, mrays, wall, checksum) in results.items():
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


def main_path_launches(dev, scene, depth):
    """Every K1 and K5 launch of sample 0 of a scene's main path (route
    auto, at full width), kept with its inputs: {"k1": [(bank, counts,
    planes, any_hit)], "k5": [(family tracer, planes, any_hit)]}."""
    from pbrs_tpu_torch import render
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.accel import treelet as tl
    from pbrs_tpu_torch.core import sampler as smp

    seen = {"k1": [], "k5": []}
    launch_k1, launch_k5 = tk.trace_planes, tl.trace_planes

    def record_k1(bank, counts, planes, any_hit=False):
        seen["k1"].append((bank, counts, planes, any_hit))
        return launch_k1(bank, counts, planes, any_hit)

    def record_k5(fam, planes, any_hit=False):
        seen["k5"].append((fam, planes, any_hit))
        return launch_k5(fam, planes, any_hit)

    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    _, step = render.make_integrator(scene, smp.PCGSampler(0), depth, MSAA,
                                     "auto")
    tk.trace_planes, tl.trace_planes = record_k1, record_k5
    try:
        step(pix, 0)
        torch.cuda.synchronize()
    finally:
        tk.trace_planes, tl.trace_planes = launch_k1, launch_k5
    return seen


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


def bvh_compare(fam, rays):
    """K5 (closest and any hit) against its plain version on one ray set:
    counts of lanes whose t is not bit-equal, whose id or hit mask differs,
    or whose any-hit mask differs from the closest hit's; max |dt|; hits;
    the plain version's device ms."""
    from pbrs_tpu_torch.accel import treelet as tl

    t_k, id_k = fam.trace(rays)
    t_a, _ = fam.trace(rays, any_hit=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t_p, id_p = tl.trace_reference(fam, rays)
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


def bvh_launch_bound(fam, planes, any_hit, rng):
    """(bound ms, what binds, node tests, primitive tests) of one K5 launch:
    28 B in and 8 B out a lane and the tables once, against the node and
    primitive tests that the host walk of BVH_COUNT_SAMPLE of its lanes
    needs, scaled to all of them."""
    from pbrs_tpu_torch.accel import treelet as tl

    n = planes.shape[1]
    idx = torch.from_numpy(rng.choice(n, min(n, BVH_COUNT_SAMPLE),
                                      replace=False)).to(planes.device)
    _, _, nodes, prims = tl.traverse_reference(
        fam, planes_rays(planes[:, idx]), any_hit=any_hit)
    scale = n / idx.numel()
    tables = 4 * (fam.nodes.numel() + fam.fields.numel()
                  + fam.slot_gid.numel())
    ms, by = bound(n * (7 * 4 + 8) + tables,
                   scale * (nodes * NODE_OPS + prims * PRIM_OPS[fam.kind]))
    return ms, by, scale * nodes, scale * prims


def phase_bvh(dev, rng, k1_report):
    """K5 vs its plain version on the card: random rays against the
    mesh_ball(levels=5) triangles, everything's quads, 2048 random spheres
    and 2048 random disks, then every K5 and K1 launch of one sample of
    each mesh scene's main path at full width, replayed against the plain
    versions. K5's device time, plain time and bound per launch over those
    launches; K5's time at 2^20 mesh_ball camera + bounce-1 lanes; K1's
    time per launch on everything's bank beside Cornell's."""
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
        bad, err, hits, _ = bvh_compare(fam, rays)
        report["max_abs_err"] = max(report["max_abs_err"], err)
        print(f"phase 10 K5 {label}, random rays: {BVH_SET} rays, {hits} "
              f"hits, {fam.n_prims} prims ({fam.n_nodes} nodes, depth "
              f"{fam.depth}, {fam.builder} builder); lanes differing: t "
              f"{bad['t']}, id {bad['id']}, hit mask {bad['hit']}, any-hit "
              f"mask {bad['any-hit']}; max |dt| {err:.3g}")
        if any(bad.values()):
            raise AssertionError(f"K5 disagrees with its plain version on "
                                 f"{label}")
    # Every K5 launch of the main paths' sample 0, at full width: parity,
    # device time (CUDA events over 5 replays), plain time and bound.
    per = {"ms": [], "plain_ms": [], "bound_ms": [], "bound_by": []}
    for name, seen in launches.items():
        fam = fams[name]
        bad = {"t": 0, "id": 0, "hit": 0, "any-hit": 0}
        rows = []
        for _, planes, any_hit in seen["k5"]:
            got, err, hits, plain_ms = bvh_compare(fam, planes_rays(planes))
            bad = {k: bad[k] + got[k] for k in bad}
            report["max_abs_err"] = max(report["max_abs_err"], err)
            ms = cuda_ms(lambda: tl.trace_planes(fam, planes, any_hit), 5)
            b_ms, b_by, nodes, prims = bvh_launch_bound(fam, planes, any_hit,
                                                        rng)
            n = planes.shape[1]
            rows.append((any_hit, int((planes[6] > 0).sum()), hits, ms,
                         plain_ms, b_ms, nodes / n, prims / n))
            for k, v in zip(("ms", "plain_ms", "bound_ms", "bound_by"),
                            (ms, plain_ms, b_ms, b_by)):
                per[k].append(v)
        n = seen["k5"][0][1].shape[1]
        print(f"phase 10 K5 {name} main path, sample 0: {len(rows)} launches "
              f"({sum(not r[0] for r in rows)} closest, "
              f"{sum(r[0] for r in rows)} any hit) of {n} lanes; lanes "
              f"differing: t {bad['t']}, id {bad['id']}, hit mask "
              f"{bad['hit']}, any-hit mask {bad['any-hit']}")
        for i, (any_hit, live, hits, ms, plain_ms, b_ms, nd, pr) in \
                enumerate(rows):
            print(f"phase 10 K5 {name} launch {i} "
                  f"{'any hit' if any_hit else 'closest'}: {live} live lanes, "
                  f"{hits} hits; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms; {nd:.2f} node and {pr:.2f} primitive "
                  f"tests a lane")
        print(f"phase 10 K5 {name} per sample: kernel "
              f"{sum(r[3] for r in rows):.4f} ms, plain "
              f"{sum(r[4] for r in rows):.4f} ms, bound "
              f"{sum(r[5] for r in rows):.4f} ms")
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
          f"{per['bound_by'].count(report['bound_by'])} of {k})")
    # K5 at 2^20 lanes: mesh_ball's camera and bounce-1 closest-hit lanes.
    fam = fams["mesh_ball"]
    closest = [planes for _, planes, a in launches["mesh_ball"]["k5"]
               if not a]
    both = torch.cat(closest[:2], dim=1)
    big = both[:, torch.arange(N_RAYS, device=dev) % both.shape[1]]
    big = big.contiguous()
    print(f"phase 10 K5 time at {N_RAYS} rays (mesh_ball camera + bounce-1 "
          f"closest hit): kernel "
          f"{cuda_ms(lambda: tl.trace_planes(fam, big), 20):.4f} ms")
    # K1 on every flat-bank launch of both main paths.
    for name, seen in launches.items():
        bad = {"id": 0, "t": 0, "occlusion": 0}
        bank, counts = seen["k1"][0][:2]
        for bank, counts, planes, _ in seen["k1"]:
            got, err, _ = k1_parity(bank, counts, planes_rays(planes))
            bad = {k: bad[k] + got[k] for k in bad}
            k1_report["max_abs_err"] = max(k1_report["max_abs_err"], err)
        print(f"phase 10 K1 {name} main path, sample 0: {len(seen['k1'])} "
              f"launches on a {bank.shape[0]}-row bank (counts {counts}), "
              f"closest and any hit each; lanes differing: id {bad['id']}, "
              f"t (rel>1e-6) {bad['t']}, occlusion {bad['occlusion']}")
        if any(bad.values()):
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{name}'s main path")
    ev = launches["everything"]["k1"]
    cb_bank, cb_counts = tk.prim_scalars(cornell(8).to(dev).geom)
    k1_ev = sum(cuda_ms(lambda: tk.trace_planes(b, c, p, a), 5)
                for b, c, p, a in ev)
    k1_cb = sum(cuda_ms(lambda: tk.trace_planes(cb_bank, cb_counts, p, a), 5)
                for _, _, p, a in ev)
    print(f"phase 10 K1 time per launch over everything's sample 0 ("
          f"{len(ev)} launches of {ev[0][2].shape[1]} lanes): everything's "
          f"bank ({ev[0][0].shape[0]} rows) {k1_ev / len(ev):.4f} ms, "
          f"Cornell's bank ({sum(cb_counts)} rows) {k1_cb / len(ev):.4f} ms")
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
    """The slice's main paths: mesh_ball(levels=5) 800x600, depth 6, and
    everything 800x800, depth 5, msaa 2, PCG seed 0, through the auto and
    general routes. On these scenes both routes are the same path (the
    general path with K1 and K5), so their checksums must be equal: a
    repeatability check, not an independent one (phase 10 holds every
    kernel launch of this path against its plain version). The plain route
    is left out: its sweep broadcasts [N, P] at P = 16384."""
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.accel import treelet as tl

    tk.LAUNCHES = 0
    tl.LAUNCHES = 0
    for name, depth in (("mesh_ball", MESH_DEPTH), ("everything", EVERY_DEPTH)):
        scene = mesh_scene(name).to(dev)
        w, h = scene.camera.width, scene.camera.height
        pix = torch.arange(w * h, dtype=torch.int32, device=dev)
        results = {}
        k1, k5 = tk.LAUNCHES, tl.LAUNCHES
        for route in ("auto", "general"):
            results[route] = run_main_path(scene, route, pix, depth)
        for route, (got, mrays, wall, checksum) in results.items():
            print(f"phase 12 main path {route} -> {got}: {name} {w}x{h} depth "
                  f"{depth} msaa {MSAA}: median {mrays:.3f} Mrays/s, "
                  f"{wall * 1e3:.2f} ms/sample, checksum {checksum:.6e} "
                  f"[{smi}]")
        print(f"phase 12 launches on {name}: K1 trace_flat "
              f"{tk.LAUNCHES - k1}, K5 trace_bvh {tl.LAUNCHES - k5}")
        if [r[0] for r in results.values()] != ["general", "general"]:
            raise AssertionError(f"{name} did not take the general path")
        if tl.LAUNCHES == k5:
            raise AssertionError(f"{name}: K5 never launched")
        sums = [r[3] for r in results.values()]
        if max(sums) - min(sums) > GOLDEN_REL_TOL * abs(sums[0]):
            raise AssertionError(f"{name}: two runs of the general path "
                                 f"disagree on the checksum: {sums}")
    return {"trace_bvh": tl.LAUNCHES}


def kernel_entry(name, source, replaces, launches, report):
    return {"name": name, "route": "cuda",
            "source": f"pbrs_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": report["max_abs_err"],
            "ms": report["ms"], "plain_ms": report["plain_ms"],
            "bound_ms": report["bound_ms"], "bound_by": report["bound_by"],
            # No single PyTorch call computes any of these kernels (nor a
            # BVH closest hit).
            "library_ms": None}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    name, smi = phase_device()
    phase_build()
    k1 = phase_trace(dev, rng)
    k2 = phase_bounce(dev)
    phase_golden(dev)
    launches = phase_main(dev, smi)
    phase_cli()
    k3 = phase_single_lobe(dev)
    phase_single_lobe_golden(dev)
    k3_launches = phase_plates_main(dev, smi)
    k5 = phase_bvh(dev, rng, k1)
    phase_bvh_golden(dev)
    k5_launches = phase_mesh_main(dev, smi)
    kernels = [
        kernel_entry("trace_flat", "trace_flat.cu",
                     "pbrs_tpu/accel/trace_pallas.py:127",
                     launches["trace_flat"], k1),
        kernel_entry("fused_bounce", "fused_bounce.cu",
                     "pbrs_tpu/accel/fused_kernel.py:329",
                     launches["fused_bounce"], k2),
        kernel_entry("fused_single_lobe", "fused_single_lobe.cu",
                     "pbrs_tpu/accel/fused_single_lobe.py:506",
                     k3_launches["fused_single_lobe"], k3),
        kernel_entry("trace_bvh", "trace_bvh.cu",
                     "pbrs_tpu/accel/treelet.py:310 and :479",
                     k5_launches["trace_bvh"], k5),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
