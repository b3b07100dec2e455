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
cornell_direct_256_16spp) and both visualizers. Every phase prints one
line or more; a failing phase raises, so the script exits non-zero.
There is no CPU path: without a CUDA device the script fails. The line
before the last is {"kernels": [...]}, one entry per kernel with its
launches on its main path, error against its plain version, device time,
plain time and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import io
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
K4_ATOL, K4_RTOL = 3e-5, 2e-4  # tests/test_fused_wave.py:84-100
# Wave vs general on lanes that reach a Perlin-marble surface (phase 17):
# at most this share of them outside atol K4_ATOL, rtol MARBLE_RTOL. On
# everything at full width 472 of 40479 (1.17%) are outside (NVIDIA H100,
# sample 0; PERF.md section 6): the limit leaves less than 2x room.
MARBLE_RTOL, MARBLE_SHARE = 1e-2, 0.02
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
            if (line.startswith("==") or "registers" in line or "spill" in line
                    or "Compiling entry function" in line):
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


def sampler_of(rng):
    """Seed 0 of the sampler kind `rng` ("pcg", "sobol", "threefry")."""
    from pbrs_tpu_torch import render

    return render.SAMPLERS[rng](0)


def variant(kernel, rng="pcg", folded=False):
    """A kernel's label in the phase lines: K2, K2-Sobol, K4-folded, ..."""
    return kernel + ("-Sobol" if rng == "sobol" else "") + (
        "-folded" if folded else "")


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
    and the sphere/sky scene at 256^2 with both sky kinds, drawing `rng`.
    A Sobol' run also times K2's PCG twin on the same planes."""
    from pbrs_tpu_torch.accel import fused_kernel as fk

    report = {"max_abs_err": 0.0, "phase": phase}
    tab, fin, alive, pix, samp, kw = bounce_parity(dev, cornell(SIZE),
                                                   "cornell", report, rng)
    for env in ("gradient", "const"):
        bounce_parity(dev, sky_scene(256, env), f"spheres+{env} sky", report,
                      rng)
    cnt = torch.zeros(1, dtype=torch.int64, device=dev)
    report["ms"] = cuda_ms(
        lambda: fk.bounce(tab, fin, alive, pix, samp, cnt, **kw), 20)
    if rng != "pcg":
        report["twin_ms"] = cuda_ms(lambda: fk.bounce(
            tab, fin, alive, pix, samp, cnt, **{**kw, "rng": "pcg"}), 20)
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
    twin = (f", PCG twin on the same planes {report['twin_ms']:.4f} ms"
            if "twin_ms" in report else "")
    print(f"phase {phase} {variant('K2', rng)} time at {n} lanes (Cornell "
          f"bounce 0): kernel {report['ms']:.4f} ms, plain "
          f"{report['plain_ms']:.4f} ms, bound {report['bound_ms']:.4f} ms "
          f"({report['bound_by']}){twin}")
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
    # The interior through the CLI's --pbrt_file, on route auto (K4).
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "interior.png")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = cli.main(["--pbrt_file", os.path.join(
                REPO, "scenes", "interior", "interior.pbrt"), "--resolution",
                "480x270", "--msaa", "1", "--depth", "5", "--output", out])
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
    bounces 0 and 2, then six scenes at 256^2 that take K3's other
    branches, drawing `rng`; K3's and the plain version's device time at
    plates bounce 0 (and, for Sobol', the PCG twin's on the same
    planes)."""
    from pbrs_tpu_torch.accel import fused_single_lobe as fsl

    report = {"max_abs_err": 0.0, "phase": phase}
    plates = preset_at("plates", SIZE)
    tab, lanes, kw = k3_parity(dev, "plates", plates, 0, report, rng)
    k3_parity(dev, "plates", plates, 2, report, rng)
    for label, scene in (("zoo", zoo_scene(256)),
                         ("plastic/uber", plastic_scene(256)),
                         ("textured", textured_scene(256)),
                         ("shaped lights", shaped_lights_scene(256)),
                         ("env_mapped", preset_at("env_mapped", 256)),
                         ("mixed_spheres", preset_at("mixed_spheres", 256))):
        k3_parity(dev, label, scene, 0, report, rng)
    cnt = torch.zeros(1, dtype=torch.int64, device=dev)
    report["ms"] = cuda_ms(lambda: fsl.bounce2(tab, *lanes, cnt, **kw), 20)
    if rng != "pcg":
        report["twin_ms"] = cuda_ms(lambda: fsl.bounce2(
            tab, *lanes, cnt, **{**kw, "rng": "pcg"}), 20)
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
    twin = (f", PCG twin on the same planes {report['twin_ms']:.4f} ms"
            if "twin_ms" in report else "")
    print(f"phase {phase} {variant('K3', rng)} time at {n} lanes (plates "
          f"bounce 0): kernel {report['ms']:.4f} ms, plain "
          f"{report['plain_ms']:.4f} ms, bound {report['bound_ms']:.4f} ms "
          f"({report['bound_by']}){twin}")
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


def main_path_launches(dev, scene, depth, rng="pcg", nee_mode="twoarm"):
    """Every K1, K4 and K5 launch of sample 0 of a scene's main path (route
    auto, at full width, sampler `rng`, NEE `nee_mode`), kept with its
    inputs: {"k1": [(bank, counts, planes, any_hit)], "k5": [(family
    tracer, planes, any_hit)], "k4": [(tables, fin, iin, keywords)]}."""
    from pbrs_tpu_torch import render
    from pbrs_tpu_torch.accel import fused_wave as fw
    from pbrs_tpu_torch.accel import trace_kernel as tk
    from pbrs_tpu_torch.accel import treelet as tl

    seen = {"k1": [], "k5": [], "k4": []}
    launch_k1, launch_k5, launch_k4 = (tk.trace_planes, tl.trace_planes,
                                       fw.shade)

    def record_k1(bank, counts, planes, any_hit=False):
        seen["k1"].append((bank, counts, planes, any_hit))
        return launch_k1(bank, counts, planes, any_hit)

    def record_k5(fam, planes, any_hit=False):
        seen["k5"].append((fam, planes, any_hit))
        return launch_k5(fam, planes, any_hit)

    def record_k4(tab, fin, iin, count, **kw):
        seen["k4"].append((tab, fin, iin, kw))
        return launch_k4(tab, fin, iin, count, **kw)

    n = scene.camera.width * scene.camera.height
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    _, step = render.make_integrator(scene, sampler_of(rng), depth, MSAA,
                                     "auto", nee_mode=nee_mode)
    tk.trace_planes, tl.trace_planes, fw.shade = (record_k1, record_k5,
                                                   record_k4)
    try:
        step(pix, 0)
        torch.cuda.synchronize()
    finally:
        tk.trace_planes, tl.trace_planes, fw.shade = (launch_k1, launch_k5,
                                                      launch_k4)
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


def replay_k1(label, launches, k1_report):
    """Every K1 launch of a main-path sample (bank, counts, planes, any
    hit) replayed against the plain version, closest and any hit each."""
    bad = {"id": 0, "t": 0, "occlusion": 0}
    for bank, counts, planes, _ in launches:
        got, err, _ = k1_parity(bank, counts, planes_rays(planes))
        bad = {k: bad[k] + got[k] for k in bad}
        k1_report["max_abs_err"] = max(k1_report["max_abs_err"], err)
    bank, counts = launches[0][:2]
    print(f"{label} main path, sample 0: {len(launches)} launches of "
          f"{sorted({p.shape[1] for _, _, p, _ in launches})} lanes on a "
          f"{bank.shape[0]}-row bank (counts {counts}), closest and any hit "
          f"each; lanes differing: id {bad['id']}, t (rel>1e-6) {bad['t']}, "
          f"occlusion {bad['occlusion']}")
    if any(bad.values()):
        raise AssertionError(f"K1 disagrees with its plain version: {label}")


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
        replay_k1(f"phase 10 K1 {name}", seen["k1"], k1_report)
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
    return {"trace_bvh": tl.LAUNCHES}


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


def phase_wave(dev, seen, rng="pcg", nee_mode="twoarm", phase=13):
    """K4 against its plain version on every K4 launch of sample 0 of the
    interior main path (1024^2, depth 5) and of the wave zoo at 256^2,
    drawing `rng` with `nee_mode` NEE; K4's device time per launch (CUDA
    events, the device put to sleep first), its plain version's, and the
    bound, over the interior launches (and, for a Sobol' or folded
    variant, the PCG two-arm twin's time on the same planes)."""
    from pbrs_tpu_torch.accel import fused_wave as fw

    folded = nee_mode == "folded"
    name = variant("K4", rng, folded)
    report = {"max_abs_err": 0.0}
    zoo = wave_zoo_scene(256).to(dev)
    if not fw.scene_supports_wave(zoo):
        raise AssertionError("the wave zoo is not wave-eligible")
    launches = {"interior": seen["k4"],
                "zoo": main_path_launches(dev, zoo, 5, rng, nee_mode)["k4"]}
    for label, rows in launches.items():
        if not rows:
            raise AssertionError(f"{label}: no K4 launch on its main path")
        for i, (tab, fin, iin, kw) in enumerate(rows):
            if (kw.get("rng", "pcg"), kw.get("folded", False)) != (rng,
                                                                   folded):
                raise AssertionError(f"{label}: a K4 launch of another "
                                     f"variant: {kw}")
            got = k4_compare(tab, fin, iin, kw)
            report["max_abs_err"] = max(report["max_abs_err"], got["err"])
            print(f"phase {phase} {name} {label} launch {i} (bounce "
                  f"{kw['bounce']}, "
                  f"{tab.n_slots} slots): {got['lanes']} lanes, {got['live']} "
                  f"alive; outside atol {K4_ATOL} rtol {K4_RTOL}: "
                  f"{got['outside']}; not bit-equal {got['not_bit_equal']}; "
                  f"alive/spec differ {got['alive']}; max |d| "
                  f"{got['err']:.3g}; shadow rays kernel {got['rays_k']} "
                  f"plain {got['rays_p']}")
            if (got["outside"] or got["not_bit_equal"] or got["alive"]
                    or got["rays_k"] != got["rays_p"]):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on {label} launch {i}")
    per = {"ms": [], "plain_ms": [], "bound_ms": [], "bound_by": [],
           "twin_ms": []}
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
        print(f"phase {phase} {name} time, interior launch {i}: {n} lanes, "
              f"{int((iin[2] > 0).sum())} alive; kernel {ms:.4f} ms"
              f"{twin_said}, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}: {moved / 1e6:.1f} MB, {ops / n:.0f} plain-version "
              f"float ops a lane)")
        for key, v in zip(("ms", "plain_ms", "bound_ms", "bound_by",
                           "twin_ms"), (ms, plain_ms, b_ms, b_by, twin_ms)):
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
    return report


def phase_interior_traces(seen, k1_report, k5_report):
    """Every K1 and K5 launch of sample 0 of the interior main path (the
    sample whose K4 launches phase 13 replays) against the plain versions:
    K1 on the flat bank, K5 on the triangle family, closest hit and the
    concatenated shadow batches, with K5's device time a launch."""
    from pbrs_tpu_torch.accel import treelet as tl

    if not seen["k1"] or not seen["k5"]:
        raise AssertionError("the interior main path launched no K1 or K5")
    replay_k1("phase 13 K1 interior", seen["k1"], k1_report)
    bad = {"t": 0, "id": 0, "hit": 0, "any-hit": 0}
    ms_all, plain_all = 0.0, 0.0
    for i, (fam, planes, any_hit) in enumerate(seen["k5"]):
        got, err, hits, plain_ms = bvh_compare(fam, planes_rays(planes))
        bad = {k: bad[k] + got[k] for k in bad}
        k5_report["max_abs_err"] = max(k5_report["max_abs_err"], err)
        ms = cuda_ms(lambda: tl.trace_planes(fam, planes, any_hit), 5)
        ms_all, plain_all = ms_all + ms, plain_all + plain_ms
        print(f"phase 13 K5 interior launch {i} "
              f"{'any hit' if any_hit else 'closest'}: {planes.shape[1]} "
              f"lanes, {int((planes[6] > 0).sum())} live, {hits} hits, "
              f"{fam.n_prims} prims; lanes differing: t {got['t']}, id "
              f"{got['id']}, hit mask {got['hit']}, any-hit mask "
              f"{got['any-hit']}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    print(f"phase 13 K5 interior main path, sample 0: {len(seen['k5'])} "
          f"launches; lanes differing: t {bad['t']}, id {bad['id']}, hit "
          f"mask {bad['hit']}, any-hit mask {bad['any-hit']}; per sample: "
          f"kernel {ms_all:.4f} ms, plain {plain_all:.4f} ms")
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
                                     route=route, sampler_kind=sampler, **kw)
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
    0.01% outside atol / rtol 1e-2, checksums within GOLDEN_REL_TOL."""
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
    run(phase_interior_traces, seen, k1, k5)
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
    k2_src = "pbrs_tpu/accel/fused_kernel.py:329"
    k3_src = "pbrs_tpu/accel/fused_single_lobe.py:506"
    k4_src = "pbrs_tpu/accel/fused_wave.py:158"
    kernels = [
        kernel_entry("trace_flat", "trace_flat.cu",
                     "pbrs_tpu/accel/trace_pallas.py:127",
                     launches["trace_flat"], k1),
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
