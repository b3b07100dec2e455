#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from pbrs_tpu_torch/csrc/, checks each
against its plain PyTorch version on the card, renders the golden Cornell
checksum through both kernels, drives the main path (Cornell 1024^2,
depth 8, msaa 2, PCG seed 0) through the port's fused, general and plain
routes, and runs the CLI. Every phase prints one line; a failing phase
raises, so the script exits non-zero. There is no CPU path: without a CUDA
device the script fails. The last line is
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
N_RAYS = 1 << 20
SIZE, DEPTH, MSAA = 1024, 8, 2  # bench.py workload
WARMUP, REPS, SAMPLES = 1, 3, 4


def cuda_ms(fn, iters):
    """Mean device time of fn over iters launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
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
          f"({'cached' if cached else 'nvcc'}) -> "
          f"{os.path.relpath(kernels.library_path(), REPO)}")


def phase_trace(dev, rng):
    """K1 vs its plain version on 2^20 rays, closest hit and shadow rays."""
    from pbrs_tpu_torch.accel import trace_kernel as tk

    report = {"max_abs_err": 0.0}
    for label, scene in (("cornell", cornell(8)), ("random", random_scene(rng))):
        scene = scene.to(dev)
        bank, counts = tk.prim_scalars(scene.geom)
        rays = random_rays(rng, N_RAYS, dev)
        t_k, id_k = tk.trace(bank, counts, rays)
        t_p, id_p = tk.trace_reference(bank, counts, rays)
        same_id = id_k == id_p
        both = same_id & torch.isfinite(t_k) & torch.isfinite(t_p)
        rel = ((t_k - t_p).abs() / t_p.abs().clamp_min(1e-30))[both]
        t_bad = int((rel > 1e-6).sum())
        id_bad = int((~same_id).sum())
        err = float((t_k - t_p).abs()[both].max()) if bool(both.any()) else 0.0
        report["max_abs_err"] = max(report["max_abs_err"], err)
        t_max = torch.from_numpy(
            rng.uniform(0.0, 900.0, N_RAYS).astype(np.float32)).to(dev)
        shadow = rays.replace(t_max=t_max)
        occ_k = tk.occluded(bank, counts, shadow)
        occ_p = torch.isfinite(tk.trace_reference(bank, counts, shadow)[0])
        occ_bad = int((occ_k != occ_p).sum())
        hits = int(torch.isfinite(t_p).sum())
        print(f"phase 2 K1 {label}: {N_RAYS} rays, {hits} hits; id differs "
              f"{id_bad}, t differs (rel>1e-6) {t_bad}, occlusion differs "
              f"{occ_bad}; max |dt| {err:.3g}")
        if id_bad > 1e-4 * N_RAYS or t_bad or occ_bad > 1e-4 * N_RAYS:
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{label}")
        if label == "cornell":
            report["ms"] = cuda_ms(lambda: tk.trace(bank, counts, rays), 20)
            report["plain_ms"] = cuda_ms(
                lambda: tk.trace_reference(bank, counts, rays), 3)
    print(f"phase 2 K1 time at {N_RAYS} rays (Cornell): kernel "
          f"{report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms")
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
    print(f"phase 3 K2 time at {fin.shape[1]} lanes (Cornell bounce 0): "
          f"kernel {report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms")
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


def run_main_path(scene, route, pix):
    """bench.py's timing loop: 1 warm-up sample, then REPS x SAMPLES."""
    from pbrs_tpu_torch import render
    from pbrs_tpu_torch.core import sampler as smp

    name, step = render.make_integrator(scene, smp.PCGSampler(0), DEPTH, MSAA,
                                        route)
    for s in range(WARMUP):
        step(pix, s)
    torch.cuda.synchronize()
    rates, walls, checksum = [], [], 0.0
    for rep in range(REPS):
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
    med = sorted(rates)[REPS // 2]
    return name, med, sorted(walls)[REPS // 2], checksum


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
    kernels = [
        {"name": "trace_flat", "route": "cuda",
         "source": "pbrs_tpu_torch/csrc/trace_flat.cu",
         "replaces": "pbrs_tpu/accel/trace_pallas.py:127",
         "launches": launches["trace_flat"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "fused_bounce", "route": "cuda",
         "source": "pbrs_tpu_torch/csrc/fused_bounce.cu",
         "replaces": "pbrs_tpu/accel/fused_kernel.py:329",
         "launches": launches["fused_bounce"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
