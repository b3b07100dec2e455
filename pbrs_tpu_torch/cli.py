"""Command-line entry point. Mirrors pbrs_tpu/cli.py: every flag of it
parses; a preset not ported exits with "not yet ported".

    python -m pbrs_tpu_torch.cli --scene_name cornell_box --msaa 2 \\
        --depth 5 --resolution 256x256 --output cornell.exr
    python -m pbrs_tpu_torch.cli --pbrt_file scenes/interior/interior.pbrt
    python -m pbrs_tpu_torch.cli --sampler sobol --integrator direct
    python -m pbrs_tpu_torch.cli --filter gaussian:1.5 \
        --checkpoint film.npz --checkpoint_every 4
    python -m pbrs_tpu_torch.cli --scene_name fourier_plastic --compact on
    python -m pbrs_tpu_torch.cli --pbrt_file scenes/interior/interior.pbrt \
        --compact off --nee_mode twoarm
    python -m pbrs_tpu_torch.cli --phase_timings --profile_dir prof/

Route auto tunes on the card (tuner.py): with --compact or --nee_mode left
at auto the render times each candidate path once and keeps the fastest;
with both given it takes the first eligible fused path. --trace_mode takes
auto or onehot, which both name the port's one tracer pair (K1 + K5); the
JAX package's TPU fetch variants (rowdense, rowdyn, rowdynh) are refused.

--use_single_thread / --use_multi_thread are accepted and ignored, as the
reference does (determinism comes from the counter-based sampler, not the
thread count).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

# The JAX package's treelet fetch variants: TPU workarounds (row-shared
# visits, scalar-indexed or HBM DMA treelet fetch) whose contract the BVH
# kernel K5 carries.
TPU_TRACE_MODES = ("rowdense", "rowdyn", "rowdynh")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pbrs_tpu_torch",
        description="wavefront path tracer on PyTorch + CUDA")
    p.add_argument("--scene_name", default="cornell_box",
                   help="preset scene name")
    p.add_argument("--pbrt_file", default=None,
                   help="render a PBRT scene file instead of a preset")
    p.add_argument("--integrator", default="path", choices=["direct", "path"],
                   help="path tracing, or direct lighting with a "
                        "perfect-specular chain")
    p.add_argument("--msaa", type=int, default=2,
                   help="sqrt of samples-per-pixel")
    p.add_argument("--depth", type=int, default=5, help="max path depth")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampler", default="pcg",
                   choices=["pcg", "sobol", "threefry"],
                   help="random sampler: the pcg hash (default) or "
                        "Owen-scrambled Sobol' (lower variance at equal spp) "
                        "run the fused kernels; threefry takes the general "
                        "wavefront")
    p.add_argument("--resolution", default=None, metavar="WxH",
                   help="override the scene camera resolution")
    p.add_argument("--filter", default=None, metavar="KIND:RADIUS",
                   help="pixel reconstruction filter, e.g. gaussian:1.5 "
                        "(applied by filter importance sampling)")
    p.add_argument("--output", default=None, help="output EXR/PNG path")
    p.add_argument("--checkpoint", default=None,
                   help="film checkpoint path (.npz); resumes if it exists")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="save the film every N samples")
    p.add_argument("--visualize_normals", action="store_true",
                   help="also write <scene>-normals.png (1 spp)")
    p.add_argument("--visualize_materials", action="store_true",
                   help="also write <scene>-mtl.png (1 spp)")
    p.add_argument("--use_single_thread", action="store_true")
    p.add_argument("--use_multi_thread", action="store_true")
    p.add_argument("--trace_mode", default="auto",
                   choices=["auto", "onehot"] + list(TPU_TRACE_MODES),
                   help="tracer: auto and onehot both take the port's one "
                        "tracer pair, the flat-bank kernel and the BVH "
                        "kernel; rowdense, rowdyn and rowdynh (the JAX "
                        "package's TPU treelet fetch variants) are refused")
    p.add_argument("--compact", default="auto",
                   choices=["auto", "on", "off"],
                   help="shrink the bounce wavefront of the wave and general "
                        "paths to a measured per-depth schedule with a "
                        "spatial block re-sort (the same estimate per "
                        "lane); auto: the tuner times masked, compacted "
                        "and resorted on the card")
    p.add_argument("--nee_mode", default="auto",
                   choices=["auto", "twoarm", "folded"],
                   help="next-event estimation: twoarm (a shadow ray for "
                        "each MIS arm) or folded (the BSDF arm rides the "
                        "continuation ray); auto: the tuner times both on "
                        "the card, twoarm elsewhere")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the render "
                        "here")
    p.add_argument("--phase_timings", action="store_true",
                   help="print per-phase device timings (raygen, trace, "
                        "occlude, one bounce, the full path) of one launch "
                        "before rendering")
    p.add_argument("--debug_checks", action="store_true",
                   help="count per-bounce invariant violations (NaN "
                        "radiance/throughput, non-unit normals/frames, hit "
                        "t out of range, invalid pdfs) and print the table; "
                        "exits non-zero on violations. Path integrator, "
                        "general path.")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path without kernels)")
    return p


def with_resolution(scene, w: int, h: int):
    """The scene seen by a camera of w x h pixels with the same view."""
    from .geometry import camera as cam_lib

    cam = scene.camera
    fresh = cam_lib.make_camera((w, h), 40.0)
    return scene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * ((cam.width // 2) / (w // 2)),
        b=cam.b * ((cam.height // 2) / (h // 2)),
        c=cam.c))


def main(argv=None) -> int:
    args, rest = build_parser().parse_known_args(argv)
    if rest:
        sys.exit(f"pbrs_tpu_torch: {' '.join(rest)}: not yet ported")
    if args.trace_mode in TPU_TRACE_MODES:
        sys.exit(f"pbrs_tpu_torch: --trace_mode {args.trace_mode} is a TPU "
                 "treelet fetch variant of the JAX package and is not "
                 "ported: the BVH kernel (K5) carries its contract on the "
                 "card. Use auto or onehot")
    from . import render as render_mod
    from .io import image as io_image
    from .scene import presets

    if args.pbrt_file:
        from .scene.pbrt import loader

        scene = loader.build_scene(args.pbrt_file)
        name = os.path.splitext(os.path.basename(args.pbrt_file))[0]
    elif args.scene_name not in presets.PRESETS:
        sys.exit(f"pbrs_tpu_torch: scene {args.scene_name!r}: not yet "
                 f"ported (have {sorted(presets.PRESETS)})")
    else:
        scene = presets.PRESETS[args.scene_name]()
        name = args.scene_name
    if args.resolution:
        w, h = (int(x) for x in args.resolution.lower().split("x"))
        scene = with_resolution(scene, w, h)
    device = args.device
    if device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("pbrs_tpu_torch: no CUDA device; pass --device cpu to "
                 "render on the CPU")
    spp = args.msaa * args.msaa

    for flag, kind, suffix in ((args.visualize_normals, "normals", "normals"),
                               (args.visualize_materials, "materials",
                                "mtl")):
        if flag:
            img, _ = render_mod.render_image(scene, spp=1, integrator=kind,
                                             device=device)
            io_image.write_png(f"{name}-{suffix}.png", img)
            print(f"wrote {name}-{suffix}.png")

    film = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        film = render_mod.Film.load(args.checkpoint)
        print(f"resuming from {args.checkpoint} at {film.samples_done} "
              "samples")
    pixel_filter = None
    if args.filter:
        kind, _, radius = args.filter.partition(":")
        pixel_filter = (kind, float(radius or 1.0))

    if args.phase_timings:
        from . import profiling

        n = scene.camera.width * scene.camera.height
        phases = profiling.profile_phases(scene, n_pixels=min(n, 1 << 20),
                                          max_depth=args.depth,
                                          seed=args.seed, device=device)
        print("per-phase device timings (1 launch):")
        for k, v in phases.items():
            print(f"  {k}: {v}")

    t0 = time.time()
    img, stats = render_mod.render_image(
        scene, spp=spp, max_depth=args.depth, integrator=args.integrator,
        seed=args.seed, progress=True, device=device,
        sampler_kind=args.sampler, film=film,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, pixel_filter=pixel_filter,
        debug_checks=args.debug_checks, compact=args.compact,
        nee_mode=args.nee_mode, profile_dir=args.profile_dir)
    wall = time.time() - t0
    mrays = stats.traced_rays / max(stats.wall_time, 1e-9) / 1e6
    tuned = f", tuned {stats.tuned}" if stats.tuned else ""
    print(f"whole render time = {wall:.2f}s ({mrays:.1f} Mrays/s, "
          f"{stats.integrator} path on {device}{tuned})")
    rc = 0
    if args.debug_checks:
        from .integrators import debug_audit

        print(debug_audit.format_report(stats.audit))
        if sum(stats.audit.values()):
            rc = 2  # the image is still written, for inspection
    out = args.output or f"{name}-{args.integrator}-{spp}spp.exr"
    if out.endswith(".png"):
        io_image.write_png(out, img)
    else:
        io_image.write_exr(out, img)
    print(f"Image written to {out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
