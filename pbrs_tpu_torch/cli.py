"""Command-line entry point. Mirrors pbrs_tpu/cli.py for the flags ported so
far; any other flag or preset exits with "not yet ported".

    python -m pbrs_tpu_torch.cli --scene_name cornell_box --msaa 2 \\
        --depth 5 --resolution 256x256 --output cornell.exr
    python -m pbrs_tpu_torch.cli --pbrt_file scenes/interior/interior.pbrt
    python -m pbrs_tpu_torch.cli --sampler sobol --integrator direct
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


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
    p.add_argument("--output", default=None, help="output EXR/PNG path")
    p.add_argument("--visualize_normals", action="store_true",
                   help="also write <scene>-normals.png (1 spp)")
    p.add_argument("--visualize_materials", action="store_true",
                   help="also write <scene>-mtl.png (1 spp)")
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

    t0 = time.time()
    img, stats = render_mod.render_image(
        scene, spp=spp, max_depth=args.depth, integrator=args.integrator,
        seed=args.seed, progress=True, device=device,
        sampler_kind=args.sampler)
    wall = time.time() - t0
    mrays = stats.traced_rays / max(stats.wall_time, 1e-9) / 1e6
    print(f"whole render time = {wall:.2f}s ({mrays:.1f} Mrays/s, "
          f"{stats.integrator} path on {device})")
    out = args.output or f"{name}-{args.integrator}-{spp}spp.exr"
    if out.endswith(".png"):
        io_image.write_png(out, img)
    else:
        io_image.write_exr(out, img)
    print(f"Image written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
