"""The readings a cell's correctness limit is set from, in one process.

    python3 -m portbench.control --workload cornell_1024_d8.final \\
        --seeds 11 12 13 ... --control_seeds 11 12 13 --seconds 10 \\
        --out build/control_cornell.json

For a final-frame cell: set-up once, then for every seed a window of
``--seconds`` (the cell's own load) and the program's ``film_rel_l1``
against the reference; for each control seed also the control's: the
reference with every traced ray's origin and direction held in bfloat16,
put in the program's place, at the same pixels and passes. For a sharded
cell only the control (the program's readings come from the cell's own
runs): the reference's 16-spp frames against the bfloat16 control's, on
one card.

The benchmark's runs never run this; it needs the card, or --device cpu
at a tiny configuration (the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_reading(cfg, scene, seed, pixels, n_samples, msaa, device,
                    ref=None):
    """film_rel_l1 of the bfloat16-ray control against the reference, on
    the reference's own scene."""
    import torch

    from portbench import check
    from portbench.reference import render as reference

    depth = cfg["max_depth"]
    if ref is None:
        ref = reference.film_sums(scene, seed, pixels, n_samples, depth, msaa,
                                  device)
    low = reference.film_sums(scene, seed, pixels, n_samples, depth, msaa,
                              device, ray_dtype=torch.bfloat16)
    return check.rel_l1(low, ref)


def final_frame_readings(cell, seeds, control_seeds, seconds, device):
    from portbench import check, harness, scenes
    from portbench.loops import final_frame as ff
    from portbench.reference import render as reference

    t0 = time.time()
    ctx = harness.Ctx(cell=cell, seed=seeds[0], seconds=seconds, trace=False,
                      device=device, t0=t0)
    rec = harness.RunRecord()
    scene, kw = ff.setup(ctx, rec)
    cfg = cell.config
    msaa = ff.msaa_of(cfg["frame_spp"])
    ref_scene = scenes.reference_scene(cfg, cell.root)
    rows = []
    for seed in seeds:
        film = ff.measure(ctx, rec, scene, kw, seed, seconds)
        pixels = check.check_pixels(seed, cfg["width"] * cfg["height"],
                                    cfg["check"]["pixels"])
        ref = reference.film_sums(ref_scene, seed, pixels, film.samples_done,
                                  cfg["max_depth"], msaa, device)
        row = {"seed": seed, "passes": film.samples_done,
               "program": check.rel_l1(film.accum[pixels], ref)}
        if seed in control_seeds:
            row["control"] = control_reading(cfg, ref_scene, seed, pixels,
                                             film.samples_done, msaa, device,
                                             ref=ref)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def sharded_readings(cell, control_seeds, device):
    from portbench import check, scenes

    cfg = cell.config
    ref_scene = scenes.reference_scene(cfg, cell.root)
    spp = int(cfg["frame_spp"])
    rows = []
    for seed in control_seeds:
        pixels = check.check_pixels(seed, cfg["width"] * cfg["height"],
                                    cfg["check"]["pixels"])
        row = {"seed": seed, "passes": spp,
               "control": control_reading(cfg, ref_scene, seed, pixels, spp,
                                          max(1, int(round(spp ** 0.5))),
                                          device)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    harness.cache_env(cell.root)
    if cell.traffic["loop"] == "final_frame":
        rows = final_frame_readings(cell, args.seeds or args.control_seeds,
                                    set(args.control_seeds), args.seconds,
                                    args.device)
    else:
        rows = sharded_readings(cell, args.control_seeds, args.device)
    summary = {"workload": cell.name, "rows": rows,
               "program_max": max((r["program"] for r in rows
                                   if "program" in r), default=None),
               "control_min": min((r["control"] for r in rows
                                   if "control" in r), default=None)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
