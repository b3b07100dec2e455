"""Where the wave path and the general path part, lane by lane.

    python -m pbrs_tpu_torch.lane_diff \\
        --pbrt_file scenes/interior/interior.pbrt --resolution 1024x1024 \\
        --depth 5 --out chiprun_out/interior_lanes.json
    python -m pbrs_tpu_torch.lane_diff \\
        --pbrt_file scenes/interior/interior.pbrt --resolution 1024x1024 \\
        --depth 5 --device cpu --pixels chiprun_out/interior_lanes.json

Renders sample 0 (PCG seed 0, two-arm NEE) of a wave-eligible scene
through the wave path (K4) and the general path on one device, on the same
random streams, and finds the lanes outside atol 3e-5, rtol 2e-4
(``_Paths`` also takes the Sobol' sampler and folded NEE, as
chip_smoke.py's phases 18 and 22 use it). With --pixels it takes
the lanes of an earlier run's JSON instead, e.g. to render on the CPU the
lanes found on the card. It renders those lanes again on their own with
every closest-hit and shadow query logged, and at max depth 1..D, and
names for each lane the bounce at which the two paths part and how:

- "branch": the bounce's ray leaves in another direction, by more than
  BRANCH_TOL in a component (the BSDF sample of the bounce before took
  another lobe or the other side of a Fresnel test);
- "drift": the same, by DIR_TOL to BRANCH_TOL (the same branch, rounding
  amplified, e.g. at grazing angles);
- "edge": the same direction (within DIR_TOL) meets another surface, or
  one path hits where the other misses -- rounding of the ray carried it
  across an edge;
- "shadow": the paths agree on the ray and on what it hits, and a shadow
  query of the bounce that both cast is blocked on one only;
- "light sample": the same, with a light-sampled shadow direction that
  differs beyond DIR_TOL (the light or env-IS texel drawn);
- "arm flip": the same, and the bounce's contribution differs by more than
  FLIP_TOL of itself: a whole term is on one path only (an arm's validity
  test -- pdf > 0, radiance > 0, the side of a surface -- went the other
  way);
- "value": the same, within FLIP_TOL (arithmetic on the same terms).

Writes one JSON file (--out) and prints a summary line per class. Runs on
the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

import torch

ATOL, RTOL = 3e-5, 2e-4
DIR_TOL, BRANCH_TOL = 1e-3, 0.1
FLIP_TOL = 0.05


def _logged(fn, log, keep):
    """fn, appending (ray dir, ray t_max, keep(result)) of each call, on
    the host, to log."""
    def wrapped(rays):
        out = fn(rays)
        log.append((rays.dir.cpu(), rays.t_max.cpu(), keep(out)))
        return out
    return wrapped


def _keep_hit(hit):
    return hit.hit.cpu(), hit.mat_id.cpu(), hit.t.cpu()


def _keep_occ(occ):
    return occ.cpu()


class _Paths:
    """The wave path and the general path of a scene, each with its tracer
    built once, on one sampler (seed 0 of "pcg", "sobol") and NEE mode."""

    def __init__(self, scene, sampler="pcg", nee_mode="twoarm"):
        from .accel import dispatch
        from .accel import fused_wave as fw
        from .render import SAMPLERS

        self.scene = scene
        self.sampler = SAMPLERS[sampler](0)
        self.nee_mode = nee_mode
        self.wave = fw.FusedWaveIntegrator(scene,
                                           folded=nee_mode == "folded")
        self.fns = {"wave": (self.wave.intersect_fn, self.wave.occlude_fn),
                    "general": dispatch.make_trace_fns(scene, True)}

    def render(self, path, pix, depth, msaa, log=False):
        """(radiance [N,3], closest-hit log, occlusion log) of one path."""
        from .integrators import wavefront

        hits, occl = [], []
        isect, occ = self.fns[path]
        if log:
            isect = _logged(isect, hits, _keep_hit)
            occ = _logged(occ, occl, _keep_occ)
        if path == "wave":
            self.wave.intersect_fn, self.wave.occlude_fn = isect, occ
            rad, _ = self.wave.render_samples(self.sampler, pix, 0,
                                              max_depth=depth, msaa=msaa)
        else:
            rad, _ = wavefront.render_samples(
                self.scene, self.sampler, pix, 0, isect, occ,
                max_depth=depth, msaa=msaa, nee_mode=self.nee_mode)
        return rad, hits, occl


def _shadows(occl, n, depth):
    """Per bounce, ((dir, cast, blocked) of the light-sampled query, the
    same of the BSDF-sampled one, which folded NEE does not cast); a query
    is cast when its t_max > 0. The wave path makes one occlusion call a
    bounce (over both batches when two-arm), the general path one per
    batch."""
    out = []
    per = 1 if len(occl) == depth else 2
    for b in range(depth):
        if per == 1:
            d, t, occ = occl[b]
            pairs = [(d[:n], t[:n], occ[:n])]
            if d.shape[0] > n:
                pairs.append((d[n:], t[n:], occ[n:]))
        else:
            pairs = occl[2 * b:2 * b + 2]
        out.append([(d, t > 0.0, o & (t > 0.0)) for d, t, o in pairs])
    return out


def _unit(d):
    return d / d.norm(dim=-1, keepdim=True).clamp_min(1e-30)


def perlin_materials(scene):
    """[M] bool: the materials with a Perlin-marble-textured slot."""
    from .textures import textures as tex

    tid = scene.materials.tex_id
    kind = scene.textures.kind[tid.clamp_min(0).long()]
    return ((tid >= 0) & (kind == tex.PERLIN)).any(dim=1)


def _arm(aw, ag, i):
    (dw, cw, bw), (dg, cg, bg) = aw, ag
    return {"cast": [bool(cw[i]), bool(cg[i])],
            "blocked": [bool(bw[i]), bool(bg[i])],
            "dir_diff": float((_unit(dw[i]) - _unit(dg[i])).abs().max())}


def _nee_cause(arms_w, arms_g, i, inc_w, inc_g):
    """How a bounce whose ray and hit agree parts, given both paths' shadow
    queries and radiance added at that bounce: by priority, a query both
    cast and one blocks, a light-sampled direction that differs, a
    contribution that differs by more than FLIP_TOL of itself, else the
    value. (The wave path casts only the arms that can contribute, the
    general path every arm of a live lane, so whether a query is cast is
    no test of an arm's validity.)"""
    arms = [_arm(aw, ag, i) for aw, ag in zip(arms_w, arms_g)]
    both = [all(a["cast"]) for a in arms]
    if any(c and a["blocked"][0] != a["blocked"][1]
           for a, c in zip(arms, both)):
        return "shadow"
    if both[0] and arms[0]["dir_diff"] > DIR_TOL:
        return "light sample"
    scale = max(float(inc_w.abs().max()), float(inc_g.abs().max()), 1e-30)
    if float((inc_w - inc_g).abs().max()) > FLIP_TOL * scale:
        return "arm flip"
    return "value"


def classify(scene, pix, depth, msaa, paths=None):
    """Per lane of pix: the bounce where the paths part and how, with the
    radiance of both at every depth and the materials each path hit.
    `paths` (a _Paths) sets the sampler and NEE mode: PCG two-arm by
    default."""
    paths = paths or _Paths(scene)
    cum = {p: [paths.render(p, pix, d, msaa)[0].cpu()
               for d in range(1, depth + 1)] for p in ("wave", "general")}
    logs = {}
    for p in ("wave", "general"):
        rad, hits, occl = paths.render(p, pix, depth, msaa, log=True)
        logs[p] = (rad.cpu(), hits, occl)
    perlin = perlin_materials(scene).cpu()
    n = pix.shape[0]
    sh = {p: _shadows(logs[p][2], n, depth) for p in logs}
    lanes = []
    for i in range(n):
        rad_part = next((b for b in range(depth) if not torch.isclose(
            cum["wave"][b][i], cum["general"][b][i], atol=ATOL,
            rtol=RTOL).all()), None)
        how, at, detail = "same", None, {}
        for b in range(depth):
            (dw, tw, (hw, mw, sw)) = logs["wave"][1][b]
            (dg, tg, (hg, mg, sg)) = logs["general"][1][b]
            live = bool(tw[i] > 0) or bool(tg[i] > 0)
            dd = float((_unit(dw[i]) - _unit(dg[i])).abs().max())
            if live and dd > DIR_TOL:
                how = "branch" if dd > BRANCH_TOL else "drift"
                at, detail = b, {"dir_diff": dd}
                break
            if live and (bool(hw[i]) != bool(hg[i])
                         or int(mw[i]) != int(mg[i])):
                how, at = "edge", b
                detail = {"dir_diff": dd, "hit": [bool(hw[i]), bool(hg[i])],
                          "mat": [int(mw[i]), int(mg[i])],
                          "t": [float(sw[i]), float(sg[i])]}
                break
            if rad_part is not None and b == rad_part:
                inc = [cum[p][b][i] - (cum[p][b - 1][i] if b else 0.0)
                       for p in ("wave", "general")]
                at = b
                how = _nee_cause(sh["wave"][b], sh["general"][b], i, *inc)
                detail = {"arms": [_arm(aw, ag, i) for aw, ag in
                                   zip(sh["wave"][b], sh["general"][b])]}
                break
        mats = [[int(h[1][i]) if bool(h[0][i]) and bool(t[i] > 0) else -1
                 for _, t, h in logs[p][1]] for p in ("wave", "general")]
        w = scene.camera.width
        p = int(pix[i])
        lanes.append({
            "pixel": p, "x": p % w, "y": p // w, "parts_at_bounce": at,
            "radiance_parts_at_depth": None if rad_part is None
            else rad_part + 1,
            "how": how, "detail": detail, "materials_hit": mats,
            "perlin": any(m >= 0 and bool(perlin[m]) for m in sum(mats, [])),
            "wave": [float(x) for x in logs["wave"][0][i]],
            "general": [float(x) for x in logs["general"][0][i]],
            "max_abs_d": float((logs["wave"][0][i]
                                - logs["general"][0][i]).abs().max())})
    return lanes


def summary(lanes):
    """One line on a set of classified lanes."""
    at = Counter(ln["parts_at_bounce"] for ln in lanes)
    return (f"{len(lanes)} lanes ({sum(ln['perlin'] for ln in lanes)} on a "
            f"Perlin path), parting at bounces "
            f"{dict(sorted(at.items(), key=lambda kv: str(kv[0])))}, max |d| "
            f"{max(ln['max_abs_d'] for ln in lanes):.4g}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pbrs_tpu_torch.lane_diff")
    p.add_argument("--scene_name", default="everything")
    p.add_argument("--pbrt_file", default=None)
    p.add_argument("--resolution", default="1024x1024", metavar="WxH")
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--msaa", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--pixels", default=None,
                   help="JSON of an earlier run: classify its lanes")
    p.add_argument("--out", default=None, help="JSON output path")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("pbrs_tpu_torch.lane_diff: no CUDA device; pass --device "
                 "cpu")
    from .cli import with_resolution
    from .scene import presets

    w, h = (int(x) for x in args.resolution.lower().split("x"))
    if args.pbrt_file:
        from .scene.pbrt import loader

        scene, label = loader.build_scene(args.pbrt_file), args.pbrt_file
    else:
        scene, label = presets.PRESETS[args.scene_name](), args.scene_name
    scene = with_resolution(scene, w, h).to(args.device)
    dev = scene.device
    paths = _Paths(scene)
    report = {"scene": label, "resolution": args.resolution,
              "depth": args.depth, "msaa": args.msaa, "device": args.device,
              "atol": ATOL, "rtol": RTOL}
    if args.device.startswith("cuda"):
        report["card"] = torch.cuda.get_device_name(0)
    if args.pixels:
        with open(args.pixels) as f:
            earlier = json.load(f)
        pix = torch.tensor([ln["pixel"] for ln in earlier["lanes"]],
                           dtype=torch.int32, device=dev)
    else:
        pix = torch.arange(w * h, dtype=torch.int32, device=dev)
        full = {path: paths.render(path, pix, args.depth, args.msaa)[0]
                for path in ("wave", "general")}
        outside = ~torch.isclose(full["wave"], full["general"], atol=ATOL,
                                 rtol=RTOL).all(dim=1)
        report.update(lanes_total=w * h, outside=int(outside.sum()),
                      max_abs_d=float((full["wave"] - full["general"])
                                      .abs().max()))
        pix = pix[outside]
    lanes = (classify(scene, pix, args.depth, args.msaa, paths)
             if pix.numel() else [])
    if not args.pixels:
        # A lane's paths do not depend on the other lanes of its batch.
        sub = torch.nonzero(outside).flatten()
        for ln, i in zip(lanes, sub.tolist()):
            ln["reproduced"] = bool(
                (torch.tensor(ln["wave"], device=dev)
                 == full["wave"][i]).all()
                and (torch.tensor(ln["general"], device=dev)
                     == full["general"][i]).all())
    report["classes"] = dict(Counter(ln["how"] for ln in lanes))
    report["lanes"] = lanes
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "lanes"}))
    for how in sorted(report["classes"]):
        sel = [ln for ln in lanes if ln["how"] == how]
        print(f"{how}: {summary(sel)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
