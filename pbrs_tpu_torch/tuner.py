"""Route auto's chooser on the card: time each candidate render
configuration at the render's own shapes and keep the fastest. Mirrors
pbrs_tpu/tuner.py, whose docstring records why: picking by eligibility
alone (the first fused integrator that supports the scene) shipped a 2.6x
slowdown on the interior.

Candidates (pbrs_tpu/tuner.py:335-423), each built by
``render.make_integrator``:

* K2 / K3: a scene the fused diffuse kernel (K2) or the fused single-lobe
  kernel (K3) supports takes it unmeasured ("fused_diffuse",
  "fused_single_lobe"); they have no folded mode, so a pinned
  nee_mode="folded" skips them.
* integrator: the general wavefront ("general"), its folded twin
  ("general-folded") when the scene has lights, the wave path (K4,
  "wave") when ``fused_wave.scene_supports_wave`` holds, and its folded
  twin ("wave-folded") when the scene has lights and
  ``scene_supports_wave_folded`` holds. With no light, folded is two-arm.
* compaction: masked, and compacted ("/compact") to the schedule of
  ``render.measured_schedule`` when that schedule ever shrinks.
* resort: on a scene with a primitive family above the BVH threshold
  (K5's, ``trace_kernel.TREELET_THRESHOLD``), for the folded structure or
  a scene without lights, the sort-only candidate ("/resort"): every
  bounce from the second on sorts its lanes' blocks spatially, on the
  compaction schedule if there is one.

The JAX package also times a trace-mode axis (its treelet fetch variants).
The port has one tracer pair, K1 + K5, so its labels drop that segment: a
label here is pbrs_tpu's with "/onehot" taken out ("wave/compact" here,
"wave/onehot/compact" there; "general-folded/compact/resort" here,
"general-folded/onehot/compact/resort" there).

Schedules: ``render.measured_schedule``, the pilot ``render_image(compact=
True)`` runs. Under folded NEE it counts the lanes that may still owe a
pending (``measure_alive(owed=True)``), where pbrs_tpu lags the live
counts by one bounce (pbrs_tpu/tuner.py:234-244); the port's count keeps
the compacted folded loop equal to the masked one (ROADMAP.md, Queue 3).

No fallback: pbrs_tpu's tune records a candidate that raises as failed
and renders "general/fallback" when all fail. Here a candidate whose
kernel fails to build or launch raises out of ``tune`` as a
``CandidateError`` naming it, and so does one whose radiance is not
finite. Only a failure to write the decision cache is ignored.

The decision cache: each winner is stored as JSON under
$PBRS_TUNER_CACHE (default ".pbrs_tuner") keyed by the package, the card,
TUNER_CACHE_VERSION, the scene's fingerprint, the lane count, depth, msaa,
the sampler and the pinned compact / nee_mode, so no record of the JAX
package is read as the port's. Measurements are stored as they land, so a
pilot cut short resumes. PBRS_TUNER_NOCACHE=1 skips the cache; PBRS_COMPACT
("1" or another value) pins compact, as in pbrs_tpu; PBRS_TRACE_MODE may
name the one tracer pair ("auto" or "onehot") and nothing else.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from . import render
from .accel import dispatch as trace_dispatch
from .accel import fused_kernel as fk
from .accel import fused_single_lobe as fsl
from .accel import fused_wave as fw
from .accel import trace_kernel as tk

# Bump when the candidates or their kernels change: a cached winner must
# not outlive what it was measured against.
TUNER_CACHE_VERSION = 1
_CACHE_DIR_ENV = "PBRS_TUNER_CACHE"
TRACE_MODES = ("auto", "onehot")  # both name the one tracer pair
# A winner's record; a file without them (another version's) re-tunes.
RECORD_KEYS = {"label", "route", "nee_mode", "schedule", "resort"}


class CandidateError(RuntimeError):
    """A candidate failed to build, to launch, or to give finite
    radiance."""


def _scene_fingerprint(scene):
    """Cheap, stable identity for tuning decisions, as pbrs_tpu computes
    it: family / material / light shapes, the instance groups and the
    geometry's extents rounded to 3 decimals."""
    g = scene.geom

    def cnt(a):
        return int(a.shape[0])

    parts = [cnt(g.tri_p0), cnt(g.quad_origin), cnt(g.sph_center),
             cnt(g.disk_center), int(scene.num_lights)]
    mk = scene.materials.kind
    parts.append(list(mk.shape))
    parts.append([int(x) for x in mk.reshape(-1).tolist()])
    parts.append(scene.env.kind)
    for grp in scene.instanced:
        gg = grp.geom
        parts.append(("grp", cnt(gg.tri_p0), cnt(gg.quad_origin),
                      cnt(gg.sph_center), cnt(gg.disk_center),
                      cnt(grp.fwd)))
    for a in (g.tri_p0, g.quad_origin, g.sph_center, g.disk_center):
        if a.numel():
            parts.append([round(float(x), 3) for x in
                          a.amin(0).tolist() + a.amax(0).tolist()])
    blob = json.dumps(parts, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def _device_name(scene):
    dev = scene.device
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def _cache_root():
    return os.environ.get(_CACHE_DIR_ENV) or ".pbrs_tuner"


def _cache_path(key):
    return os.path.join(_cache_root(), f"{key}.json")


def _cache_key(scene, sampler, n_lanes, depth, msaa, compact, nee_mode):
    blob = json.dumps(["pbrs_tpu_torch", _device_name(scene),
                       TUNER_CACHE_VERSION, _scene_fingerprint(scene),
                       int(n_lanes), int(depth), int(msaa),
                       type(sampler).__name__, str(compact),
                       str(nee_mode)]).encode()
    return hashlib.sha1(blob).hexdigest()[:24]


def _cache_load(key):
    try:
        with open(_cache_path(key)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _cache_store(key, rec):
    try:
        os.makedirs(_cache_root(), exist_ok=True)
        tmp = _cache_path(key) + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, _cache_path(key))
    except OSError:
        pass  # best effort: a render never fails over its cache


def _env_overrides():
    """(trace mode, compact) from PBRS_TRACE_MODE / PBRS_COMPACT, None where
    unset."""
    tm = os.environ.get("PBRS_TRACE_MODE") or None
    comp = os.environ.get("PBRS_COMPACT")
    compact = None if comp is None else comp == "1"
    return tm, compact


def _scene_bvh_scale(scene):
    """True when a primitive family, of the scene or of an instance
    group's master, is above K5's threshold (where resort can pay)."""
    geoms = [scene.geom] + [grp.geom for grp in scene.instanced]
    return any(c > tk.TREELET_THRESHOLD for g in geoms for c in g.counts)


class TunedRender:
    """One render configuration, built by ``render.make_integrator``:
    route ("auto" for K2 / K3, "general" or "wave"), NEE structure, shrink
    schedule and resort. Callable as (lanes, sample_ids) -> (radiance
    [N, 3], traced-ray count). ``name`` is make_integrator's name of it,
    ``label`` the tuner's."""

    def __init__(self, scene, sampler, depth, msaa, label, route,
                 nee_mode="twoarm", schedule=None, resort=False,
                 trace_fns=None, lanes=0):
        self.scene, self.sampler = scene, sampler
        self.depth, self.msaa, self.lanes = depth, msaa, lanes
        self.label, self.route, self.nee_mode = label, route, nee_mode
        self.schedule = None if schedule is None else tuple(schedule)
        self.resort = bool(resort)
        self.trace_fns = trace_fns
        self.name, self.fn = render.make_integrator(
            scene, sampler, depth, msaa, route, nee_mode=nee_mode,
            schedule=self.schedule, resort=self.resort, trace_fns=trace_fns)
        # Set by tune: the seconds a launch of each candidate it measured
        # (or read from a partial record), and how many it timed itself.
        self.times, self.measured, self.cache_hit = {}, 0, False

    @property
    def compacted(self):
        return self.fn.compacted

    def masked(self):
        """The same integrator without schedule or resort, for a launch of
        another lane count (a tail chunk)."""
        if self.schedule is None and not self.resort:
            return self
        return TunedRender(self.scene, self.sampler, self.depth, self.msaa,
                           self.label + "/masked-tail", self.route,
                           self.nee_mode, trace_fns=self.trace_fns,
                           lanes=self.lanes)

    def __call__(self, lanes, sample_ids):
        return self.fn(lanes, sample_ids)

    def record(self):
        return {"label": self.label, "route": self.route,
                "nee_mode": self.nee_mode,
                "schedule": (list(self.schedule)
                             if self.schedule is not None else None),
                "resort": self.resort, "times": self.times}


def _measure(step, lanes, sample_ids, reps=2):
    """Seconds a launch of `step`: one warm-up launch (it also builds the
    kernels), then the median of `reps` timed launches, with the card
    synchronized before every clock read. Raises FloatingPointError on a
    non-finite radiance: a fast wrong candidate must never win."""
    cuda = lanes.device.type == "cuda"

    def clock():
        if cuda:
            torch.cuda.synchronize(lanes.device)
        return time.perf_counter()

    rad, _ = step(lanes, sample_ids)
    if not bool(torch.isfinite(rad).all()):
        raise FloatingPointError("non-finite radiance")
    ts = []
    for _ in range(reps):
        t0 = clock()
        step(lanes, sample_ids)
        ts.append(clock() - t0)
    return float(np.median(ts))


def _auto_sched(scene, sampler, lanes, depth, msaa, isect_fn, nee_mode):
    """render.measured_schedule on the pilot's lanes, or None where it
    never shrinks (the masked loop is the same)."""
    sched = render.measured_schedule(scene, sampler, lanes, isect_fn, depth,
                                     msaa, nee_mode)
    n = int(lanes.shape[0])
    return None if all(c >= n for c in sched) else sched


def tune(scene, sampler, lanes, sample_ids, depth=5, msaa=2, compact="auto",
         nee_mode="auto", verbose=False):
    """Time each candidate on a (lanes, sample_ids) launch and return the
    fastest as a TunedRender. `scene` and `lanes` on one device (the card;
    the CPU runs the kernels' plain versions). compact: "auto", True or
    False; nee_mode: "auto", "twoarm" or "folded". A pinned value limits
    the candidates to those that match. Raises CandidateError when a
    candidate fails."""
    env_tm, env_compact = _env_overrides()
    if env_tm is not None and env_tm not in TRACE_MODES:
        raise ValueError(f"PBRS_TRACE_MODE={env_tm!r}: the TPU treelet fetch "
                         f"variants are not ported; the port's one tracer "
                         f"pair (K1 + K5) is {TRACE_MODES}")
    if env_compact is not None:
        compact = env_compact
    if compact not in ("auto", True, False):
        raise ValueError(f"compact must be 'auto', True or False, got "
                         f"{compact!r}")
    if nee_mode not in ("auto",) + render.NEE_MODES:
        raise ValueError(f"nee_mode must be 'auto' or one of "
                         f"{render.NEE_MODES}, got {nee_mode!r}")
    n = int(lanes.shape[0])

    def log(msg):
        if verbose:
            print(f"  [tune] {msg}", file=sys.stderr, flush=True)

    def build(label, route, nmode="twoarm", schedule=None, resort=False):
        return TunedRender(scene, sampler, depth, msaa, label, route, nmode,
                           schedule, resort, trace_fns, n)

    # Unconditional winners where eligible, as in pbrs_tpu: K2 and K3
    # (two-arm only).
    trace_fns = None
    if nee_mode != "folded":
        for label, ok in (("fused_diffuse", fk.scene_supports_fused),
                          ("fused_single_lobe",
                           fsl.scene_supports_single_lobe)):
            if ok(scene):
                return build(label, "auto")

    trace_fns = trace_dispatch.make_trace_fns(scene, True)
    cache_key, partial = None, {}
    if os.environ.get("PBRS_TUNER_NOCACHE") != "1":
        cache_key = _cache_key(scene, sampler, n, depth, msaa, compact,
                               nee_mode)
        rec = _cache_load(cache_key)
        if rec is not None and "partial" in rec:
            partial = dict(rec["partial"])
            log(f"resuming pilot: {len(partial)} cached measurements")
        elif rec is not None and RECORD_KEYS <= rec.keys():
            best = build(rec["label"], rec["route"], rec["nee_mode"],
                         rec["schedule"], rec["resort"])
            best.times, best.cache_hit = rec.get("times", {}), True
            log(f"cache hit ({cache_key}): {best.label}")
            return best

    lit = scene.num_lights > 0
    integs = [("general", "general", "twoarm")]
    if lit:
        integs.append(("general-folded", "general", "folded"))
    if fw.scene_supports_wave(scene):
        integs.append(("wave", "wave", "twoarm"))
        if lit and fw.scene_supports_wave_folded(scene):
            integs.append(("wave-folded", "wave", "folded"))
    if nee_mode != "auto" and lit:
        integs = [i for i in integs if i[2] == nee_mode]
    compacts = [False, True] if compact == "auto" else [compact]
    scheds = {}
    if True in compacts:
        for nmode in dict.fromkeys(i[2] for i in integs):
            scheds[nmode] = _auto_sched(scene, sampler, lanes, depth, msaa,
                                        trace_fns[0], nmode)
            if scheds[nmode] is None:
                log(f"{nmode}: the schedule never shrinks; its compacted "
                    "candidates are skipped")

    big = _scene_bvh_scale(scene)
    specs, seen = [], set()
    for iname, route, nmode in integs:
        for comp in compacts:
            s = scheds.get(nmode) if comp else None
            label = iname + ("/compact" if s else "")
            if label not in seen:  # compact with no shrink == masked
                seen.add(label)
                specs.append((label, route, nmode, s, False))
        if big and (nmode == "folded" or not lit):
            s = scheds.get(nmode)
            label = iname + ("/compact" if s else "") + "/resort"
            if label not in seen:
                seen.add(label)
                specs.append((label, route, nmode, s, True))

    if len(specs) == 1:
        return build(*specs[0])

    best, best_t, times, measured = None, float("inf"), {}, 0
    for label, route, nmode, s, resort in specs:
        try:
            cand = build(label, route, nmode, s, resort)
            if label in partial:
                dt = partial[label]
                log(f"{label}: {dt * 1e3:.3f} ms a launch (checkpointed)")
            else:
                dt = _measure(cand, lanes, sample_ids)
                measured += 1
                log(f"{label}: {dt * 1e3:.3f} ms a launch")
        except Exception as e:
            raise CandidateError(f"tuner candidate {label} failed: "
                                 f"{type(e).__name__}: {e}") from e
        times[label] = partial[label] = dt
        if cache_key is not None:
            _cache_store(cache_key, {"partial": partial})
        if dt < best_t:
            best, best_t = cand, dt
    best.times, best.measured = times, measured
    if cache_key is not None:
        _cache_store(cache_key, best.record())
    log(f"selected {best.label}")
    return best
