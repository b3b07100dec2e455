"""Render loop: film accumulation over sample launches, checkpoint/resume.
Mirrors pbrs_tpu/render.py: block compaction, the tuner (tuner.py) and the
profiler trace included.

The pixel grid (in chunks of at most 2^20 pixels) renders one sample
index per launch, accumulating into a film. The sampler is PCG, Sobol' or
threefry (`sampler_kind`). Which path integrator runs:

- route "auto" on CUDA, at render_image's defaults (compact and nee_mode
  "auto"), with a PCG or Sobol' sampler: the tuner's pick. The fused
  diffuse kernel (K2) when the scene is eligible, else the fused
  single-lobe kernel (K3) when that one is, each unmeasured; else the
  fastest, timed on the card at the first chunk's lane count, of the
  general wavefront and the wave path -- the shade kernel (K4) with the
  trace outside -- each two-arm or folded, masked, compacted or resorted.
  An explicit compact or nee_mode limits the candidates; with both
  explicit (and in ``make_integrator``) route auto takes the first
  eligible of K2, K3 and the wave path, two-arm, else the general
  wavefront; with folded NEE the folded wave path (K4 folded) where the
  scene is eligible, else the folded general wavefront. A threefry sampler
  takes the general wavefront. All trace through the flat-bank kernel
  (K1) and, for every primitive family above the BVH threshold, the BVH
  kernel (K5), plus the scene's instance groups. On the CPU, the general
  wavefront with the broadcast sweep;
- route "general": the general wavefront through K1 and K5 (their plain
  versions on the CPU);
- route "wave": the wave path (K4, its plain version on the CPU);
- route "plain": the general wavefront with the broadcast sweep, no kernel.

A pixel filter, the BSDF-only estimator (`use_nee=False`) and the
invariant audit (`debug_checks`) are options of the general wavefront, as
in the reference: with any of them route auto takes the general path.

The film (accumulated radiance and the count of samples done) is the
whole renderer state: `Film.save` / `Film.load` checkpoint it, a render
given a film resumes at its sample count, and a SIGTERM during a render
with a checkpoint path flushes the samples done to it and raises
KeyboardInterrupt. Each pixel's sum stays on the device in the order the
samples were drawn, starting from the film's own sum, so a resumed render
equals an uninterrupted one bit for bit.

The direct integrator and the normal / material visualizers
(`integrator=`) run through the same tracers, by route.

compact=True (or "on") runs the wave path (K4) and the general wavefront
on a shrinking batch: a pilot pass at the launch's lane count measures
each bounce's covered lanes (`wavefront.measure_alive`), `auto_schedule`
turns them into static per-bounce capacities, and every launch of that
lane count compacts its live lanes in blocks of 8 between bounces. A
launch that does not tile into 8-lane blocks, or of another lane count (a
tail chunk), takes the masked loop, as in the JAX package. resort (a
make_integrator option the tuner measures) sorts the lanes' blocks at
every bounce from the second on without shrinking. K2 and K3 do not
compact.
"""

from __future__ import annotations

import contextlib
import signal
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import profiling
from .accel import dispatch as trace_dispatch
from .accel import fused_kernel as fk
from .accel import fused_single_lobe as fsl
from .accel import fused_wave as fw
from .core import filters as flt
from .core import sampler as smp
from .integrators import debug_audit as aud_mod
from .integrators import direct as direct_mod
from .integrators import wavefront

ROUTES = ("auto", "general", "plain", "wave")
INTEGRATORS = ("path", "direct", "normals", "materials")
NEE_MODES = ("twoarm", "folded")
SAMPLERS = {"pcg": smp.PCGSampler, "sobol": smp.SobolSampler,
            "threefry": smp.ThreefrySampler}


@dataclass
class RenderStats:
    wall_time: float = 0.0
    camera_rays: int = 0
    spp: int = 0
    launches: int = 0
    # Traced segments counted on the device: alive closest-hit rays + alive
    # shadow rays.
    traced_rays: int = 0
    integrator: str = ""
    # debug_checks: {invariant: violation count} (debug_audit.py).
    audit: dict | None = None
    # compact: the per-bounce lane capacities, and the launches that ran
    # the compacting loop.
    schedule: tuple | None = None
    compacted_launches: int = 0
    # The tuner's label of the winner ("" where no tuner ran).
    tuned: str = ""


@dataclass
class Film:
    """Accumulated radiance + sample count."""

    width: int
    height: int
    accum: np.ndarray = field(default=None)
    samples_done: int = 0

    def __post_init__(self):
        if self.accum is None:
            self.accum = np.zeros((self.height * self.width, 3), np.float32)

    def mean_image(self) -> np.ndarray:
        n = max(self.samples_done, 1)
        return (self.accum / n).reshape(self.height, self.width, 3)

    def save(self, path: str) -> None:
        np.savez(path, accum=self.accum, samples_done=self.samples_done,
                 width=self.width, height=self.height)

    @staticmethod
    def load(path: str) -> "Film":
        z = np.load(path)
        return Film(width=int(z["width"]), height=int(z["height"]),
                    accum=z["accum"], samples_done=int(z["samples_done"]))


def _fused_integrator(scene, sampler, nee_mode, bvh_threshold, trace_fns,
                      wave_only=False):
    """(name, integrator) of route auto's fused path on CUDA, or (None,
    None) where the general wavefront runs: the fused kernels draw PCG and
    Sobol' only, and K2 / K3 have no folded mode. wave_only (route "wave"):
    the wave path, or raise."""
    folded = nee_mode == "folded"
    try:
        fk.rng_kind(sampler)
    except TypeError:
        if wave_only:
            raise
        return None, None
    if not (wave_only or folded):
        if fk.scene_supports_fused(scene):
            return "fused", fk.FusedDiffuseIntegrator(scene)
        if fsl.scene_supports_single_lobe(scene):
            return "fused_single_lobe", fsl.FusedSingleLobeIntegrator(scene)
    if (fw.scene_supports_wave_folded if folded
            else fw.scene_supports_wave)(scene):
        return ("fused_wave_folded" if folded else "fused_wave",
                fw.FusedWaveIntegrator(scene, bvh_threshold, folded=folded,
                                       trace_fns=trace_fns))
    if wave_only:
        raise ValueError(f"route 'wave': the scene is not eligible for the "
                         f"wave path under nee_mode {nee_mode!r}")
    return None, None


def make_integrator(scene, sampler, max_depth: int, msaa: int,
                    route: str = "auto", bvh_threshold: int | None = None,
                    integrator: str = "path", nee_mode: str = "twoarm",
                    use_nee: bool = True, filter_table=None,
                    audit: bool = False, compact_pilot=None, schedule=None,
                    resort: bool = False, trace_fns=None):
    """(name, fn): fn(pixel_idx, sample_idx) -> (radiance [N,3], traced-ray
    count), and with audit=True a third result, the [K] debug_audit
    counts. `scene` must already be on its device; bvh_threshold overrides
    the family size above which the general path traces a family with
    K5. A direct or visualizer pass counts every segment it hands a
    tracer with a live extent. use_nee=False, a filter table or audit
    keep route auto on the general path. Route "wave" is the wave path
    (K4), folded under nee_mode "folded", on any device; it raises where
    the scene or the sampler is not eligible.

    compact_pilot: a pixel batch (the launch's lanes) to measure a shrink
    schedule on with sample 0 (``measured_schedule``); the wave and
    general paths of the path integrator then compact every launch of
    that lane count that tiles into blocks (the name ends in
    "_compact"). schedule: a schedule measured already, in place of the
    pilot. resort: the wave and general paths sort the lanes' blocks
    spatially at each bounce from the second on where nothing shrinks, on
    every launch that tiles into blocks (of the schedule's lane count, if
    there is one; the name ends in "_resort"). fn.schedule holds the
    schedule (None when nothing compacts) and fn.compacted counts the
    launches that ran the compacting loop. trace_fns: the scene's
    (intersect_fn, occlude_fn) through the kernels, built already."""
    _check_choices(route, integrator, nee_mode)
    _check_options(integrator, nee_mode, use_nee, filter_table, audit)
    on_cuda = scene.device.type == "cuda"
    general_only = not use_nee or filter_table is not None or audit
    if route == "wave" and (integrator != "path" or general_only):
        raise ValueError("route 'wave' runs the path integrator with NEE, "
                         "no pixel filter and no audit")
    moves = integrator == "path" and not audit and max_depth > 1
    resort = resort and moves

    def shrink(isect_fn):
        if not moves or (schedule is None and compact_pilot is None):
            return None
        if schedule is not None:
            return tuple(schedule)
        return measured_schedule(scene, sampler, compact_pilot, isect_fn,
                                 max_depth, msaa, nee_mode)

    if (integrator == "path" and not general_only
            and (route == "wave" or (route == "auto" and on_cuda))):
        name, fused = _fused_integrator(scene, sampler, nee_mode,
                                        bvh_threshold, trace_fns,
                                        route == "wave")
        if fused is not None:
            # Only the wave integrator compacts (K2 and K3 do not).
            wave = isinstance(fused, fw.FusedWaveIntegrator)
            sched = shrink(fused.intersect_fn) if wave else None
            sort = resort and wave

            def fused_fn(pix, s):
                kw = {}
                if _compacts(sched, sort, pix):
                    fused_fn.compacted += 1
                    kw = {"schedule": sched, "resort": sort}
                return fused.render_samples(sampler, pix, s,
                                            max_depth=max_depth, msaa=msaa,
                                            **kw)
            return _tag(name, fused_fn, sched, sort)
    use_kernels = route == "general" or (route == "auto" and on_cuda)
    isect_fn, occl_fn = (
        trace_fns if use_kernels and trace_fns is not None
        else trace_dispatch.make_trace_fns(scene, use_kernels, bvh_threshold))
    if integrator != "path":
        return integrator, _direct_fn(scene, sampler, max_depth, msaa,
                                      integrator, isect_fn, occl_fn)
    name = "general" if use_kernels else "plain"
    if nee_mode == "folded":
        name += "_folded"
    sched = shrink(isect_fn)

    def general_fn(pix, s):
        use = _compacts(sched, resort, pix)
        general_fn.compacted += int(use)
        return wavefront.render_samples(scene, sampler, pix, s, isect_fn,
                                        occl_fn, max_depth=max_depth,
                                        msaa=msaa, nee_mode=nee_mode,
                                        use_nee=use_nee,
                                        filter_table=filter_table,
                                        audit=audit,
                                        shrink_schedule=sched if use
                                        else None, resort=resort and use)
    return _tag(name, general_fn, sched, resort)


def measured_schedule(scene, sampler, pixel_idx, intersect_fn, max_depth,
                      msaa, nee_mode="twoarm"):
    """A pilot ``wavefront.measure_alive`` on the launch's lanes (sample 0;
    folded NEE counts the lanes that may owe a pending too), turned into
    per-bounce capacities by ``wavefront.auto_schedule``."""
    counts = wavefront.measure_alive(scene, sampler, pixel_idx, 0,
                                     intersect_fn, max_depth=max_depth,
                                     msaa=msaa, owed=nee_mode == "folded")
    return wavefront.auto_schedule(counts.cpu().tolist(),
                                   int(pixel_idx.shape[0]))


def _compacts(sched, resort, pix):
    """Whether a launch runs the compacting loop: a schedule measured at
    its lane count, or resort without a schedule, on a batch that tiles
    into blocks (else the masked loop runs)."""
    n = int(pix.shape[0])
    fits = n == sched[0] if sched is not None else resort
    return fits and n % wavefront.COMPACT_BLOCK == 0


def _tag(name, fn, sched, resort=False):
    fn.schedule = sched
    fn.compacted = 0
    return (name + ("_compact" if sched is not None else "")
            + ("_resort" if resort else "")), fn


def _tunes_on(dev) -> bool:
    """Whether route auto tunes on this device: on the card only, as the
    JAX package tunes on its device only (pbrs_tpu/render.py:134-140)."""
    return dev.type == "cuda"


def _tuned_kernel(tuned):
    """fn(pixel_idx, sample_idx) of a tuned render: the winner at the
    pilot's lane count, its masked twin for a launch of another count;
    fn.schedule and fn.compacted as make_integrator's."""
    tail = tuned.masked()
    pilot_n = tuned.lanes

    def fn(pix, s):
        out = (tuned if int(pix.shape[0]) == pilot_n else tail)(pix, s)
        fn.compacted = tuned.compacted + (tail.compacted if tail is not tuned
                                          else 0)
        return out
    fn.schedule = tuned.schedule
    fn.compacted = 0
    return fn


def _direct_fn(scene, sampler, max_depth, msaa, integrator, isect_fn,
               occl_fn):
    """fn(pixel_idx, sample_idx) -> (radiance, traced segments) of the
    direct integrator or a visualizer."""
    def fn(pix, s):
        traced = []

        def counted(trace):
            def run(rays):
                traced.append((rays.t_max > 0.0).sum())
                return trace(rays)
            return run

        rays = wavefront.camera_rays(scene, sampler, pix, s, msaa)
        if integrator == "direct":
            rad = direct_mod.direct_radiance(
                scene, rays, sampler, pix, s, depth=max_depth,
                intersect_fn=counted(isect_fn), occlude_fn=counted(occl_fn))
        elif integrator == "normals":
            rad = direct_mod.normal_visualizer(scene, rays, counted(isect_fn))
        else:
            rad = direct_mod.material_visualizer(scene, rays,
                                                 counted(isect_fn))
        return rad, torch.stack(traced).sum()
    return fn


def _check_choices(route, integrator="path", nee_mode="twoarm"):
    for what, got, allowed in (("route", route, ROUTES),
                               ("integrator", integrator, INTEGRATORS),
                               ("nee_mode", nee_mode, NEE_MODES)):
        if got not in allowed:
            raise ValueError(f"{what} must be one of {allowed}, got {got!r}")


def _check_options(integrator, nee_mode, use_nee, filter_table, audit):
    """The general path's options apply to the path integrator; folded NEE
    needs NEE."""
    if integrator != "path":
        for what, on in (("debug_checks", audit), ("use_nee=False",
                                                   not use_nee),
                         ("pixel_filter", filter_table is not None)):
            if on:
                raise ValueError(f"{what} applies to the path integrator "
                                 f"only, not {integrator!r}")
    if nee_mode == "folded" and not use_nee:
        raise ValueError("nee_mode='folded' needs use_nee=True")


def render_image(scene, spp: int = 4, max_depth: int = 5,
                 integrator: str = "path", seed: int = 0,
                 chunk_pixels: int | None = None, progress: bool = False,
                 device="cuda", route: str = "auto",
                 sampler_kind: str = "pcg", nee_mode: str = "auto",
                 film: Film | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 0, use_nee: bool = True,
                 pixel_filter: tuple | None = None,
                 debug_checks: bool = False, compact: bool | str = "auto",
                 profile_dir: str | None = None):
    """Render the scene camera view. Returns (image [H,W,3] np.float32,
    RenderStats). spp is rounded up to a square (msaa^2 strata). The
    render runs on the card unless `device` asks for another device
    ("cpu"); moving the scene to CUDA raises without one. integrator is
    "path", "direct", "normals" or "materials"; sampler_kind "pcg",
    "sobol" or "threefry"; nee_mode "auto", "twoarm" or "folded" (the
    path integrator's one-sample fold of the BSDF-sampled MIS arm).

    The tuner (tuner.py) picks route auto's path on the card: with
    compact or nee_mode "auto" (the defaults), route auto, the path
    integrator with NEE, no pixel filter, a PCG or Sobol' sampler and no
    debug_checks, ``tuner.tune`` times one launch of each candidate at the
    first chunk's lane count and keeps the fastest (a K2 / K3 scene takes
    its kernel unmeasured); an explicit compact or nee_mode limits it to
    the candidates that match, and with both explicit no tuner runs.
    stats.integrator names the winner as make_integrator does,
    stats.tuned holds the tuner's label. A candidate that fails raises.
    Otherwise "auto" means two-arm NEE and no compaction. On the CPU the
    tuner does not run: route auto is the general path.

    film: resume into this film from its samples_done. checkpoint_path:
    save the film there every `checkpoint_every` samples, at the end, and
    on SIGTERM (then raise KeyboardInterrupt). use_nee=False: the
    BSDF-only estimator. pixel_filter: (kind, radius), e.g.
    ("gaussian", 1.5), applied by filter importance sampling.
    debug_checks: count the invariant violations of each bounce into
    stats.audit (path integrator only). compact: True / "on" compacts the
    wave and general paths' launches to a measured schedule
    (stats.schedule); False / "off" does not; "auto" lets the tuner
    choose. profile_dir: write a torch.profiler Chrome trace of the
    sample loop there (``profiling.profiler_trace``)."""
    _check_choices(route, integrator,
                   "twoarm" if nee_mode == "auto" else nee_mode)
    if compact not in (True, False, "auto", "on", "off"):
        raise ValueError(f"compact must be True, False, 'auto', 'on' or "
                         f"'off', got {compact!r}")
    if compact != "auto":
        compact = compact in (True, "on")
    if sampler_kind not in SAMPLERS:
        raise ValueError(f"sampler_kind must be one of {sorted(SAMPLERS)}, "
                         f"got {sampler_kind!r}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_image: no CUDA device; pass device='cpu' "
                           "to render on the CPU")
    scene = scene.to(device)
    dev = scene.device
    cam = scene.camera
    w, h = cam.width, cam.height
    n = w * h
    msaa = max(1, int(np.ceil(np.sqrt(spp))))
    spp_total = msaa * msaa
    if film is None:
        film = Film(width=w, height=h)
    elif (film.width, film.height) != (w, h):
        raise ValueError(f"film is {film.width}x{film.height}, the camera "
                         f"{w}x{h}")
    sampler = SAMPLERS[sampler_kind](seed)
    table = (flt.filter_table(pixel_filter, dev) if pixel_filter is not None
             else None)
    chunk = min(n, chunk_pixels or (1 << 20))
    n_chunks = (n + chunk - 1) // chunk
    pad_n = n_chunks * chunk
    # Morton lane order: estimator-neutral (samples are keyed by pixel id).
    order = wavefront.morton_pixel_order(w, h)
    pixel_all = (np.concatenate([order, order[:pad_n - n]])
                 if pad_n > n else order)
    pix_dev = [torch.from_numpy(pixel_all[c * chunk:(c + 1) * chunk]).to(dev)
               for c in range(n_chunks)]
    tuned = None
    if (_tunes_on(dev) and (compact == "auto" or nee_mode == "auto")
            and route == "auto" and integrator == "path" and use_nee
            and pixel_filter is None and sampler_kind in ("pcg", "sobol")
            and not debug_checks):
        from . import tuner

        tuned = tuner.tune(scene, sampler, pix_dev[0], 0, depth=max_depth,
                           msaa=msaa, compact=compact, nee_mode=nee_mode,
                           verbose=progress)
        name, kernel = tuned.name, _tuned_kernel(tuned)
    else:
        name, kernel = make_integrator(
            scene, sampler, max_depth, msaa, route, integrator=integrator,
            nee_mode="twoarm" if nee_mode == "auto" else nee_mode,
            use_nee=use_nee, filter_table=table, audit=debug_checks,
            compact_pilot=pix_dev[0] if compact is True else None)

    stats = RenderStats(spp=spp_total, integrator=name,
                        schedule=getattr(kernel, "schedule", None),
                        tuned=tuned.label if tuned is not None else "")
    # The device sums start from the film's, so a resumed render adds its
    # samples in the same order as an uninterrupted one.
    accum = [torch.from_numpy(film.accum[pixel_all[c * chunk:
                                                   (c + 1) * chunk]]).to(dev)
             for c in range(n_chunks)]
    traced = torch.zeros((), dtype=torch.int64, device=dev)
    audit = aud_mod.zero_counts(dev) if debug_checks else None

    def flush():
        for c, acc in enumerate(accum):
            nv = min(chunk, n - c * chunk)  # pad lanes (duplicate ids) dropped
            film.accum[pixel_all[c * chunk:c * chunk + nv]] = \
                acc[:nv].cpu().numpy()

    stop = {"requested": False}
    prev_term = None
    if checkpoint_path:
        def on_term(signum, frame):
            stop["requested"] = True
        try:
            prev_term = signal.signal(signal.SIGTERM, on_term)
        except ValueError:
            prev_term = None  # not the main thread
    t0 = time.time()
    trace = contextlib.ExitStack()
    if profile_dir:
        trace.enter_context(profiling.profiler_trace(profile_dir))
    try:
        for s in range(film.samples_done, spp_total):
            # One sample index per launch: a chunk never exceeds the frame,
            # so the reference's multi-sample packing (chunk // n > 1) never
            # fires. Stage every chunk, then commit: an interrupt mid-sample
            # leaves (accum, samples_done) consistent. The pass span closes
            # before the commit, so whatever a commit starts or stops falls
            # between two passes.
            with profiling.span("pbrs.pass"):
                staged = [kernel(pix_dev[c], s) for c in range(n_chunks)]
                for c, out in enumerate(staged):
                    accum[c] = accum[c] + out[0]
                    traced = traced + out[1]
                    if debug_checks:
                        audit = audit + out[2]
                    stats.launches += 1
            film.samples_done = s + 1
            stats.camera_rays += n
            if progress:
                print(f"  sample {s + 1}/{spp_total}", flush=True)
            at_interval = checkpoint_every and (s + 1) % checkpoint_every == 0
            if checkpoint_path and (at_interval or stop["requested"]):
                flush()
                film.save(checkpoint_path)
            if stop["requested"]:
                raise KeyboardInterrupt  # preempted: the film is saved
    except KeyboardInterrupt:
        if checkpoint_path:
            flush()
            film.save(checkpoint_path)
        raise
    finally:
        trace.close()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    flush()
    if checkpoint_path:
        film.save(checkpoint_path)
    if debug_checks:
        stats.audit = aud_mod.report(audit)
    stats.traced_rays = int(traced)
    stats.compacted_launches = getattr(kernel, "compacted", 0)
    stats.wall_time = time.time() - t0
    return film.mean_image(), stats
