"""Render loop: film accumulation over sample launches, checkpoint/resume.
Mirrors pbrs_tpu/render.py (the tuner, compaction and profiling are not
ported yet).

The pixel grid (in chunks of at most 2^20 pixels) renders one sample
index per launch, accumulating into a film. The sampler is PCG, Sobol' or
threefry (`sampler_kind`). Which path integrator runs:

- route "auto": on CUDA, with a PCG or Sobol' sampler and two-arm NEE, the
  fused diffuse kernel (K2) when the scene is eligible, else the fused
  single-lobe kernel (K3) when that one is, else the wave path -- the
  shade kernel (K4) with the trace outside -- when that one is, else the
  general wavefront; with folded NEE (`nee_mode="folded"`) the folded wave
  path (K4 folded) where the scene is eligible, else the folded general
  wavefront; a threefry sampler takes the general wavefront. Both trace
  through the flat-bank kernel (K1) and, for every primitive family above
  the BVH threshold, the BVH kernel (K5), plus the scene's instance
  groups. On the CPU, the general wavefront with the broadcast sweep;
- route "general": the general wavefront through K1 and K5 (their plain
  versions on the CPU);
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
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .accel import dispatch as trace_dispatch
from .accel import fused_kernel as fk
from .accel import fused_single_lobe as fsl
from .accel import fused_wave as fw
from .core import filters as flt
from .core import sampler as smp
from .integrators import debug_audit as aud_mod
from .integrators import direct as direct_mod
from .integrators import wavefront

ROUTES = ("auto", "general", "plain")
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


def _fused_integrator(scene, sampler, nee_mode, bvh_threshold):
    """(name, integrator) of route auto's fused path on CUDA, or (None,
    None) where the general wavefront runs: the fused kernels draw PCG and
    Sobol' only, and K2 / K3 have no folded mode."""
    try:
        fk.rng_kind(sampler)
    except TypeError:
        return None, None
    if nee_mode == "folded":
        if fw.scene_supports_wave_folded(scene):
            return "fused_wave_folded", fw.FusedWaveIntegrator(
                scene, bvh_threshold, folded=True)
        return None, None
    if fk.scene_supports_fused(scene):
        return "fused", fk.FusedDiffuseIntegrator(scene)
    if fsl.scene_supports_single_lobe(scene):
        return "fused_single_lobe", fsl.FusedSingleLobeIntegrator(scene)
    if fw.scene_supports_wave(scene):
        return "fused_wave", fw.FusedWaveIntegrator(scene, bvh_threshold)
    return None, None


def make_integrator(scene, sampler, max_depth: int, msaa: int,
                    route: str = "auto", bvh_threshold: int | None = None,
                    integrator: str = "path", nee_mode: str = "twoarm",
                    use_nee: bool = True, filter_table=None,
                    audit: bool = False):
    """(name, fn): fn(pixel_idx, sample_idx) -> (radiance [N,3], traced-ray
    count), and with audit=True a third result, the [K] debug_audit
    counts. `scene` must already be on its device; bvh_threshold overrides
    the family size above which the general path traces a family with
    K5. A direct or visualizer pass counts every segment it hands a
    tracer with a live extent. use_nee=False, a filter table or audit
    keep route auto on the general path."""
    _check_choices(route, integrator, nee_mode)
    _check_options(integrator, nee_mode, use_nee, filter_table, audit)
    on_cuda = scene.device.type == "cuda"
    general_only = not use_nee or filter_table is not None or audit
    if (integrator == "path" and route == "auto" and on_cuda
            and not general_only):
        name, fused = _fused_integrator(scene, sampler, nee_mode,
                                        bvh_threshold)
        if fused is not None:
            def fused_fn(pix, s):
                return fused.render_samples(sampler, pix, s,
                                            max_depth=max_depth, msaa=msaa)
            return name, fused_fn
    use_kernels = route == "general" or (route == "auto" and on_cuda)
    isect_fn, occl_fn = trace_dispatch.make_trace_fns(scene, use_kernels,
                                                      bvh_threshold)
    if integrator != "path":
        return integrator, _direct_fn(scene, sampler, max_depth, msaa,
                                      integrator, isect_fn, occl_fn)
    name = "general" if use_kernels else "plain"
    if nee_mode == "folded":
        name += "_folded"

    def general_fn(pix, s):
        return wavefront.render_samples(scene, sampler, pix, s, isect_fn,
                                        occl_fn, max_depth=max_depth,
                                        msaa=msaa, nee_mode=nee_mode,
                                        use_nee=use_nee,
                                        filter_table=filter_table,
                                        audit=audit)
    return name, general_fn


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
                 sampler_kind: str = "pcg", nee_mode: str = "twoarm",
                 film: Film | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 0, use_nee: bool = True,
                 pixel_filter: tuple | None = None,
                 debug_checks: bool = False):
    """Render the scene camera view. Returns (image [H,W,3] np.float32,
    RenderStats). spp is rounded up to a square (msaa^2 strata). The
    render runs on the card unless `device` asks for another device
    ("cpu"); moving the scene to CUDA raises without one. integrator is
    "path", "direct", "normals" or "materials"; sampler_kind "pcg",
    "sobol" or "threefry"; nee_mode "twoarm" or "folded" (the path
    integrator's one-sample fold of the BSDF-sampled MIS arm).

    film: resume into this film from its samples_done. checkpoint_path:
    save the film there every `checkpoint_every` samples, at the end, and
    on SIGTERM (then raise KeyboardInterrupt). use_nee=False: the
    BSDF-only estimator. pixel_filter: (kind, radius), e.g.
    ("gaussian", 1.5), applied by filter importance sampling.
    debug_checks: count the invariant violations of each bounce into
    stats.audit (path integrator only)."""
    _check_choices(route, integrator, nee_mode)
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
    name, kernel = make_integrator(scene, sampler, max_depth, msaa, route,
                                   integrator=integrator, nee_mode=nee_mode,
                                   use_nee=use_nee, filter_table=table,
                                   audit=debug_checks)

    chunk = min(n, chunk_pixels or (1 << 20))
    n_chunks = (n + chunk - 1) // chunk
    pad_n = n_chunks * chunk
    # Morton lane order: estimator-neutral (samples are keyed by pixel id).
    order = wavefront.morton_pixel_order(w, h)
    pixel_all = (np.concatenate([order, order[:pad_n - n]])
                 if pad_n > n else order)
    pix_dev = [torch.from_numpy(pixel_all[c * chunk:(c + 1) * chunk]).to(dev)
               for c in range(n_chunks)]

    stats = RenderStats(spp=spp_total, integrator=name)
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
    try:
        for s in range(film.samples_done, spp_total):
            # One sample index per launch: a chunk never exceeds the frame,
            # so the reference's multi-sample packing (chunk // n > 1) never
            # fires. Stage every chunk, then commit: an interrupt mid-sample
            # leaves (accum, samples_done) consistent.
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
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    flush()
    if checkpoint_path:
        film.save(checkpoint_path)
    if debug_checks:
        stats.audit = aud_mod.report(audit)
    stats.traced_rays = int(traced)
    stats.wall_time = time.time() - t0
    return film.mean_image(), stats
