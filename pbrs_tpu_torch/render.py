"""Render loop: film accumulation over sample launches. Mirrors
pbrs_tpu/render.py (the tuner, checkpoint/resume, filters, profiling and
the direct integrator are not ported yet).

The pixel grid (in chunks of at most 2^20 pixels) renders one sample
index per launch, accumulating into a film. Which integrator runs:

- route "auto": on CUDA, the fused diffuse kernel (K2) when the scene is
  eligible, else the fused single-lobe kernel (K3) when that one is, else
  the wave path -- the shade kernel (K4) with the trace outside -- when
  that one is, else the general wavefront; both trace through the
  flat-bank kernel (K1) and, for every primitive family above the BVH
  threshold, the BVH kernel (K5), plus the scene's instance groups; on the
  CPU, the general wavefront with the broadcast sweep;
- route "general": the general wavefront through K1 and K5 (their plain
  versions on the CPU);
- route "plain": the general wavefront with the broadcast sweep, no kernel.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .accel import dispatch as trace_dispatch
from .accel import fused_kernel as fk
from .accel import fused_single_lobe as fsl
from .accel import fused_wave as fw
from .core import sampler as smp
from .integrators import wavefront

ROUTES = ("auto", "general", "plain")


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


def make_integrator(scene, sampler, max_depth: int, msaa: int,
                    route: str = "auto", bvh_threshold: int | None = None):
    """(name, fn): fn(pixel_idx, sample_idx) -> (radiance [N,3], traced-ray
    count). `scene` must already be on its device; bvh_threshold overrides
    the family size above which the general path traces a family with
    K5."""
    _check_route(route)
    on_cuda = scene.device.type == "cuda"
    fused = None
    if route == "auto" and on_cuda:
        if fk.scene_supports_fused(scene):
            name, fused = "fused", fk.FusedDiffuseIntegrator(scene)
        elif fsl.scene_supports_single_lobe(scene):
            name = "fused_single_lobe"
            fused = fsl.FusedSingleLobeIntegrator(scene)
        elif fw.scene_supports_wave(scene):
            name = "fused_wave"
            fused = fw.FusedWaveIntegrator(scene, bvh_threshold)
    if fused is not None:
        def fused_fn(pix, s):
            return fused.render_samples(sampler, pix, s, max_depth=max_depth,
                                        msaa=msaa)
        return name, fused_fn
    use_kernels = route == "general" or (route == "auto" and on_cuda)
    isect_fn, occl_fn = trace_dispatch.make_trace_fns(scene, use_kernels,
                                                      bvh_threshold)

    def general_fn(pix, s):
        return wavefront.render_samples(scene, sampler, pix, s, isect_fn,
                                        occl_fn, max_depth=max_depth,
                                        msaa=msaa)
    return ("general" if use_kernels else "plain"), general_fn


def _check_route(route):
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")


def render_image(scene, spp: int = 4, max_depth: int = 5,
                 integrator: str = "path", seed: int = 0,
                 chunk_pixels: int | None = None, progress: bool = False,
                 device="cuda", route: str = "auto"):
    """Render the scene camera view. Returns (image [H,W,3] np.float32,
    RenderStats). spp is rounded up to a square (msaa^2 strata). The
    render runs on the card unless `device` asks for another device
    ("cpu"); moving the scene to CUDA raises without one."""
    if integrator != "path":
        raise NotImplementedError(
            f"integrator {integrator!r} (pbrs_tpu.integrators.direct) is not "
            "ported to pbrs_tpu_torch yet")
    _check_route(route)
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
    film = Film(width=w, height=h)
    sampler = smp.PCGSampler(seed)
    name, kernel = make_integrator(scene, sampler, max_depth, msaa, route)

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
    accum = [None] * n_chunks
    traced = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.time()
    for s in range(spp_total):
        # One sample index per launch: a chunk never exceeds the frame, so
        # the reference's multi-sample packing (chunk // n > 1) never fires.
        for c in range(n_chunks):
            rad, cnt = kernel(pix_dev[c], s)
            accum[c] = rad if accum[c] is None else accum[c] + rad
            traced = traced + cnt
            stats.launches += 1
        film.samples_done = s + 1
        stats.camera_rays += n
        if progress:
            print(f"  sample {s + 1}/{spp_total}", flush=True)
    for c, acc in enumerate(accum):
        if acc is None:
            continue
        nv = min(chunk, n - c * chunk)  # pad lanes (duplicate ids) dropped
        film.accum[pixel_all[c * chunk:c * chunk + nv]] += \
            acc[:nv].cpu().numpy()
    stats.traced_rays = int(traced)
    stats.wall_time = time.time() - t0
    return film.mean_image(), stats
