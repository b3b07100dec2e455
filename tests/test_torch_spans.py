"""The port's recorder (pbrs_tpu_torch/profiling.py) on the CPU at 8^2:
spans change no film and are absent with the recorder off; with it on
under a CPU torch.profiler, each pass holds its camera rays and its
bounces, and the tracers' spans sit inside the bounces; the lane counter
equals a direct count of each bounce's alive lanes on every host loop.
``pbrs.all_reduce`` is checked inside test_torch_parallel.py's ranks."""

import json

import numpy as np
import pytest
import torch

from pbrs_tpu_torch import profiling, render
from pbrs_tpu_torch.accel import fused_kernel as fk
from pbrs_tpu_torch.accel import fused_single_lobe as fsl
from pbrs_tpu_torch.accel import fused_wave as fw
from pbrs_tpu_torch.cli import with_resolution
from pbrs_tpu_torch.core import sampler as smp
from pbrs_tpu_torch.integrators import wavefront
from pbrs_tpu_torch.scene import presets
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

SIZE, DEPTH, SPP = 8, 3, 4


@pytest.fixture(scope="module")
def scenes():
    return {name: with_resolution(presets.PRESETS[name](), SIZE, SIZE)
            for name in ("cornell_box", "plates")}


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.recording(False)
    yield
    profiling.recording(False)


def _traced(fn, on, path):
    """fn() under a CPU torch.profiler with the recorder `on`: (its
    result, the pbrs.* events of its Chrome trace as (name, start, end))."""
    profiling.recording(on)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    profiling.recording(False)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X"
                 and str(e.get("name")).startswith("pbrs.")]


def _inside(child, parents):
    return [p for p in parents
            if p[1] <= child[1] and child[2] <= p[2]]


@pytest.mark.parametrize("route", ["general", "wave"])
def test_spans_nest_and_change_no_film(scenes, route, tmp_path):
    """Off: no pbrs.* event. On: the same image bit for bit, SPP passes,
    each holding one camera_rays span and DEPTH bounces, and every trace
    and occlude span inside a bounce."""
    def run():
        return render.render_image(scenes["cornell_box"], spp=SPP,
                                   max_depth=DEPTH, device="cpu", route=route)

    (img_off, _), off = _traced(run, False, tmp_path / "off.json")
    (img_on, stats), on = _traced(run, True, tmp_path / "on.json")
    assert off == []
    np.testing.assert_array_equal(img_on, img_off)
    by = {}
    for s in on:
        by.setdefault(s[0], []).append(s)
    passes = by["pbrs.pass"]
    assert len(passes) == SPP == stats.spp
    for p in passes:
        assert len([c for c in by["pbrs.camera_rays"]
                    if _inside(c, [p])]) == 1
        assert len([b for b in by["pbrs.bounce"] if _inside(b, [p])]) == DEPTH
    assert len(by["pbrs.bounce"]) == SPP * DEPTH
    assert by["pbrs.trace"] and by["pbrs.occlude"]
    for s in by["pbrs.trace"] + by["pbrs.occlude"]:
        assert len(_inside(s, by["pbrs.bounce"])) == 1


def _general(scene):
    return render.make_integrator(scene, smp.PCGSampler(3), DEPTH, 2,
                                  "general")[1]


def _fused(cls):
    def make(scene):
        integ = cls(scene)
        return lambda pix, s: integ.render_samples(smp.PCGSampler(3), pix, s,
                                                   max_depth=DEPTH)
    return make


# Each host loop, the scene it renders, and where its bounce reads the
# lanes alive as it begins: (module, function, the alive argument).
LOOPS = {
    "general": ("cornell_box", _general, (wavefront, "_bounce", 8)),
    "fused_diffuse": ("cornell_box", _fused(fk.FusedDiffuseIntegrator),
                      (fk, "bounce", 2)),
    "fused_single_lobe": ("plates", _fused(fsl.FusedSingleLobeIntegrator),
                          (fsl, "bounce2", 2)),
    "fused_wave": ("cornell_box", _fused(fw.FusedWaveIntegrator),
                   (fw, "shade", None)),
}


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_lane_counter_counts_alive_lanes(scenes, monkeypatch, loop):
    """counters() after two sample indices equals the alive lanes each
    bounce's launch was handed, counted from its arguments, over DEPTH
    launches of SIZE^2 lanes a sample."""
    name, make, (mod, attr, pos) = LOOPS[loop]
    fn = make(scenes[name])
    real = getattr(mod, attr)
    seen = []

    def spy(*args, **kw):
        alive = args[2][2] if pos is None else args[pos]  # K4: iin row 2
        seen.append(int((alive != 0).sum()))
        return real(*args, **kw)

    monkeypatch.setattr(mod, attr, spy)
    pix = torch.arange(SIZE * SIZE, dtype=torch.int32)
    profiling.recording(True)
    for s in range(2):
        fn(pix, s)
    got = profiling.counters()
    profiling.recording(False)
    assert len(seen) == 2 * DEPTH
    assert got == {"live": sum(seen), "launched": 2 * DEPTH * SIZE * SIZE}
    assert 0 < got["live"] < got["launched"]


def test_recorder_off_is_one_shared_context():
    assert profiling.span("pbrs.pass") is profiling.span("pbrs.bounce")
    profiling.count_lanes(torch.ones(4), 4)
    profiling.recording(True)
    assert profiling.counters() == {"live": 0, "launched": 0}
    assert profiling.span("pbrs.pass") is not profiling.span("pbrs.pass")
