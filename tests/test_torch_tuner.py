"""The port's tuner (pbrs_tpu_torch/tuner.py) against pbrs_tpu.tuner on the
CPU, on tests/test_tuner.py's 64x48 mesh_ball(levels=2) and a 48x48 crop
of everything: the candidate labels (pbrs_tpu's with "/onehot" dropped)
with compact and nee_mode at auto and pinned, the winner one time table
picks, the winner's radiance and ray count, the K2 / K3 shortcut, the
two-arm schedule, the decision cache, the refusal to fall back, and
render_image's use of the tuner.

Each package's ``_measure`` is patched with one recorder, which returns a
fixed time per label and lists the labels it was asked to time; the
winners' radiance runs for real. auto_schedule's floor of 16384 lanes
would keep every schedule of a frame this small at full width, so both
packages' auto_schedule take min_cap=16, quantum=16 here. pbrs_tpu's
folded pilot lags the live counts by a bounce where the port counts the
lanes owing a pending (ROADMAP.md, design differences): for the labels,
pbrs_tpu's tune is handed the port's folded schedule and, on mesh_ball,
its own two-arm one, which pbrs_tpu.tuner._auto_sched computes op by op
(``jax.disable_jit``); on everything it is handed the port's two-arm
schedule, which equals pbrs_tpu's on mesh_ball.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrs_tpu import tuner as jtuner
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import render, tuner
from pbrs_tpu_torch.accel import fused_wave as fw
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.integrators import wavefront as twf
from pbrs_tpu_torch.scene import buffers
from test_fused_single_lobe import _shrunk
from test_tuner import _small_scene
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ATOL, RTOL = 2e-5, 1e-4
MEASURE = tuner._measure
DEPTH, MSAA, SEED = 3, 2, 3


def _carry(jscene):
    return buffers.scene_from_arrays(buffers.scene_to_arrays(jscene))


def _port_label(label):
    return label.replace("/onehot", "")


class Recorder:
    """One stand-in for both packages' ``_measure``: a fixed time for each
    label (pbrs_tpu's read without "/onehot"), from `table` or else from
    the label's hash, and the labels it was asked to time."""

    def __init__(self, table=None):
        self.table = dict(table or {})
        self.asked = []

    def time_of(self, label):
        if label in self.table:
            return self.table[label]
        return 1.0 + int(hashlib.sha1(label.encode()).hexdigest()[:6],
                         16) / 2 ** 24

    def __call__(self, step, lanes, sample_ids, reps=2):
        label = _port_label(step.label)
        self.asked.append(label)
        return self.time_of(label)


@pytest.fixture(scope="module", autouse=True)
def small_schedules():
    auto = (jwf.auto_schedule, twf.auto_schedule)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PBRS_TUNER_NOCACHE", "1")
        mp.setattr(jwf, "auto_schedule", lambda c, n: auto[0](
            c, n, min_cap=16, quantum=16))
        mp.setattr(twf, "auto_schedule", lambda c, n: auto[1](
            c, n, min_cap=16, quantum=16))
        yield


@pytest.fixture(scope="module")
def scenes():
    """{name: (pbrs_tpu scene, the port's carried copy, the two-arm
    schedule pbrs_tpu's labels take, the port's folded one, the port's
    two-arm one)}."""
    out = {}
    for name, jscene in (("mesh_ball", _small_scene()),
                         ("everything", _shrunk(jpresets.everything(), 48))):
        tscene = _carry(jscene)
        n = jscene.camera.width * jscene.camera.height
        isect = render.trace_dispatch.make_trace_fns(tscene, True)[0]
        port = [tuner._auto_sched(tscene, tsmp.PCGSampler(SEED), _pix(n),
                                  DEPTH, MSAA, isect, mode)
                for mode in ("twoarm", "folded")]
        sched = port[0]
        if name == "mesh_ball":
            with jax.disable_jit():
                sched = jtuner._auto_sched(
                    jscene, jsmp.PCGSampler(SEED),
                    jnp.arange(n, dtype=jnp.int32), jnp.zeros(n, jnp.int32),
                    DEPTH, MSAA, None)
        out[name] = (jscene, tscene, sched, port[1], port[0])
    return out


@pytest.fixture(scope="module")
def general_ref(scenes):
    """pbrs_tpu's general/onehot winner on mesh_ball (its masked general
    path, run op by op as the pilot's schedule was): (radiance, ray
    count)."""
    jscene = scenes["mesh_ball"][0]
    n = jscene.camera.width * jscene.camera.height
    with jax.disable_jit():
        rad, cnt = jwf.render_samples(
            jscene, jsmp.PCGSampler(SEED), jnp.arange(n, dtype=jnp.int32),
            jnp.zeros(n, jnp.int32), max_depth=DEPTH, msaa=MSAA,
            return_ray_count=True)
    return np.asarray(rad), int(cnt)


def _pix(n):
    return torch.arange(n, dtype=torch.int32)


def _tune(tscene, rec, monkeypatch, **kw):
    monkeypatch.setattr(tuner, "_measure", rec)
    n = tscene.camera.width * tscene.camera.height
    return tuner.tune(tscene, tsmp.PCGSampler(SEED), _pix(n), 0, depth=DEPTH,
                      msaa=MSAA, **kw)


def _jax_tune(entry, rec, monkeypatch, compact="auto"):
    jscene, _, sched, folded_sched, _ = entry
    monkeypatch.setattr(jtuner, "_measure", rec)
    monkeypatch.setattr(jtuner, "_auto_sched",
                        lambda *a, folded=False: (folded_sched if folded
                                                    else sched))
    n = jscene.camera.width * jscene.camera.height
    return jtuner.tune(jscene, jsmp.PCGSampler(SEED),
                       jnp.arange(n, dtype=jnp.int32),
                       jnp.zeros(n, jnp.int32), depth=DEPTH, msaa=MSAA,
                       compact=compact)


def _nee_of(label):
    return "folded" if label.split("/")[0].endswith("-folded") else "twoarm"


CASES = ([("mesh_ball", c, m) for c in ("auto", False, True)
          for m in ("auto", "twoarm", "folded")]
         + [("everything", "auto", "auto"), ("everything", False, "folded"),
            ("everything", True, "twoarm")])


@pytest.mark.parametrize("name,compact,nee_mode", CASES)
def test_labels_and_winner_match_reference(scenes, monkeypatch, name,
                                           compact, nee_mode):
    """The candidates the port times are pbrs_tpu's, in its order, with
    "/onehot" dropped (pbrs_tpu has no nee_mode argument: its labels are
    filtered to the pinned structure), and one time table picks the same
    winner in both."""
    entry = scenes[name]
    rec_t, rec_j = Recorder(), Recorder()
    got = _tune(entry[1], rec_t, monkeypatch, compact=compact,
                nee_mode=nee_mode)
    want = _jax_tune(entry, rec_j, monkeypatch, compact=compact)
    want_labels = [lb for lb in rec_j.asked
                   if nee_mode == "auto" or _nee_of(lb) == nee_mode]
    assert rec_t.asked == want_labels
    assert len(rec_t.asked) > 1
    if nee_mode == "auto":
        assert got.label == _port_label(want.label)
    else:
        assert got.label == min(want_labels, key=rec_j.time_of)
    assert got.measured == len(rec_t.asked)
    assert set(got.times) == set(rec_t.asked)
    if name == "everything" and compact is not True:
        assert any(lb.endswith("/resort") for lb in rec_t.asked)


def test_two_arm_schedule_matches_reference(scenes):
    """The port's pilot schedule (render.measured_schedule) on the two-arm
    structure equals pbrs_tpu.tuner._auto_sched's, and shrinks; the folded
    one counts at least the two-arm lanes."""
    _, tscene, sched, folded, got = scenes["mesh_ball"]
    n = tscene.camera.width * tscene.camera.height
    assert got == tuple(sched) and min(got) < n
    assert folded is None or all(f >= t for f, t in zip(folded, got))


@pytest.mark.parametrize("label,name", [("general", "general"),
                                        ("wave", "fused_wave")])
def test_winner_radiance(scenes, general_ref, monkeypatch, label, name):
    """The winner renders as pbrs_tpu's general/onehot winner (its masked
    general path) lane for lane, with an equal ray count: a general winner,
    and a wave winner (K4's plain version on the CPU), held to pbrs_tpu's
    general path as tests/test_torch_wave.py holds the wave path (pbrs_tpu's
    wave candidate does not run compiled on the CPU). pbrs_tpu's tune picks
    the same label from the same table."""
    entry = scenes["mesh_ball"]
    tscene = entry[1]
    table = {label: 0.5}
    got = _tune(tscene, Recorder(table), monkeypatch)
    want = _jax_tune(entry, Recorder(table), monkeypatch)
    assert (got.label, got.name) == (label, name)
    assert _port_label(want.label) == label
    n = tscene.camera.width * tscene.camera.height
    rad, cnt = got(_pix(n), 0)
    assert np.isfinite(rad.numpy()).all() and float(rad.sum()) > 0
    np.testing.assert_allclose(rad.numpy(), general_ref[0], atol=ATOL,
                               rtol=RTOL)
    assert int(cnt) == general_ref[1]


def test_compacted_winner_and_tail(scenes, monkeypatch):
    """A compacted general winner runs pbrs_tpu's two-arm schedule and
    equals the masked general path bit for bit (the compacting loop is
    held to pbrs_tpu's in tests/test_torch_compaction.py); its masked twin
    renders a tail chunk of another lane count as the masked path."""
    entry = scenes["mesh_ball"]
    tscene = entry[1]
    table = {"general/compact": 0.5}
    got = _tune(tscene, Recorder(table), monkeypatch)
    want = _jax_tune(entry, Recorder(table), monkeypatch)
    assert (got.label, got.name) == ("general/compact", "general_compact")
    assert want.label == "general/onehot/compact"
    assert got.schedule == tuple(want.schedule)
    n = tscene.camera.width * tscene.camera.height
    _, plain = render.make_integrator(tscene, tsmp.PCGSampler(SEED), DEPTH,
                                      MSAA, "general")
    rad, cnt = got(_pix(n), 0)
    rad_m, cnt_m = plain(_pix(n), 0)
    assert torch.equal(rad, rad_m) and int(cnt) == int(cnt_m)
    assert got.compacted == 1
    tail = got.masked()
    assert tail.schedule is None and tail.label.endswith("/masked-tail")
    part = _pix(n)[: n // 2 - 4]
    assert torch.equal(tail(part, 0)[0], plain(part, 0)[0])
    assert tail.compacted == 0


@pytest.mark.parametrize("name,label", [("cornell_box", "fused_diffuse"),
                                        ("plates", "fused_single_lobe")])
def test_fused_shortcut(monkeypatch, name, label):
    """K2 / K3 scenes take their kernel unmeasured in both packages; a
    pinned folded NEE (no K2 / K3 folded mode) times the folded
    candidates instead."""
    jscene = _shrunk(jpresets.PRESETS[name](), 16)
    tscene = _carry(jscene)
    rec_t, rec_j = Recorder(), Recorder()
    got = _tune(tscene, rec_t, monkeypatch)
    monkeypatch.setattr(jtuner, "_measure", rec_j)
    want = jtuner.tune(jscene, jsmp.PCGSampler(SEED),
                       jnp.arange(256, dtype=jnp.int32),
                       jnp.zeros(256, jnp.int32), depth=DEPTH, msaa=MSAA)
    assert got.label == want.label == label
    assert rec_t.asked == rec_j.asked == [] and got.measured == 0
    folded = _tune(tscene, rec_t, monkeypatch, nee_mode="folded",
                   compact=False)
    assert folded.nee_mode == "folded" and rec_t.asked
    assert all(_nee_of(lb) == "folded" for lb in rec_t.asked)


def test_fingerprint_matches_reference(scenes):
    for jscene, tscene, *_ in scenes.values():
        assert (tuner._scene_fingerprint(tscene)
                == jtuner._scene_fingerprint(jscene))


def test_cache_hit_resume_and_key(scenes, monkeypatch, tmp_path):
    """A second tune is a cache hit with no measurement; another depth is
    not; a partial record resumes, timing only the labels it lacks."""
    tscene = scenes["mesh_ball"][1]
    monkeypatch.delenv("PBRS_TUNER_NOCACHE")
    monkeypatch.setenv("PBRS_TUNER_CACHE", str(tmp_path))
    first = Recorder({"wave/compact": 0.5})
    got = _tune(tscene, first, monkeypatch)
    assert got.label == "wave/compact" and got.measured == len(first.asked)
    again = Recorder()
    hit = _tune(tscene, again, monkeypatch)
    assert again.asked == [] and hit.cache_hit and hit.measured == 0
    assert (hit.label, hit.name, hit.schedule) == (got.label, got.name,
                                                   got.schedule)
    assert hit.times == got.times
    other = Recorder()
    monkeypatch.setattr(tuner, "_measure", other)
    n = tscene.camera.width * tscene.camera.height
    tuner.tune(tscene, tsmp.PCGSampler(SEED), _pix(n), 0, depth=DEPTH + 1,
               msaa=MSAA)
    assert other.asked

    done = first.asked[:3]
    key = tuner._cache_key(tscene, tsmp.PCGSampler(SEED), n, DEPTH, MSAA,
                           "auto", "auto")
    tuner._cache_store(key, {"partial": {lb: first.time_of(lb)
                                         for lb in done}})
    resumed = Recorder({"wave/compact": 0.5})
    best = _tune(tscene, resumed, monkeypatch)
    assert resumed.asked == first.asked[3:]
    assert best.label == "wave/compact" and best.measured == len(
        first.asked) - 3
    assert set(best.times) == set(first.asked)
    assert tuner._cache_load(key)["label"] == "wave/compact"


def test_no_fallback(scenes, monkeypatch):
    """A candidate that raises propagates out of tune with its label; a
    candidate whose radiance is not finite raises (the real _measure on
    the CPU)."""
    tscene = scenes["mesh_ball"][1]

    def failing(step, lanes, sample_ids, reps=2):
        if step.label == "wave":
            raise RuntimeError("launch failed")
        return 1.0

    with pytest.raises(tuner.CandidateError, match="wave failed"):
        _tune(tscene, failing, monkeypatch, compact=False)
    monkeypatch.setattr(fw.FusedWaveIntegrator, "render_samples",
                        lambda self, sampler, pix, *a, **k: (
                            torch.full((pix.shape[0], 3), float("nan")),
                            torch.zeros((), dtype=torch.int64)))
    monkeypatch.setattr(tuner, "_measure", MEASURE)
    n = tscene.camera.width * tscene.camera.height
    with pytest.raises(tuner.CandidateError, match="wave") as err:
        tuner.tune(tscene, tsmp.PCGSampler(SEED), _pix(n)[:256], 0, depth=2,
                   msaa=1, compact=False, nee_mode="twoarm")
    assert isinstance(err.value.__cause__, FloatingPointError)


def test_env_overrides(scenes, monkeypatch):
    """PBRS_COMPACT pins compact as in pbrs_tpu; PBRS_TRACE_MODE may name
    only the one tracer pair."""
    tscene = scenes["mesh_ball"][1]
    monkeypatch.setenv("PBRS_COMPACT", "0")
    rec = Recorder()
    _tune(tscene, rec, monkeypatch)
    assert rec.asked and not any("/compact" in lb for lb in rec.asked)
    monkeypatch.setenv("PBRS_TRACE_MODE", "onehot")
    _tune(tscene, Recorder(), monkeypatch, compact=False)
    monkeypatch.setenv("PBRS_TRACE_MODE", "rowdense")
    with pytest.raises(ValueError, match="rowdense"):
        _tune(tscene, Recorder(), monkeypatch)


def test_render_image_tunes(scenes, monkeypatch):
    """render_image with the tuner on (on the card only: forced here):
    stats name the winner, the image equals the pinned route's bit for
    bit; an explicit compact limits the candidates, both pins skip the
    tuner, and a non-finite candidate raises out of render_image."""
    tscene = scenes["mesh_ball"][1]
    monkeypatch.setattr(render, "_tunes_on", lambda dev: True)
    rec = Recorder({"wave": 0.5})
    monkeypatch.setattr(tuner, "_measure", rec)
    kw = dict(spp=1, max_depth=DEPTH, device="cpu", seed=SEED)
    img, stats = render.render_image(tscene, **kw)
    assert (stats.integrator, stats.tuned) == ("fused_wave", "wave")
    assert len(rec.asked) == 6
    pinned, st_p = render.render_image(tscene, route="wave", compact=False,
                                       nee_mode="twoarm", **kw)
    assert st_p.integrator == "fused_wave" and st_p.tuned == ""
    assert len(rec.asked) == 6
    np.testing.assert_array_equal(img, pinned)
    rec.asked.clear()
    _, st_c = render.render_image(tscene, compact=True, **kw)
    assert rec.asked and all("/compact" in lb or "folded" in lb
                             for lb in rec.asked)
    assert st_c.tuned in rec.asked
    monkeypatch.setattr(tuner, "_measure", MEASURE)
    monkeypatch.setattr(fw.FusedWaveIntegrator, "render_samples",
                        lambda self, sampler, pix, *a, **k: (
                            torch.full((pix.shape[0], 3), float("nan")),
                            torch.zeros((), dtype=torch.int64)))
    with pytest.raises(tuner.CandidateError):
        render.render_image(tscene, compact=False, spp=1, max_depth=2,
                            device="cpu")
