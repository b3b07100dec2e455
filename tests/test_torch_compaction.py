"""Block compaction of the wavefront in the port: ``auto_schedule``,
``measure_alive`` and ``block_compact`` against pbrs_tpu's on the same
inputs, the compacting general loop (two-arm and folded) per lane against
pbrs_tpu's compacting loop and the port's masked loop with equal
traced-segment counts, the path_radiance gating (audit, a schedule that
shrinks nothing, a batch that does not tile), the compacted wave loop
against the masked one (mesh_ball, and
fourier_plastic under the Fourier override), the sort-only resort pass
against the masked loops bit for bit and against pbrs_tpu's resort
(tests/test_compaction.py:133-186), render_image(compact=) and
--compact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import dispatch as jdispatch
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.geometry import ray as jray
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import cli, render
from pbrs_tpu_torch.accel import dispatch
from pbrs_tpu_torch.accel import fused_wave as fw
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.geometry import ray as tray
from pbrs_tpu_torch.integrators import wavefront as twf
from pbrs_tpu_torch.scene import buffers
from test_fused_single_lobe import _shrunk
from test_fused_wave import _center_pix
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ATOL, RTOL = 2e-5, 1e-4
SIZE, DEPTH, SEED = 24, 5, 7


def _carry(jscene):
    return buffers.scene_from_arrays(buffers.scene_to_arrays(jscene))


@pytest.mark.parametrize("counts,n,kw", [
    ([1000.0, 100.0, 10.0, 1.0], 1024, {"min_cap": 16}),
    ([3072, 2900, 1200, 300, 8], 3072, {"min_cap": 256}),
    ([576, 400, 96, 40, 0], 576, {"min_cap": 16, "quantum": 16}),
    ([1 << 20, 900000, 120000, 60000, 9000], 1 << 20, {}),
    ([486400, 310000, 150000, 70000, 30000], 486400, {"margin": 2.0}),
])
def test_auto_schedule_matches_reference(counts, n, kw):
    assert twf.auto_schedule(counts, n, **kw) == jwf.auto_schedule(
        counts, n, **kw)


@pytest.fixture(scope="module")
def mesh():
    """(pbrs_tpu's mesh_ball (levels 2) at 24^2, the port's carried copy,
    both packages' plain trace functions)."""
    jscene = _shrunk(jpresets.mesh_ball(levels=2), SIZE)
    tscene = _carry(jscene)
    return (jscene, tscene,
            jdispatch.make_trace_fns(jscene, use_pallas=False),
            dispatch.make_trace_fns(tscene, False))


def _pix(n):
    return np.arange(n, dtype=np.int32)


def test_measure_alive_matches_reference(mesh):
    jscene, tscene, (ji, _), (ti, _) = mesh
    n = SIZE * SIZE
    want = jwf.measure_alive(jscene, jsmp.PCGSampler(SEED),
                             jnp.asarray(_pix(n)), jnp.zeros(n, jnp.int32),
                             max_depth=DEPTH, msaa=2, intersect_fn=ji)
    got = twf.measure_alive(tscene, tsmp.PCGSampler(SEED),
                            torch.from_numpy(_pix(n)), 0, ti,
                            max_depth=DEPTH, msaa=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == n and got[-1] < n
    # Folded: also the blocks whose lanes may owe a pending (alive after
    # the previous hit), a superset of the live ones.
    owed = twf.measure_alive(tscene, tsmp.PCGSampler(SEED),
                             torch.from_numpy(_pix(n)), 0, ti,
                             max_depth=DEPTH, msaa=2, owed=True)
    assert owed[0] == n and bool((owed >= got).all())
    assert bool((owed > got).any())


def _state(rng, n, pend):
    """A random lane state: blocks 3 in 8 dead, a few dead lanes owing a
    pending, finite rays."""
    alive = rng.random(n) < 0.6
    alive &= np.repeat(rng.random(n // 8) < 0.625, 8)
    st = dict(origin=rng.normal(size=(n, 3)).astype(np.float32),
              dir=rng.normal(size=(n, 3)).astype(np.float32),
              t_max=np.where(alive, np.inf, 0.0).astype(np.float32),
              beta=rng.random((n, 3), dtype=np.float32),
              pix=rng.integers(0, 1 << 20, n).astype(np.int32),
              sid=rng.integers(0, 16, n).astype(np.int32),
              orig=rng.permutation(n).astype(np.int32),
              specular=rng.random(n) < 0.3, alive=alive,
              u_c=rng.random(n, dtype=np.float32))
    if pend:
        owes = ~alive & (rng.random(n) < 0.2)
        st["pend"] = dict(
            coeff=rng.random((n, 3), dtype=np.float32),
            t_light=np.where(owes, rng.random(n) + 0.5, 0.0).astype(
                np.float32),
            is_env=owes & (rng.random(n) < 0.3))
    return st


def _compact(mod, ray_mod, conv, st, cap):
    pend = st.get("pend")
    if pend is not None:
        pend = {k: conv(v) for k, v in pend.items()}
    rays = ray_mod.RayBatch(origin=conv(st["origin"]), dir=conv(st["dir"]),
                            t_max=conv(st["t_max"]))
    out = mod.block_compact(rays, conv(st["beta"]), conv(st["pix"]),
                            conv(st["sid"]), conv(st["orig"]),
                            conv(st["specular"]), conv(st["alive"]), cap,
                            conv(st["u_c"]), pend=pend)
    rays, *rest, pend = out
    planes = [rays.origin, rays.dir, rays.t_max, *rest]
    if st.get("pend") is not None:
        planes += [pend["coeff"], pend["t_light"], pend["is_env"]]
    return [np.asarray(p) if not isinstance(p, torch.Tensor) else p.numpy()
            for p in planes]


@pytest.mark.parametrize("pend", [False, True])
@pytest.mark.parametrize("cap", [512, 256, 96, 8])
def test_block_compact_matches_reference(pend, cap):
    """State for state, bit for bit: a sort alone (cap = the batch), a fit
    (every needed block kept, p = 1) and two overflows (capacity roulette,
    p < 1, beta and pending scaled; one block kept)."""
    st = _state(np.random.default_rng(cap + 2 * pend), 512, pend)
    want = _compact(jwf, jray, jnp.asarray, st, cap)
    got = _compact(twf, tray, torch.from_numpy, st, cap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _schedule(tscene, ti, n, nee_mode):
    counts = twf.measure_alive(tscene, tsmp.PCGSampler(SEED),
                               torch.from_numpy(_pix(n)), 0, ti,
                               max_depth=DEPTH, msaa=2,
                               owed=nee_mode == "folded")
    sched = twf.auto_schedule(counts.tolist(), n, min_cap=16, quantum=16)
    assert sched[0] == n and min(sched) < n // 2, sched
    return sched


@pytest.mark.parametrize("nee_mode", ["twoarm", "folded"])
def test_compacted_general_path(mesh, nee_mode):
    """The port's compacting loop against pbrs_tpu's (run op by op, on the
    port's measured schedule) per lane, and against the port's masked loop
    bit for bit, with equal traced-segment counts."""
    jscene, tscene, (ji, jo), (ti, to) = mesh
    n = SIZE * SIZE
    sched = _schedule(tscene, ti, n, nee_mode)
    sampler = tsmp.PCGSampler(SEED)
    masked, cnt_m = twf.render_samples(tscene, sampler,
                                       torch.from_numpy(_pix(n)), 0, ti, to,
                                       max_depth=DEPTH, nee_mode=nee_mode)
    assert masked.sum() > 0
    got, cnt = twf.render_samples(
        tscene, sampler, torch.from_numpy(_pix(n)), 0, ti, to,
        max_depth=DEPTH, nee_mode=nee_mode, shrink_schedule=sched)
    np.testing.assert_array_equal(got.numpy(), masked.numpy())
    assert int(cnt) == int(cnt_m)
    want, cnt_j = jwf.render_samples(
        jscene, jsmp.PCGSampler(SEED), jnp.asarray(_pix(n)),
        jnp.zeros(n, jnp.int32), max_depth=DEPTH, msaa=2, intersect_fn=ji,
        occlude_fn=jo, return_ray_count=True, shrink_schedule=sched,
        nee_mode=nee_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert int(cnt) == int(cnt_j)


def test_path_radiance_gating(mesh, monkeypatch):
    """audit runs the masked loop whatever the schedule; a schedule that
    never drops below the batch compacts nothing; one that shrinks
    compacts only where a capacity falls below the lanes in hand; a batch
    that does not tile into blocks is refused a schedule."""
    _, tscene, _, (ti, to) = mesh
    sampler = tsmp.PCGSampler(SEED)
    calls = []
    compact = twf.block_compact

    def spy(rays, *a, **k):
        calls.append((rays.n, a[6]))
        return compact(rays, *a, **k)

    monkeypatch.setattr(twf, "block_compact", spy)

    def run(n, **kw):
        out = twf.render_samples(tscene, sampler, torch.from_numpy(_pix(n)),
                                 0, ti, to, max_depth=3, **kw)
        return out[0].numpy()

    n = SIZE * SIZE
    masked = run(n)
    np.testing.assert_array_equal(run(n, shrink_schedule=(n,) * 3), masked)
    np.testing.assert_array_equal(
        run(n, audit=True, shrink_schedule=(n, 64, 64)), masked)
    assert calls == []
    run(n, shrink_schedule=(n, n - 60, n - 60))
    assert calls == [(n, n - 64)]
    with pytest.raises(AssertionError, match="blocks"):
        run(n - 3, shrink_schedule=(n - 3, 64, 64))


@pytest.mark.parametrize("name", ["mesh_ball", "fourier_plastic"])
def test_compacted_wave_loop(mesh, name):
    """The wave loop compacted to a schedule against the masked one on the
    same scene (K4's plain version; fourier_plastic through the Fourier
    override): bit for bit, equal traced-segment counts, on a measured
    schedule that shrinks."""
    if name == "mesh_ball":
        tscene, n = mesh[1], SIZE * SIZE
        pix = torch.from_numpy(_pix(n))
    else:
        tscene = _carry(jpresets.fourier_plastic())
        pix = torch.from_numpy(np.asarray(_center_pix(tscene, 16),
                                          np.int32))
        n = 256
    integ = fw.FusedWaveIntegrator(tscene)
    sampler = tsmp.PCGSampler(SEED)
    counts = twf.measure_alive(tscene, sampler, pix, 0, integ.intersect_fn,
                               max_depth=DEPTH, msaa=2)
    sched = twf.auto_schedule(counts.tolist(), n, min_cap=16, quantum=16)
    assert min(sched) < n, sched
    want, cnt_m = integ.render_samples(sampler, pix, 0, max_depth=DEPTH)
    got, cnt = integ.render_samples(sampler, pix, 0, max_depth=DEPTH,
                                    schedule=sched)
    assert want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(cnt) == int(cnt_m)


def _spy_compact(monkeypatch):
    """[(lanes in, capacity, whether the kept blocks were reordered)] of
    every block_compact call."""
    calls = []
    compact = twf.block_compact

    def spy(rays, *a, **k):
        out = compact(rays, *a, **k)
        orig = out[4].view(-1, twf.COMPACT_BLOCK)[:, 0]
        calls.append((rays.n, a[6], bool((orig[1:] < orig[:-1]).any())))
        return out

    monkeypatch.setattr(twf, "block_compact", spy)
    return calls


@pytest.mark.parametrize("nee_mode", ["twoarm", "folded"])
def test_resort_general_path(mesh, monkeypatch, nee_mode):
    """Resort (a sort-only pass at each bounce from the second on, every
    block kept): the port's general loop equals its masked loop bit for
    bit with an equal traced-segment count, alone and on a shrinking
    schedule, and equals pbrs_tpu's resort render per lane
    with an equal count."""
    jscene, tscene, (ji, jo), (ti, to) = mesh
    n = SIZE * SIZE
    sampler = tsmp.PCGSampler(SEED)
    calls = _spy_compact(monkeypatch)

    def run(**kw):
        rad, cnt = twf.render_samples(tscene, sampler,
                                      torch.from_numpy(_pix(n)), 0, ti, to,
                                      max_depth=DEPTH, nee_mode=nee_mode,
                                      **kw)
        return rad.numpy(), int(cnt)

    masked, cnt_m = run()
    assert calls == []
    got, cnt = run(resort=True)
    assert [c[:2] for c in calls] == [(n, n)] * (DEPTH - 1)
    assert all(c[2] for c in calls)  # the blocks did move
    np.testing.assert_array_equal(got, masked)
    assert cnt == cnt_m
    sched = _schedule(tscene, ti, n, nee_mode)
    shrunk, cnt_s = run(resort=True, shrink_schedule=sched)
    np.testing.assert_array_equal(shrunk, masked)
    assert cnt_s == cnt_m
    want, cnt_j = jwf.render_samples(
        jscene, jsmp.PCGSampler(SEED), jnp.asarray(_pix(n)),
        jnp.zeros(n, jnp.int32), max_depth=DEPTH, msaa=2, intersect_fn=ji,
        occlude_fn=jo, return_ray_count=True, nee_mode=nee_mode,
        resort=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    assert cnt == int(cnt_j)


@pytest.mark.parametrize("folded", [False, True])
def test_resort_wave_loop(mesh, monkeypatch, folded):
    """The wave loop's resort (K4's plain version) equals its masked loop
    bit for bit with an equal traced-segment count, two-arm and folded."""
    tscene = mesh[1]
    n = SIZE * SIZE
    integ = fw.FusedWaveIntegrator(tscene, folded=folded)
    sampler = tsmp.PCGSampler(SEED)
    pix = torch.from_numpy(_pix(n))
    want, cnt_m = integ.render_samples(sampler, pix, 0, max_depth=DEPTH)
    calls = _spy_compact(monkeypatch)
    got, cnt = integ.render_samples(sampler, pix, 0, max_depth=DEPTH,
                                    resort=True)
    assert [c[:2] for c in calls] == [(n, n)] * (DEPTH - 1)
    assert want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(cnt) == int(cnt_m)


def test_render_image_compact(mesh, monkeypatch):
    """render_image(compact=True) on the CPU: the general path compacts
    every launch to the pilot's schedule and the image and traced rays
    equal compact=False's; "auto" does not compact on the CPU (the tuner
    runs on the card only). (auto_schedule's default floor
    of 16384 lanes would not shrink a frame this small: the test lowers
    it to 16.)"""
    auto_schedule = twf.auto_schedule
    monkeypatch.setattr(twf, "auto_schedule",
                        lambda c, n: auto_schedule(c, n, min_cap=16,
                                                   quantum=16))
    tscene = cli.with_resolution(_carry(jpresets.mesh_ball(levels=2)),
                                 48, 32)
    kw = dict(spp=1, max_depth=4, device="cpu")
    img_m, st_m = render.render_image(tscene, compact=False, **kw)
    img_c, st_c = render.render_image(tscene, compact=True, **kw)
    assert st_c.integrator == "plain_compact" and st_m.integrator == "plain"
    assert st_c.schedule[0] == 48 * 32 and min(st_c.schedule) < 48 * 32
    assert st_c.compacted_launches == 1 and st_m.schedule is None
    np.testing.assert_array_equal(img_c, img_m)
    assert st_c.traced_rays == st_m.traced_rays
    _, st_a = render.render_image(tscene, compact="auto", spp=1, max_depth=1,
                                  device="cpu")
    assert st_a.schedule is None
    with pytest.raises(ValueError):
        render.render_image(tscene, compact="yes", **kw)


def test_cli_compact(tmp_path, capsys):
    p = cli.build_parser()
    assert p.parse_args([]).compact == "auto"
    assert p.parse_args(["--compact", "on"]).compact == "on"
    with pytest.raises(SystemExit):
        p.parse_args(["--compact", "sometimes"])
    out = str(tmp_path / "m.png")
    assert cli.main(["--scene_name", "mesh_ball", "--resolution", "16x16",
                     "--msaa", "1", "--depth", "2", "--device", "cpu",
                     "--compact", "on", "--output", out]) == 0
    assert "plain_compact path on cpu" in capsys.readouterr().out
