"""The port's wave path (accel/fused_wave.py) against pbrs_tpu's: wave
eligibility, the K4 tables, K4's plain version (shade_reference) against the
Pallas _shade_call in interpret mode on identical per-bounce inputs (all 32
output planes per lane), and the port's FusedWaveIntegrator against the
port's general path and pbrs_tpu's general path per lane with equal ray
counts (tests/test_fused_wave.py:84-124), on the zoo scene of
tests/test_fused_wave.py:21-61."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import fused_kernel as jfk
from pbrs_tpu.accel import fused_single_lobe as jfsl
from pbrs_tpu.accel import fused_wave as jfw
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import render
from pbrs_tpu_torch.accel import fused_kernel as tfk
from pbrs_tpu_torch.accel import fused_single_lobe as fsl
from pbrs_tpu_torch.accel import fused_wave as fw
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.scene import buffers, presets
from test_fused_single_lobe import _shrunk
from test_fused_wave import _zoo_scene

ATOL, RTOL = 3e-5, 2e-4  # tests/test_fused_wave.py:84-100
SIZE, DEPTH = 16, 3
# The three planes that hold a sign of (direction . normal); where the
# direction lies in the surface's plane the sign is decided by rounding.
SIDE_PLANES = {7: (3, 4, 5), 15: (11, 12, 13), 26: (23, 24, 25)}


def _carry(jscene):
    return buffers.scene_from_arrays(buffers.scene_to_arrays(jscene))


@pytest.fixture(scope="module")
def zoo():
    """(pbrs_tpu zoo at SIZE^2, the port's carried copy, every K4 call of
    the port's wave path on sample 0 with its outputs, the port's wave
    radiance and ray count)."""
    jscene = _shrunk(_zoo_scene(), SIZE)
    tscene = _carry(jscene)
    calls = []
    shade = fw.shade

    def record(tab, fin, iin, count, **kw):
        out = shade(tab, fin, iin, count, **kw)
        calls.append((tab, fin, iin, kw, out))
        return out

    fw.shade = record
    try:
        rad, cnt = fw.FusedWaveIntegrator(tscene).render_samples(
            tsmp.PCGSampler(0), torch.arange(SIZE * SIZE, dtype=torch.int32),
            0, max_depth=DEPTH, msaa=2)
    finally:
        fw.shade = shade
    return jscene, tscene, calls, rad, cnt


def test_eligibility_zoo(zoo):
    jscene, tscene, *_ = zoo
    assert fw.scene_supports_wave(tscene) and jfw.scene_supports_wave(jscene)
    assert not fsl.scene_supports_single_lobe(tscene)
    assert not tfk.scene_supports_fused(tscene)


@pytest.mark.parametrize("name", ["everything", "mesh_ball", "cornell_box",
                                  "plates"])
def test_eligibility_presets(name):
    """Equal to pbrs_tpu's on the presets; the mesh scenes fall past K2 and
    K3 to the wave path, as the interior does (tests/test_torch_pbrt.py)."""
    kw = {"levels": 2} if name == "mesh_ball" else {}
    tscene, jscene = (presets.PRESETS[name](**kw),
                      jpresets.PRESETS[name](**kw))
    assert fw.scene_supports_wave(tscene) == jfw.scene_supports_wave(jscene)
    if name in ("everything", "mesh_ball"):
        assert fw.scene_supports_wave(tscene)
        assert not fsl.scene_supports_single_lobe(tscene)
        assert not tfk.scene_supports_fused(tscene)
        assert not jfsl.scene_supports_single_lobe(jscene)
        assert not jfk.scene_supports_fused(jscene)


def test_tables_match_reference(zoo):
    """WaveTables packs the banks FusedWaveIntegrator.__init__ packs."""
    jscene, tscene, *_ = zoo
    integ = jfw.FusedWaveIntegrator(jscene, interpret=True, use_pallas=False)
    tab = fw.WaveTables.from_scene(tscene)
    for got, want in ((tab.mats, integ.mats), (tab.lights, integ.lights),
                      (tab.delta, integ.delta)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tab.n_slots, tab.textured_slots, tab.present_kinds,
            tab.light_shapes, tab.n_area, tab.n_delta, tab.has_env,
            tab.env_is) == (integ.n_slots, integ.textured_slots,
                            integ.present_kinds, integ.light_shapes,
                            integ.n_area, integ.n_delta, bool(integ.has_env),
                            integ.env_is)
    assert np.float32(tab.world_radius) == np.float32(integ.world_radius)


def _pallas_planes(tab, fin, iin, rows):
    """The port's planes in _shade_call's order, padded as
    FusedWaveIntegrator.render_samples pads them."""
    f, i = fin.numpy(), iin.numpy()
    n = f.shape[1]
    pad = rows * 128 - n

    def prep(a, fill=0.0):
        a = jnp.asarray(a)
        return jnp.concatenate([a, jnp.full(pad, fill, a.dtype)]).reshape(
            rows, 128)

    nt = 3 * len(tab.textured_slots)
    planes = [prep(f[0], 1.0), prep(f[1]), prep(f[2]), prep(f[3]),
              prep(f[4]), prep(f[5]), prep(f[6]), prep(f[7]),
              prep(f[8], 1.0), prep(f[9], 1.0), prep(f[10]), prep(f[11]),
              prep(i[0], -1), prep(i[1], 0), prep(f[12]), prep(f[13]),
              prep(f[14]), prep(i[2], 0), prep(i[3], 0)]
    planes += [prep(f[15 + k]) for k in range(nt)]
    if tab.env_is:
        e = f[15 + nt:22 + nt]
        planes += [prep(e[0]), prep(e[1]), prep(e[2], 1.0)]
        planes += [prep(x) for x in e[3:]]
    planes += [prep(i[4], 0), prep(i[5], 0), prep(f[-3]), prep(f[-2]),
               prep(f[-1])]
    return tuple(planes)


def test_plain_kernel_matches_pallas_kernel(zoo):
    """shade_reference against _shade_call(interpret=True) on every bounce's
    inputs of the port's wave path: all 30 float and 2 int planes per lane
    at ATOL / RTOL. The only lanes allowed to differ are those of a side
    plane whose direction lies in the surface's plane to rounding (|d . n|
    <= 1e-5 |d|): there the sign's argument is a rounding residue (ROADMAP
    Queue 3)."""
    jscene, _, calls, *_ = zoo
    integ = jfw.FusedWaveIntegrator(jscene, interpret=True, use_pallas=False)
    n = SIZE * SIZE
    rows = 64  # one block of 64 x 128 lanes
    assert len(calls) == DEPTH
    for tab, fin, iin, kw, (fout, iout) in calls:
        ints = jnp.asarray([0, kw["bounce"], int(kw["first"]),
                            int(kw["rr_on"])], jnp.int32)
        out = jfw._shade_call(
            integ.mats, integ.mats_splits, integ.lights, integ.delta, ints,
            jnp.asarray([integ.world_radius], jnp.float32),
            _pallas_planes(tab, fin, iin, rows), n_mats=integ.n_mats,
            n_area=integ.n_area, n_delta=integ.n_delta,
            present_kinds=integ.present_kinds,
            light_shapes=integ.light_shapes, n_slots=integ.n_slots,
            textured_slots=integ.textured_slots, has_env=integ.has_env,
            env_is=integ.env_is, folded=False, interpret=True, rng="pcg")
        want = np.stack([np.asarray(o).reshape(-1)[:n] for o in out])
        got = np.concatenate([fout.numpy(), iout.numpy().astype(np.float32)])
        ok = np.isclose(got, want, atol=ATOL, rtol=RTOL)
        nrm = fin.numpy()[6:9]
        for side, dirs in SIDE_PLANES.items():
            d = got[list(dirs)]
            tangent = (np.abs((d * nrm).sum(0))
                       <= 1e-5 * np.linalg.norm(d, axis=0))
            ok[side] |= tangent
        assert ok.all(), [(k, int((~ok[k]).sum())) for k in range(32)
                          if not ok[k].all()]
        assert int((iin[2] > 0).sum()) > 0


def test_wave_matches_general_paths(zoo):
    """The port's wave path against pbrs_tpu's general path and the port's
    general path per lane, with equal ray counts."""
    jscene, tscene, _, rad, cnt = zoo
    n = SIZE * SIZE
    want, cnt_j = jwf.render_samples(jscene, jsmp.PCGSampler(0),
                                     jnp.arange(n), 0, max_depth=DEPTH,
                                     msaa=2, return_ray_count=True)
    want = np.asarray(want)
    assert np.isfinite(want).all() and want.sum() > 0
    np.testing.assert_allclose(rad.numpy(), want, atol=ATOL, rtol=RTOL)
    assert int(cnt) == int(cnt_j)
    _, fn = render.make_integrator(tscene, tsmp.PCGSampler(0), DEPTH, 2,
                                   "plain")
    got, cnt_g = fn(torch.arange(n, dtype=torch.int32), 0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert int(cnt_g) == int(cnt)


def test_dead_groups_pass_through(zoo):
    """A group of GROUP lanes with no live lane writes zeros, the incoming
    direction and beta; a live group shades its dead lanes too, as the TPU
    kernel's 64 x 128-lane blocks do."""
    _, _, calls, *_ = zoo
    tab, fin, iin, kw, _ = calls[0]
    reps = fw.GROUP // fin.shape[1]
    fin2 = torch.cat([fin.repeat(1, reps), fin], dim=1)
    iin2 = torch.cat([iin.repeat(1, reps), iin], dim=1)
    iin2[2, :fw.GROUP] = 0  # the first group all dead
    fout, iout, _ = fw.shade_reference(tab, fin2.contiguous(),
                                       iin2.contiguous(), **kw)
    dead = slice(0, fw.GROUP)
    assert (fout[:23, dead] == 0).all() and (fout[26, dead] == 0).all()
    assert torch.equal(fout[23:26, dead], fin2[0:3, dead])
    assert torch.equal(fout[27:30, dead], fin2[-3:, dead])
    assert (iout[:, dead] == 0).all()
    live, _, _ = fw.shade_reference(tab, fin, iin, **kw)
    torch.testing.assert_close(fout[:, fw.GROUP:], live, rtol=0, atol=0)


def test_refusals(zoo):
    """What the wave path still refuses: another device, a threefry sampler
    (the general wavefront draws it) and folded NEE on a scene with a
    FOURIER lobe (the Fourier override is two-arm only)."""
    import dataclasses

    from pbrs_tpu_torch.bxdf import lobes as lb

    _, tscene, calls, *_ = zoo
    tab, fin, iin, kw, _ = calls[0]
    with pytest.raises(ValueError):
        fw.shade(tab, fin.to("meta"), iin.to("meta"), None, **kw)
    kind = tscene.materials.kind.clone()
    kind[1, 0] = lb.FOURIER
    fourier = tscene.replace(materials=dataclasses.replace(
        tscene.materials, kind=kind))
    with pytest.raises(ValueError, match="Fourier"):
        fw.FusedWaveIntegrator(fourier, folded=True)
    for sampler in (tsmp.ThreefrySampler(1), jsmp.SobolSampler(1)):
        with pytest.raises(TypeError):
            fw.FusedWaveIntegrator(tscene).render_samples(
                sampler, torch.arange(4), 0)


def test_lane_classifier_on_agreeing_lanes(zoo):
    """lane_diff.classify renders lanes of the zoo again on their own: the
    wave and general paths agree there, so every lane is "same", with the
    wave path's radiance of the whole-frame render."""
    from pbrs_tpu_torch import lane_diff

    _, tscene, _, rad, _ = zoo
    pix = torch.tensor([0, 37, 100, 255], dtype=torch.int32)
    lanes = lane_diff.classify(tscene, pix, DEPTH, 2)
    assert [ln["how"] for ln in lanes] == ["same"] * 4
    for ln, p in zip(lanes, pix.tolist()):
        assert ln["pixel"] == p and ln["parts_at_bounce"] is None
        np.testing.assert_array_equal(np.float32(ln["wave"]), rad[p].numpy())
        assert len(ln["materials_hit"][0]) == DEPTH


@pytest.mark.parametrize("arms, inc, how", [
    # (cast, blocked, direction) per path, for the light and BSDF arms;
    # the radiance each path adds at the bounce.
    ((((1, 0, 0), (1, 0, 0)), ((1, 1, 0), (1, 0, 0))), (1.0, 0.0), "shadow"),
    ((((1, 0, 0), (1, 0, 1)), ((1, 0, 0), (1, 0, 0))), (1.0, 1.1),
     "light sample"),
    ((((0, 0, 0), (1, 0, 0)), ((1, 0, 0), (1, 0, 0))), (1.0, 1.5),
     "arm flip"),
    ((((0, 0, 0), (1, 0, 0)), ((1, 0, 0), (1, 0, 0))), (1.0, 1.01),
     "value"),
])
def test_lane_classifier_nee_causes(arms, inc, how):
    """The order in which lane_diff names a bounce's NEE cause: a shadow
    query both paths cast and one blocks, then a light-sampled direction,
    then a contribution that differs by more than FLIP_TOL, else the value
    -- whether each path cast a query does not decide it."""
    from pbrs_tpu_torch import lane_diff

    def arm(cast, blocked, turn):
        d = torch.tensor([[0.0, 0.0, 1.0]]) if not turn else \
            torch.tensor([[0.0, 1.0, 0.0]])
        return d, torch.tensor([bool(cast)]), torch.tensor([bool(blocked)])

    wave = [arm(*a[0]) for a in arms]
    general = [arm(*a[1]) for a in arms]
    inc_w, inc_g = (torch.full((3,), v) for v in inc)
    assert lane_diff._nee_cause(wave, general, 0, inc_w, inc_g) == how
