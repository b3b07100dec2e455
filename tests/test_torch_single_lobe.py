"""The port's single-lobe path against pbrs_tpu: eligibility, the scene
tables carried across by scene_from_arrays, the K3 plain version
(bounce2_reference through FusedSingleLobeIntegrator) and the port's
general path against pbrs_tpu's general wavefront per lane, equal ray
counts, and one comparison against the Pallas kernel in interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import fused_kernel as jfk
from pbrs_tpu.accel import fused_single_lobe as jfsl
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import render
from pbrs_tpu_torch.accel import fused_kernel as tfk
from pbrs_tpu_torch.accel import fused_single_lobe as fsl
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.scene import buffers, presets
from test_fused_single_lobe import (_plastic_scene, _shaped_lights_scene,
                                    _shrunk, _textured_scene, _zoo_scene)

ATOL, RTOL = 3e-5, 2e-4  # tests/test_fused_single_lobe.py:73,85
# One float32 ulp at alpha ~ 0.01-1: the port computes roughness_to_alpha
# with PyTorch's log, the JAX package with XLA's, which round apart.
ALPHA_RTOL = 2.4e-7

JAX_TEST_SCENES = {"zoo": _zoo_scene, "plastic/uber": _plastic_scene,
                   "textured": _textured_scene,
                   "shaped lights": _shaped_lights_scene}


def carried(jscene):
    """The JAX scene's tables carried into the port."""
    return buffers.scene_from_arrays({
        key: np.asarray(getattr(getattr(jscene, key.split(".")[0]),
                                key.split(".")[1]))
        for key in buffers.ARRAY_KEYS})


def compare_with_general(jscene, sample=0, depth=5):
    """Port general path, plain path and K3-plain integrator vs pbrs_tpu's
    general wavefront, per lane, with ray counts."""
    tscene = carried(jscene)
    n = jscene.camera.width * jscene.camera.height
    want, cnt_j = jwf.render_samples(
        jscene, jsmp.PCGSampler(0), jnp.arange(n), sample, max_depth=depth,
        msaa=2, return_ray_count=True)
    want = np.asarray(want)
    pix = torch.arange(n, dtype=torch.int32)
    results = {"fused_single_lobe": fsl.FusedSingleLobeIntegrator(
        tscene).render_samples(tsmp.PCGSampler(0), pix, sample,
                               max_depth=depth, msaa=2)}
    for route in ("general", "plain"):
        _, fn = render.make_integrator(tscene, tsmp.PCGSampler(0), depth, 2,
                                       route)
        results[route] = fn(pix, sample)
    for name, (rad, cnt) in results.items():
        np.testing.assert_allclose(rad.numpy(), want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        assert int(cnt) == pytest.approx(float(cnt_j), rel=1e-6), name
    assert np.isfinite(want).all() and want.sum() > 0


@pytest.mark.parametrize("name", ["zoo", "plastic/uber", "textured",
                                  "shaped lights", "mesh_ball"])
def test_eligibility_matches_reference_on_test_scenes(name):
    if name == "mesh_ball":
        # Image-free multi-lobe glass mesh: not single-lobe in either
        # package; the port cannot build meshes, so carry the tables.
        jscene = jpresets.mesh_ball(levels=1)
    else:
        jscene = JAX_TEST_SCENES[name]()
    assert fsl.scene_supports_single_lobe(carried(jscene)) == \
        jfsl.scene_supports_single_lobe(jscene)


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_presets_match_reference(name):
    """Eligibility equal on every ported preset, and the port's own preset
    tables equal to pbrs_tpu's (alpha to one ulp, see ALPHA_RTOL)."""
    tscene, jscene = presets.PRESETS[name](), jpresets.PRESETS[name]()
    assert fsl.scene_supports_single_lobe(tscene) == \
        jfsl.scene_supports_single_lobe(jscene)
    assert tfk.scene_supports_fused(tscene) == \
        jfk.scene_supports_fused(jscene)
    got = buffers.scene_to_arrays(tscene)
    for key in buffers.ARRAY_KEYS:
        g, n = key.split(".")
        want = np.asarray(getattr(getattr(jscene, g), n))
        assert got[key].dtype == want.dtype and got[key].shape == want.shape
        if key == "materials.alpha":
            np.testing.assert_allclose(got[key], want, rtol=ALPHA_RTOL,
                                       atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want, err_msg=key)


def test_tables_carried_across():
    """scene_from_arrays carries every table and static field exactly, and
    the K3 bank packing matches FusedSingleLobeIntegrator.__init__."""
    jscene = _textured_scene()
    tscene = carried(jscene)
    back = buffers.scene_to_arrays(tscene)
    for key in buffers.ARRAY_KEYS:
        g, n = key.split(".")
        np.testing.assert_array_equal(
            back[key], np.asarray(getattr(getattr(jscene, g), n)), key)
    assert tscene.materials.textured_slots == jscene.materials.textured_slots
    assert tscene.materials.present_kinds == jscene.materials.present_kinds
    assert tscene.area_lights.present_shapes == \
        jscene.area_lights.present_shapes
    for make in (_zoo_scene, _plastic_scene, _textured_scene,
                 _shaped_lights_scene):
        js = make()
        integ = jfsl.FusedSingleLobeIntegrator(js, interpret=True)
        tab = fsl.SingleLobeTables.from_scene(carried(js))
        np.testing.assert_array_equal(
            tab.bank.numpy()[:, :14],
            np.stack([np.asarray(c) for c in integ.params], 1)[:, :14])
        for got, want in ((tab.mats, integ.mats), (tab.texs, integ.texs),
                          (tab.lights, integ.lights),
                          (tab.delta, integ.delta),
                          (tab.env, integ.env_colors)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (tab.counts, tab.n_area, tab.n_delta, tab.n_texs,
                tab.env_kind, tab.two_slots, tab.present_kinds,
                tab.light_shapes, tab.tex_kinds) == (
            integ.counts, integ.n_area, integ.n_delta, integ.n_texs,
            integ.env_kind, integ.two_slots, integ.present_kinds,
            integ.light_shapes, integ.tex_kinds)


def test_zoo_matches_general_path():
    compare_with_general(_zoo_scene())


def test_plain_kernel_matches_pallas_kernel():
    """K3's plain version vs the Pallas _bounce2_kernel in interpret mode:
    zoo at 16^2, depth 3, sample 0."""
    jscene = _shrunk(_zoo_scene(), 16)
    integ = jfsl.FusedSingleLobeIntegrator(jscene, interpret=True)
    want, cnt_j = integ.render_samples(jsmp.PCGSampler(0), jnp.arange(256),
                                       0, max_depth=3, msaa=2,
                                       return_ray_count=True)
    got, cnt_t = fsl.FusedSingleLobeIntegrator(carried(jscene)).render_samples(
        tsmp.PCGSampler(0), torch.arange(256, dtype=torch.int32), 0,
        max_depth=3, msaa=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    # The Pallas kernel sums per-lane averages in float32.
    assert int(cnt_t) == pytest.approx(float(cnt_j), rel=1e-6)


def test_wrapper_takes_no_other_device():
    tab = fsl.SingleLobeTables.from_scene(carried(_zoo_scene()))
    fin = torch.zeros(9, 4, device="meta")
    with pytest.raises(ValueError):
        fsl.bounce2(tab, fin, None, None, None, None, None, seed=0, bounce=0,
                    bounce_is_first=True, rr_active=False)
    with pytest.raises(TypeError):
        fsl.FusedSingleLobeIntegrator(carried(_zoo_scene())).render_samples(
            jsmp.SobolSampler(1), torch.arange(4), 0)
