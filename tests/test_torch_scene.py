"""Scene state of the port against pbrs_tpu: the Cornell tables are equal
array for array, scene_from_arrays carries a JAX scene across exactly, and
camera rays agree."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import fused_kernel as jfk
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.geometry import camera as jcam
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch.accel import fused_kernel as tfk
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.geometry import camera as tcam
from pbrs_tpu_torch.integrators import wavefront as twf
from pbrs_tpu_torch.scene import buffers, presets
from pbrs_tpu_torch.shapes.tables import GeometryBuilder


def jax_arrays(scene):
    """{dotted path: np.asarray(leaf)} of a pbrs_tpu Scene."""
    out = {}
    for key in buffers.ARRAY_KEYS:
        group, name = key.split(".")
        out[key] = np.asarray(getattr(getattr(scene, group), name))
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def jax_cornell():
    return jpresets.cornell_box()


def test_cornell_tables_equal(jax_cornell):
    _assert_same(buffers.scene_to_arrays(presets.cornell_box()),
                 jax_arrays(jax_cornell))


def test_scene_from_arrays_roundtrip(jax_cornell):
    carried = buffers.scene_from_arrays(jax_arrays(jax_cornell))
    _assert_same(buffers.scene_to_arrays(carried),
                 buffers.scene_to_arrays(presets.cornell_box()))
    assert carried.num_lights == jax_cornell.num_lights == 1
    assert carried.materials.present_kinds == \
        jax_cornell.materials.present_kinds
    assert carried.area_lights.present_shapes == (0,)
    assert tfk.scene_supports_fused(carried)


def test_fused_eligibility_matches_reference(jax_cornell):
    assert tfk.scene_supports_fused(presets.cornell_box()) == \
        jfk.scene_supports_fused(jax_cornell)
    scene = presets.cornell_box()
    g = GeometryBuilder()
    g.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), 0)
    g.add_quad((0, 0, 0), (1, 0, 0), (0, 1, 0), 0)
    assert not tfk.scene_supports_fused(scene.replace(geom=g.build()))


@pytest.mark.parametrize("sample", [0, 3, "tensor"])
def test_camera_rays_match(sample):
    size = 24
    jscene = jpresets.cornell_box().replace(camera=jcam.looking_at(
        jcam.make_camera((size, size), 40.0), (278, 278, -800),
        (278, 278, 0), (0, 1, 0)))
    tscene = presets.cornell_box().replace(camera=tcam.looking_at(
        tcam.make_camera((size, size), 40.0), (278, 278, -800),
        (278, 278, 0), (0, 1, 0)))
    _assert_same(
        {k: v for k, v in buffers.scene_to_arrays(tscene).items()
         if k.startswith("camera.")},
        {k: v for k, v in jax_arrays(jscene).items()
         if k.startswith("camera.")})
    pix = np.arange(size * size, dtype=np.int32)
    if sample == "tensor":
        s = np.random.default_rng(2).integers(0, 4, pix.shape[0]).astype(
            np.int32)
        sj, st = jnp.asarray(s), torch.from_numpy(s)
    else:
        sj = st = sample
    want = jwf.camera_rays(jscene, jsmp.PCGSampler(0), jnp.asarray(pix), sj, 2)
    got = twf.camera_rays(tscene, tsmp.PCGSampler(0), torch.from_numpy(pix),
                          st, 2)
    for g, w in ((got.origin, want.origin), (got.dir, want.dir),
                 (got.t_max, want.t_max)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def test_unported_parts_raise():
    """The Fourier BSDF is SceneBuilder's one unported part; instance
    groups, image textures and Oren-Nayar matte build."""
    b = buffers.SceneBuilder()
    with pytest.raises(NotImplementedError, match="add_fourier"):
        b.materials.add_fourier(None)
    assert set(presets.PRESETS) == {
        "cornell_box", "quad", "quad_light", "two_perlin_spheres", "earth",
        "mixed_spheres", "plates", "env_mapped", "everything", "mesh_ball"}
    master = GeometryBuilder()
    master.add_sphere((0, 0, 0), 1.0, 0)
    b.add_instance_group(master, [np.eye(4)])
    assert b.textures.add_image(np.zeros((2, 2, 3))) == 0
    assert b.materials.add_matte((0.5, 0.5, 0.5), sigma_deg=20.0) == 0
    b.camera = tcam.make_camera((4, 4), 40.0)
    assert len(b.build().instanced) == 1
