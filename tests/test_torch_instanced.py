"""The port's trace-time instancing (accel/instanced.py, accel/dispatch.py)
against pbrs_tpu's on tests/test_instanced.py's cases: exact ellipsoid hits
and normals, geometry stored once, occlusion through a group, a group
traced like its baked equivalent, and the PBRT routes into groups -- each
case also held hit for hit against the JAX package on the same rays."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import dispatch as jdispatch
from pbrs_tpu.geometry import camera as jcam
from pbrs_tpu.geometry import ray as jray
from pbrs_tpu.geometry import transform as jtf
from pbrs_tpu.scene.buffers import SceneBuilder as JSceneBuilder
from pbrs_tpu.shapes.tables import GeometryBuilder as JGeometryBuilder
from pbrs_tpu_torch.accel import dispatch, instanced
from pbrs_tpu_torch.geometry import camera as cam_mod
from pbrs_tpu_torch.geometry import ray as ray_mod
from pbrs_tpu_torch.geometry import transform as tf
from pbrs_tpu_torch.scene.buffers import SceneBuilder, scene_to_arrays
from pbrs_tpu_torch.scene.pbrt import loader
from pbrs_tpu_torch.shapes.tables import GeometryBuilder
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ATOL = 1e-4  # tests/test_instanced.py:55


def _rays(origins, dirs, t_max=1e9):
    o = torch.from_numpy(np.asarray(origins, np.float32))
    d = torch.from_numpy(np.asarray(dirs, np.float32))
    return ray_mod.RayBatch(origin=o, dir=d,
                            t_max=torch.full((o.shape[0],), t_max))


def _jrays(origins, dirs, t_max=1e9):
    o = jnp.asarray(np.asarray(origins, np.float32))
    return jray.RayBatch(origin=o, dir=jnp.asarray(np.asarray(dirs,
                                                              np.float32)),
                         t_max=jnp.full(o.shape[0], t_max, jnp.float32))


def _ellipsoid_scene(pkg_builder, pkg_geom, pkg_tf, scale=(2.0, 1.0, 1.0)):
    b = pkg_builder()
    m = b.materials.add_lambertian((0.7, 0.2, 0.2))
    master = pkg_geom()
    master.add_sphere((0, 0, 0), 1.0, m)
    b.add_instance_group(master, [pkg_tf.scale(scale)])
    b.lights.add_point((0, 5, 0), (50.0, 50.0, 50.0))
    return b


def _port_ellipsoid():
    b = _ellipsoid_scene(SceneBuilder, GeometryBuilder, tf)
    b.camera = cam_mod.looking_at(cam_mod.make_camera((16, 16), 45.0),
                                  (0, 4, 6), (0, 0, 0), (0, 1, 0))
    return b.build()


def _jax_ellipsoid():
    b = _ellipsoid_scene(JSceneBuilder, JGeometryBuilder, jtf)
    b.camera = jcam.looking_at(jcam.make_camera((16, 16), 45.0), (0, 4, 6),
                               (0, 0, 0), (0, 1, 0))
    return b.build()


def _same_hits(hit_t, hit_j):
    np.testing.assert_array_equal(hit_t.hit.numpy(), np.asarray(hit_j.hit))
    m = hit_t.hit.numpy()
    for f in ("t", "pos", "normal", "dpdu"):
        np.testing.assert_allclose(getattr(hit_t, f).numpy()[m],
                                   np.asarray(getattr(hit_j, f))[m],
                                   atol=ATOL, rtol=1e-5, err_msg=f)
    np.testing.assert_array_equal(hit_t.mat_id.numpy(),
                                  np.asarray(hit_j.mat_id))


def test_group_tables_equal_reference():
    got, want = scene_to_arrays(_port_ellipsoid()), scene_to_arrays(
        _jax_ellipsoid())
    keys = [k for k in want if k.startswith("instanced.")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ellipsoid_exact_hits_and_normals():
    scene = _port_ellipsoid()
    assert len(scene.instanced) == 1
    assert not instanced.flattenable(scene.instanced[0])
    isect, _ = dispatch.make_trace_fns(scene, use_kernels=False)
    o = [[5, 0, 0], [0, 5, 0], [0, 0, 5], [0, 1.5, 5]]
    d = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [0, 0, -1]]
    h = isect(_rays(o, d))
    np.testing.assert_allclose(h.t.numpy()[:3], [3.0, 4.0, 4.0], atol=ATOL)
    assert h.hit.tolist() == [True, True, True, False]
    np.testing.assert_allclose(h.normal.numpy()[0], [1, 0, 0], atol=ATOL)
    np.testing.assert_allclose(h.normal.numpy()[1], [0, 1, 0], atol=ATOL)
    # Off-axis: the normal is the inverse-transpose one, not the radial.
    px, py = 2.0 * np.cos(np.pi / 4), np.sin(np.pi / 4)
    h2 = isect(_rays([[px, 5, 0]], [[0, -1, 0]]))
    want = np.array([px / 4.0, py, 0.0])
    np.testing.assert_allclose(h2.normal.numpy()[0],
                               want / np.linalg.norm(want), atol=ATOL)
    jisect, _ = jdispatch.make_trace_fns(_jax_ellipsoid(), use_pallas=False)
    _same_hits(h, jisect(_jrays(o, d)))


def test_instances_share_master_memory():
    b = SceneBuilder()
    m = b.materials.add_lambertian((0.5, 0.5, 0.5))
    master = GeometryBuilder()
    pts = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32)
    for i in range(10):
        master.add_triangle(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], m)
    b.add_instance_group(master, [tf.translate((4.0 * i, 0, 0))
                                  for i in range(50)])
    b.camera = cam_mod.make_camera((8, 8), 45.0)
    grp = b.build().instanced[0]
    assert grp.geom.tri_p0.shape[0] == 10 and tuple(grp.fwd.shape) == (50, 3,
                                                                        4)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_instanced_occlusion(use_kernels):
    """A box instanced between a point light and the floor shadows it,
    through the broadcast sweep and through the kernels' plain versions."""
    b = SceneBuilder()
    white = b.materials.add_lambertian((0.8, 0.8, 0.8))
    master = GeometryBuilder()
    master.add_cuboid((-1, -1, -1), (1, 1, 1), white)
    b.add_instance_group(master, [tf.translate((0, 2.0, 0))])
    b.geometry.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), white)
    b.camera = cam_mod.make_camera((8, 8), 60.0)
    scene = b.build()
    _, occl = dispatch.make_trace_fns(scene, use_kernels=use_kernels)
    blocked = occl(_rays([[0, 0.01, 0], [5, 0.01, 0]], [[0, 1, 0]] * 2, 5.9))
    assert blocked.tolist() == [True, False]


def test_group_trace_matches_baked_equivalent():
    """Two rotated + translated instances of four triangles intersect like
    the same triangles baked into world space, and like pbrs_tpu's group
    trace on the same rays."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(12, 3)).astype(np.float32)
    tfs = [tf.translate((3, 0, 0)) @ tf.rotate_axis_angle((0, 1, 0), 30.0),
           tf.translate((-2, 1, 0)) @ tf.rotate_axis_angle((1, 0, 0), -45.0)]

    def build(builder, geom, cam, baked):
        b = builder()
        m = b.materials.add_lambertian((0.5, 0.5, 0.5))
        master = geom()
        for t in (tfs if baked else [None]):
            for i in range(4):
                (b.geometry if baked else master).add_triangle(
                    pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], m,
                    transform=t)
        if not baked:
            b.add_instance_group(master, tfs)
        b.camera = cam.make_camera((8, 8), 45.0)
        return b.build()

    # Rays from random points aimed at the triangles' world centroids.
    cent = np.stack([(t[:3, :3] @ pts.reshape(4, 3, 3).mean(1).T).T
                     + t[:3, 3] for t in tfs]).reshape(-1, 3)
    o = rng.normal(size=(64, 3)).astype(np.float32) * 5
    d = (cent[rng.integers(0, len(cent), 64)] - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    port = (SceneBuilder, GeometryBuilder, cam_mod)
    hi = dispatch.make_trace_fns(build(*port, False),
                                 use_kernels=False)[0](_rays(o, d))
    hb = dispatch.make_trace_fns(build(*port, True),
                                 use_kernels=False)[0](_rays(o, d))
    np.testing.assert_array_equal(hi.hit.numpy(), hb.hit.numpy())
    m = hi.hit.numpy()
    assert m.any()
    np.testing.assert_allclose(hi.t.numpy()[m], hb.t.numpy()[m], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hi.normal.numpy()[m], hb.normal.numpy()[m],
                               atol=2e-3)
    jscene = build(JSceneBuilder, JGeometryBuilder, jcam, False)
    # Four triangles x two instances bake into the tracer in both packages.
    hj = jdispatch.make_trace_fns(jscene, use_pallas=False)[0](_jrays(o, d))
    _same_hits(hi, hj)


PBRT_INSTANCES = """
LookAt 0 2 8  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
  Material "matte" "rgb Kd" [0.7 0.7 0.7]
  ObjectBegin "thing"
    Shape "trianglemesh" "point P" [-1 0 -1  1 0 -1  0 1 0]
        "integer indices" [0 1 2]
  ObjectEnd
  AttributeBegin
    Translate -2 0 0
    ObjectInstance "thing"
  AttributeEnd
  AttributeBegin
    Translate 2 0 0
    Scale 1 2 1
    ObjectInstance "thing"
  AttributeEnd
  AttributeBegin
    Scale 3 1 1
    Shape "sphere" "float radius" [0.5]
  AttributeEnd
  LightSource "point" "rgb I" [10 10 10] "point from" [0 5 2]
WorldEnd
"""


def test_pbrt_routes_into_groups(tmp_path):
    """ObjectInstance builds one group (two transforms, geometry once); a
    non-uniformly scaled sphere becomes a one-instance group; both trace as
    pbrs_tpu's do."""
    from pbrs_tpu.scene.pbrt import loader as jloader

    path = tmp_path / "inst.pbrt"
    path.write_text(PBRT_INSTANCES)
    scene = loader.build_scene(str(path))
    assert len(scene.instanced) == 2
    # The sphere's group is made where the sphere is read, the object's at
    # the end of the file.
    sphere, grp = scene.instanced
    assert grp.fwd.shape[0] == 2 and grp.geom.tri_p0.shape[0] == 1
    assert sphere.fwd.shape[0] == 1
    got = scene_to_arrays(scene)
    want = scene_to_arrays(jloader.build_scene(str(path)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    o = [[2, 1.5, 5], [-2, 1.5, 5], [10, 0, 0], [0, 10, 0]]
    d = [[0, 0, -1], [0, 0, -1], [-1, 0, 0], [0, -1, 0]]
    isect, _ = dispatch.make_trace_fns(scene, use_kernels=False)
    h = isect(_rays(o, d))
    assert h.hit.tolist() == [True, False, True, True]
    np.testing.assert_allclose(h.t.numpy()[2:], [8.5, 9.5], atol=ATOL)
    jscene = jloader.build_scene(str(path))
    _same_hits(h, jdispatch.make_trace_fns(jscene, use_pallas=False)[0](
        _jrays(o, d)))
