"""The port's mesh slice against pbrs_tpu: the copied host code (Loop
subdivision, vertex normals, both BVH builders, validate_bvh), add_mesh and
the mesh presets' tables, scene_from_arrays on the mesh scenes, per-lane
radiance of smooth-shaded triangles, and the mesh goldens through the BVH
trace's plain version. Inputs are made from numpy seeds."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import bvh as jbvh
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.geometry import camera as jcam
from pbrs_tpu.geometry import transform as jtf
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import ply as jply
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu.scene import subdivision as jsub
from pbrs_tpu.shapes import tables as jtables
from pbrs_tpu_torch import cli, render
from pbrs_tpu_torch.accel import bvh as tbvh
from pbrs_tpu_torch.accel import treelet as tl
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.geometry import transform as ttf
from pbrs_tpu_torch.scene import buffers, ply, presets, subdivision
from pbrs_tpu_torch.shapes import tables as ttables
from test_torch_scene import _assert_same, jax_arrays
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_checksums.json")
REL_TOL = 2e-3  # tests/test_golden.py
ATOL, RTOL = 3e-5, 2e-4  # tests/test_fused_single_lobe.py:73,85
OCTAHEDRON = (
    np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
              [0, 0, -1]], np.float32),
    np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5],
              [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int64))


def _open_mesh(seed=0):
    """A jittered grid patch (boundary edges and vertices) from a seed."""
    rng = np.random.default_rng(seed)
    xs, zs = np.meshgrid(np.arange(4), np.arange(4))
    pos = np.stack([xs.ravel(), rng.uniform(-0.2, 0.2, 16), zs.ravel()],
                   1).astype(np.float32)
    idx = []
    for r in range(3):
        for c in range(3):
            a, b, d = r * 4 + c, r * 4 + c + 1, (r + 1) * 4 + c
            idx += [(a, d, b), (b, d, d + 1)]
    return pos, np.asarray(idx, np.int64)


@pytest.mark.parametrize("mesh", ["octahedron", "open patch"])
def test_subdivision_and_normals_equal_reference(mesh):
    pos, idx = OCTAHEDRON if mesh == "octahedron" else _open_mesh()
    got = subdivision.loop_subdivide(pos, idx, 2)
    want = jsub.loop_subdivide(pos, idx, 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ply.compute_vertex_normals(*got),
                                  jply.compute_vertex_normals(*want))


def _boxes(seed):
    """Sphere boxes and a subdivided mesh's triangle boxes from a seed."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (900, 3)).astype(np.float32)
    r = rng.uniform(0.01, 0.3, 900).astype(np.float32)
    pos, idx = jsub.loop_subdivide(*OCTAHEDRON, 3)
    lo, hi = tbvh.triangle_bboxes(pos[idx[:, 0]], pos[idx[:, 1]],
                                  pos[idx[:, 2]])
    return [(c - r[:, None], c + r[:, None]), (lo, hi)]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_bvh_builders_equal_reference(native):
    for lo, hi in _boxes(1):
        got = tbvh.build_bvh(lo, hi, use_native=native)
        want = jbvh.build_bvh(lo, hi, use_native=native)
        assert got.builder == ("native" if native else "numpy")
        for f in ("bbox_min", "bbox_max", "is_leaf", "first", "count",
                  "skip", "prim_order"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        assert got.depth == want.depth
        assert tbvh.validate_bvh(got, lo, hi) and jbvh.validate_bvh(want, lo,
                                                                     hi)
        inner = np.nonzero(got.is_leaf == 0)[0]
        assert (got.count[got.is_leaf == 1] <= tbvh.MAX_LEAF).all()
        if native:  # the right child is stored, and is the left's miss link
            np.testing.assert_array_equal(got.first[inner],
                                          got.skip[inner + 1])


def test_validate_bvh_catches_a_loose_prim():
    lo, hi = _boxes(2)[0]
    tree = tbvh.build_bvh(lo, hi)
    leaf = int(np.nonzero(tree.is_leaf)[0][0])
    prim = tree.prim_order[tree.first[leaf]]
    hi = hi.copy()
    hi[prim] = tree.bbox_max[leaf] + 1.0
    assert not tbvh.validate_bvh(tree, lo, hi)
    assert not jbvh.validate_bvh(tree, lo, hi)


def test_add_mesh_tables_equal_reference():
    """Per-vertex normals and uvs under a rotating, scaling transform."""
    rng = np.random.default_rng(5)
    pos, idx = _open_mesh(3)
    nrm = ply.compute_vertex_normals(pos, idx)
    uvs = rng.uniform(0, 1, (pos.shape[0], 2)).astype(np.float32)
    got, want = ttables.GeometryBuilder(), jtables.GeometryBuilder()
    for b, tf in ((got, ttf), (want, jtf)):
        m = tf.compose(tf.translate((1.0, 2.0, -3.0)), tf.rotate_y(30.0),
                       tf.scale((2.0, 0.5, 1.0)))
        b.add_mesh(pos, idx, 3, normals=nrm, uvs=uvs, transform=m)
        b.add_mesh(pos, idx, 4)
    got, want = got.build(), want.build()
    for f in ("tri_p0", "tri_p1", "tri_p2", "tri_n0", "tri_n1", "tri_n2",
              "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.counts[2] == 2 * idx.shape[0]


@pytest.fixture(scope="module")
def jax_mesh_scenes():
    return {"mesh_ball": jpresets.mesh_ball(levels=2),
            "everything": jpresets.everything()}


@pytest.mark.parametrize("name", ["mesh_ball", "everything"])
def test_mesh_presets_and_carried_tables(name, jax_mesh_scenes):
    """The port's presets equal pbrs_tpu's array for array, and
    scene_from_arrays carries the JAX scene across exactly: the triangle
    normal and uv tables, everything's transformed spheres."""
    jscene = jax_mesh_scenes[name]
    tscene = (presets.mesh_ball(levels=2) if name == "mesh_ball"
              else presets.everything())
    _assert_same(buffers.scene_to_arrays(tscene), jax_arrays(jscene))
    carried = buffers.scene_from_arrays(jax_arrays(jscene))
    _assert_same(buffers.scene_to_arrays(carried),
                 buffers.scene_to_arrays(tscene))
    assert carried.num_lights == jscene.num_lights
    assert carried.materials.present_kinds == jscene.materials.present_kinds


def _golden(key, scene, size, depth, route, thresh=None):
    with open(GOLDEN) as f:
        want = json.load(f)[key]
    scene = cli.with_resolution(scene, size, size)
    name, fn = render.make_integrator(scene, tsmp.PCGSampler(0), depth, 2,
                                      route, bvh_threshold=thresh)
    pix = torch.arange(size * size, dtype=torch.int32)
    got = sum(float(fn(pix, s)[0].sum()) for s in range(2))
    assert name == route
    assert abs(got - want) <= REL_TOL * abs(want), (got, want)


def test_golden_mesh_ball_through_bvh_plain_version():
    """tests/test_golden.py's mesh_ball_l2 (48^2, depth 4): with a BVH
    threshold of 64 its 256 triangles take K5's plain version."""
    assert tl.LAUNCHES == 0
    _golden("mesh_ball_l2", presets.mesh_ball(levels=2), 48, 4, "general",
            thresh=64)


def test_golden_everything_through_general_route():
    """tests/test_golden.py's everything (32^2, depth 3): its 2401 quads
    take K5's plain version, its 1005 spheres the flat bank's."""
    _golden("everything", presets.everything(), 32, 3, "general")


def test_smooth_triangles_match_reference_per_lane(jax_mesh_scenes):
    """Per-lane radiance on mesh_ball(levels=2) at 24^2, depth 4: the port's
    plain route and its general route (K5's plain version, BVH threshold 64)
    against pbrs_tpu's general wavefront with the jnp sweep, with equal ray
    counts. Smooth shading interpolates the vertex normals at the hit."""
    size, depth = 24, 4
    jscene = jax_mesh_scenes["mesh_ball"]
    cam = jscene.camera
    fresh = jcam.make_camera((size, size), 40.0)
    jscene = jscene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * ((cam.width // 2) / (size // 2)),
        b=cam.b * ((cam.height // 2) / (size // 2)), c=cam.c))
    tscene = cli.with_resolution(presets.mesh_ball(levels=2), size, size)
    n = size * size
    pix = torch.arange(n, dtype=torch.int32)
    want, cnt_j = jwf.render_samples(
        jscene, jsmp.PCGSampler(0), jnp.arange(n), 1, max_depth=depth,
        msaa=2, return_ray_count=True)
    want = np.asarray(want)
    assert np.isfinite(want).all() and want.sum() > 0
    for route in ("plain", "general"):
        _, fn = render.make_integrator(tscene, tsmp.PCGSampler(0), depth, 2,
                                       route, bvh_threshold=64)
        rad, cnt = fn(pix, 1)
        np.testing.assert_allclose(rad.numpy(), want, atol=ATOL, rtol=RTOL,
                                   err_msg=route)
        assert int(cnt) == pytest.approx(float(cnt_j), rel=1e-6), route
