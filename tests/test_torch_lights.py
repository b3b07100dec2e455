"""The port's lights, light-shape sampling, environment and textures
against pbrs_tpu's on numpy-seeded inputs, and the K3 plain version and
the port's general path against pbrs_tpu's general wavefront on the
shaped-lights scene and env_mapped (dusk sky)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.lights import lights as jlt
from pbrs_tpu.lights import sample_shape as jss
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu.textures import textures as jtex
from pbrs_tpu_torch.lights import lights as tlt
from pbrs_tpu_torch.lights import sample_shape as tss
from pbrs_tpu_torch.textures import textures as ttex
from test_fused_single_lobe import _shaped_lights_scene, _shrunk
from test_torch_single_lobe import compare_with_general
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

N = 512
# Elementwise float32 on both sides; XLA's and PyTorch's libm (sin, cos,
# acos) round apart by a few ulps.
ATOL, RTOL = 1e-5, 1e-5


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _build_lights(module):
    b = module.LightsBuilder()
    b.add_point((1.0, 4.0, -2.0), (30.0, 25.0, 20.0))
    b.add_distant((0.3, -1.0, 0.2), (0.5, 0.5, 0.55))
    b.add_area_quad((5, 5, 5), (-1, 3, -1), (2, 0, 0), (0, 0, 2))
    b.add_area_sphere((6, 5, 4), (2.0, 3.0, 1.0), 0.7)
    b.add_area_disk((3, 4, 5), (-2.0, 3.5, 0.5), (0.0, -1.0, 0.2),
                    (0.9, 0, 0))
    b.add_area_triangle((7, 7, 5), (-1, 4, 2), (1, 4, 2), (0, 4.5, 3.5))
    b.world_radius = 12.5
    return b.build()


@pytest.fixture(scope="module")
def lights():
    return _build_lights(jlt), _build_lights(tlt)


@pytest.fixture(scope="module")
def hits():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(-1, 2, N)
    u2 = rng.random((N, 2)).astype(np.float32)
    wi = rng.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    return pos, u2, wi


def test_tables_equal(lights):
    (jd, ja, _), (td, ta, _) = lights
    for f in ("kind", "position", "color", "world_radius"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), f)
    for f in ("shape_kind", "emit", "p0", "p1", "p2", "scalar"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), f)
    assert (td.count, ta.count, ta.present_shapes) == (
        jd.count, ja.count, ja.present_shapes)


def test_sample_delta(lights, hits):
    (jd, _, _), (td, _, _) = lights
    pos, _, _ = hits
    idx = np.random.default_rng(1).integers(0, 2, N).astype(np.int32)
    got = tlt.sample_delta(td, torch.from_numpy(idx), torch.from_numpy(pos))
    want = jlt.sample_delta(jd, jnp.asarray(idx), jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shape", ["quad", "sphere", "disk", "triangle"])
def test_area_shape(lights, hits, shape):
    """sample_towards, pdf_at, intersect_shape and shape_area of one shape,
    and the sample_area / area_radiance_to legs built on them."""
    (_, ja, _), (_, ta, _) = lights
    pos, u2, wi = hits
    idx = {"quad": 0, "sphere": 1, "disk": 2, "triangle": 3}[shape]
    i_j, i_t = jnp.full(N, idx, jnp.int32), torch.full((N,), idx,
                                                        dtype=torch.int32)
    jkind, _, jp = jlt.area_rows(ja, i_j)
    tkind, _, tp = tlt.area_rows(ta, i_t)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    ju, tu = jnp.asarray(u2), torch.from_numpy(u2)
    _close(tss.shape_area(tkind, tp), jss.shape_area(jkind, jp))
    for g, w in zip(tss.sample_towards(tkind, tp, tpos, tu),
                    jss.sample_towards(jkind, jp, jpos, ju)):
        _close(g, w, atol=2e-5)
    # Directions towards the shape (sampled points) and random ones.
    pt, _ = tss.sample_towards(tkind, tp, tpos, tu)
    to_pt = (pt - tpos) / torch.linalg.norm(pt - tpos, dim=1, keepdim=True)
    for w_np in (to_pt.numpy(), wi):
        jw, tw = jnp.asarray(w_np), torch.from_numpy(w_np)
        _close(tss.pdf_at(tkind, tp, tpos, tw), jss.pdf_at(jkind, jp, jpos, jw),
               rtol=2e-4)
        for g, w in zip(tss.intersect_shape(tkind, tp, tpos, tw),
                        jss.intersect_shape(jkind, jp, jpos, jw)):
            _close(g, w, atol=2e-5, rtol=2e-4)
    for g, w in zip(tlt.sample_area(ta, i_t, tpos, tu),
                    jlt.sample_area(ja, i_j, jpos, ju)):
        _close(g, w, atol=2e-5, rtol=2e-4)
    for g, w in zip(tlt.area_radiance_to(ta, i_t, tpos, torch.from_numpy(wi)),
                    jlt.area_radiance_to(ja, i_j, jpos, jnp.asarray(wi))):
        _close(g, w, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("env", ["dusk", "gradient", "const", "none"])
def test_eval_env(env, hits):
    _, _, wi = hits
    wi = np.concatenate([wi, [[0, 1, 0], [0, -1, 0], [0.2, 0, 1]]]).astype(
        np.float32)
    make = {"dusk": lambda m: m.make_env_dusk(),
            "gradient": lambda m: m.make_env_gradient((0.5, 0.7, 1.0),
                                                      (1, 1, 1)),
            "const": lambda m: m.make_env_const((0.2, 0.3, 0.4)),
            "none": lambda m: m.make_env_none()}[env]
    jenv, tenv = make(jlt), make(tlt)
    np.testing.assert_array_equal(tenv.color_a.numpy(),
                                  np.asarray(jenv.color_a))
    _close(tlt.eval_env(tenv, torch.from_numpy(wi)),
           jlt.eval_env(jenv, jnp.asarray(wi)))


def _textures(module):
    b = module.TextureBuilder()
    b.add_solid((0.2, 0.6, 0.3))
    b.add_checker((0.8, 0.2, 0.2), (0.9, 0.9, 0.85))
    b.add_perlin(2.0)
    b.add_perlin(4.0)
    return b.build()


def test_eval_texture():
    rng = np.random.default_rng(4)
    pos = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    uv = rng.random((N, 2)).astype(np.float32)
    tid = rng.integers(-1, 4, N).astype(np.int32)
    jt, tt = _textures(jtex), _textures(ttex)
    for f in ("kind", "color_a", "color_b", "freq"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), f)
    _close(ttex.eval_texture(tt, torch.from_numpy(tid), torch.from_numpy(uv),
                             torch.from_numpy(pos)),
           jtex.eval_texture(jt, jnp.asarray(tid), jnp.asarray(uv),
                             jnp.asarray(pos)), atol=2e-5)
    # The uint32 lattice hash, bit for bit, negative coordinates included.
    ix, iy, iz = (rng.integers(-5000, 5000, N).astype(np.int32)
                  for _ in range(3))
    np.testing.assert_array_equal(
        ttex._hash3(*(torch.from_numpy(a).to(torch.int64)
                      for a in (ix, iy, iz))).numpy(),
        np.asarray(jtex._hash3(jnp.asarray(ix), jnp.asarray(iy),
                               jnp.asarray(iz))).astype(np.int64))


def test_shaped_lights_match_general_path():
    compare_with_general(_shaped_lights_scene(), depth=4)


def test_env_mapped_matches_general_path():
    compare_with_general(_shrunk(jpresets.env_mapped(), 20), depth=4)
