"""The port's PBRT pipeline (scene/pbrt/tokenizer.py, parser.py, loader.py,
radiometry.py, core/spline.py) against pbrs_tpu's: tests/test_pbrt.py's
cases with every table compared to pbrs_tpu's loader output, the spectral
conversions, and the PBRT interior -- its tables array for array, its wave
eligibility, and a 16x16 centre crop (depth 4, sample 0) rendered per lane
through the port's general and wave paths against pbrs_tpu's general
path."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu import radiometry as jrad
from pbrs_tpu.accel import dispatch as jdispatch
from pbrs_tpu.accel import fused_wave as jfw
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene.pbrt import loader as jloader
from pbrs_tpu.scene.pbrt import parser as jparser
from pbrs_tpu.scene.pbrt import tokenizer as jtokenizer
from pbrs_tpu_torch import radiometry, render
from pbrs_tpu_torch.accel import fused_kernel as tfk
from pbrs_tpu_torch.accel import fused_single_lobe as fsl
from pbrs_tpu_torch.accel import fused_wave as fw
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.scene import buffers
from pbrs_tpu_torch.scene import ply as ply_mod
from pbrs_tpu_torch.scene.pbrt import loader, parser, tokenizer
from test_pbrt import CORNELL_PBRT, _write_binary_ply
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERIOR = os.path.join(REPO, "scenes", "interior", "interior.pbrt")
ATOL, RTOL = 3e-5, 2e-4  # tests/test_fused_wave.py:84-100
CROP, DEPTH = 16, 4
# The lanes where the wave and general paths part on the card (the file
# names the run that found them).
CARD_LANES = os.path.join(REPO, "tests", "interior_card_lanes.json")


def _same_tables(tscene, jscene):
    got, want = (buffers.scene_to_arrays(tscene),
                 buffers.scene_to_arrays(jscene))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert tscene.materials.present_kinds == jscene.materials.present_kinds
    assert tscene.materials.textured_slots == jscene.materials.textured_slots
    assert (tscene.area_lights.present_shapes
            == jscene.area_lights.present_shapes)


def test_tokenizer_basics():
    src = 'Shape "sphere" "float radius" [1.5] # c'
    toks, jtoks = tokenizer.tokenize_string(src), \
        jtokenizer.tokenize_string(src)
    assert [t.kind for t in toks] == ["word", "string", "string", "lbracket",
                                      "number", "rbracket"]
    assert [(t.kind, t.value) for t in toks] == [(t.kind, t.value)
                                                for t in jtoks]


def test_parser_ast():
    options, items = parser.parse_tokens(tokenizer.tokenize_string(
        CORNELL_PBRT))
    jopts, jitems = jparser.parse_tokens(jtokenizer.tokenize_string(
        CORNELL_PBRT))
    assert [o[0] for o in options] == [o[0] for o in jopts]
    assert [i[0] for i in items] == [i[0] for i in jitems]
    assert [i[0] for i in items].count("attribute") == 3


ROTATE = """
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Material "matte" "rgb Kd" [1 0 0]
AttributeBegin
  Rotate 90 0 0 1
  Translate 1 0 0
  Shape "sphere" "float radius" [0.5]
AttributeEnd
WorldEnd
"""

OBJECTS = """
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Material "matte" "rgb Kd" [1 1 1]
ObjectBegin "ball"
  Shape "sphere" "float radius" [1]
ObjectEnd
AttributeBegin
  Translate 5 0 0
  ObjectInstance "ball"
AttributeEnd
AttributeBegin
  Translate 0 7 0
  ObjectInstance "ball"
AttributeEnd
WorldEnd
"""

SPECTRA = """
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Material "matte" "blackbody Kd" [3200 0.5]
Shape "sphere" "float radius" [1]
Material "metal" "spectrum eta" [400 1.2 500 0.9 600 0.4 700 0.2]
    "spectrum k" [400 3 550 2.5 700 4] "float roughness" [0.05]
Shape "sphere" "float radius" [0.5]
Material "substrate" "rgb Kd" [0.4 0.3 0.2] "rgb Ks" [0.1 0.1 0.1]
Shape "disk" "float radius" [2]
Material "matte" "xyz Kd" [0.3 0.4 0.2] "float sigma" [15]
Shape "trianglemesh" "point P" [0 0 0  1 0 0  0 1 0] "integer indices" [0 1 2]
LightSource "infinite" "rgb L" [0.2 0.3 0.4]
LightSource "distant" "point from" [0 5 0] "point to" [0 0 0]
    "blackbody L" [5500 1]
WorldEnd
"""


@pytest.mark.parametrize("name,src", [("cornell", CORNELL_PBRT),
                                      ("rotate", ROTATE),
                                      ("objects", OBJECTS),
                                      ("spectra", SPECTRA)],
                         ids=["cornell", "rotate", "objects", "spectra"])
def test_loader_tables_match_reference(tmp_path, name, src):
    path = tmp_path / f"{name}.pbrt"
    path.write_text(src)
    tscene = loader.build_scene(str(path))
    _same_tables(tscene, jloader.build_scene(str(path)))
    if name == "rotate":
        # pbrt-v3 Rotate compatibility: the angle is negated.
        np.testing.assert_allclose(tscene.geom.sph_center[0].numpy(),
                                   [0, -1, 0], atol=1e-5)
    if name == "objects":
        assert len(tscene.instanced) == 1
        assert tuple(tscene.instanced[0].fwd.shape) == (2, 3, 4)
    if name == "cornell":
        assert (tscene.area_lights.count, tscene.delta_lights.count,
                tscene.num_lights) == (2, 1, 3)


def test_include(tmp_path):
    (tmp_path / "mat.pbrt").write_text('Material "matte" "rgb Kd" [0 1 0]\n')
    (tmp_path / "main.pbrt").write_text(
        'Camera "perspective" "float fov" [60]\n'
        'Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
        'WorldBegin\nInclude "mat.pbrt"\n'
        'Shape "sphere" "float radius" [2]\nWorldEnd\n')
    scene = loader.build_scene(str(tmp_path / "main.pbrt"))
    assert float(scene.geom.sph_radius[0]) == 2.0
    np.testing.assert_array_equal(scene.materials.albedo[0, 0].numpy(),
                                  [0, 1, 0])


def test_ply_binary_and_ascii(tmp_path):
    path = str(tmp_path / "mesh.ply")
    _write_binary_ply(path, [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)],
                      [(0, 1, 2, 3)])
    pos, nrm, _, idx = ply_mod.load_ply(path)
    assert pos.shape == (4, 3) and idx.shape == (2, 3)  # quad fan
    np.testing.assert_allclose(np.abs(nrm[:, 2]), 1.0, atol=1e-5)
    ascii_path = tmp_path / "a.ply"
    ascii_path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    pos, _, _, idx = ply_mod.load_ply(str(ascii_path))
    assert pos.shape == (3, 3) and idx.shape == (1, 3)


def test_spectra_match_reference():
    """Blackbody and sampled-spectrum RGB equal to pbrs_tpu's."""
    for t in (1500.0, 2700.0, 5500.0, 6500.0, 12000.0):
        np.testing.assert_array_equal(radiometry.temperature_to_rgb(t),
                                      jrad.temperature_to_rgb(t))
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 40):
        lam = rng.uniform(360, 830, n)
        val = rng.uniform(0, 3, n)
        np.testing.assert_array_equal(
            radiometry.sampled_spectrum_to_rgb(lam, val),
            jrad.sampled_spectrum_to_rgb(lam, val))
    np.testing.assert_array_equal(radiometry.XYZ_TO_RGB, jrad.XYZ_TO_RGB)


@pytest.fixture(scope="module")
def interior():
    return loader.build_scene(INTERIOR), jloader.build_scene(INTERIOR)


def test_interior_tables_match_reference(interior):
    tscene, jscene = interior
    _same_tables(tscene, jscene)
    assert tscene.geom.counts[2] == 5304 and len(tscene.instanced) == 2
    assert tscene.env.dist is not None


def test_interior_eligibility(interior):
    """The interior falls past K2 and K3 to the wave path in both
    packages."""
    tscene, jscene = interior
    assert fw.scene_supports_wave(tscene) and jfw.scene_supports_wave(jscene)
    assert not fsl.scene_supports_single_lobe(tscene)
    assert not tfk.scene_supports_fused(tscene)


def test_interior_crop_matches_reference(interior):
    """A 16x16 centre crop at depth 4, sample 0: the port's general path
    (through the kernels' plain versions) and wave path against
    pbrs_tpu's general path per lane, with equal ray counts. pbrs_tpu's
    general path traces the instance groups only through its dispatch's
    trace functions (its default tracer sees scene.geom alone)."""
    tscene, jscene = interior
    w, h = jscene.camera.width, jscene.camera.height
    ys, xs = np.mgrid[h // 2 - CROP // 2:h // 2 + CROP // 2,
                      w // 2 - CROP // 2:w // 2 + CROP // 2]
    pix = (ys * w + xs).ravel().astype(np.int32)
    isect, occl = jdispatch.make_trace_fns(jscene, use_pallas=False)
    want, cnt_j = jwf.render_samples(jscene, jsmp.PCGSampler(0),
                                     jnp.asarray(pix), 0, max_depth=DEPTH,
                                     msaa=2, intersect_fn=isect,
                                     occlude_fn=occl, return_ray_count=True)
    want = np.asarray(want)
    assert np.isfinite(want).all() and want.sum() > 0
    tpix = torch.from_numpy(pix)
    results = {"wave": fw.FusedWaveIntegrator(tscene).render_samples(
        tsmp.PCGSampler(0), tpix, 0, max_depth=DEPTH, msaa=2)}
    _, fn = render.make_integrator(tscene, tsmp.PCGSampler(0), DEPTH, 2,
                                   "general")
    results["general"] = fn(tpix, 0)
    for name, (rad, cnt) in results.items():
        np.testing.assert_allclose(rad.numpy(), want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        assert int(cnt) == int(cnt_j), name


def _jax_with_resolution(scene, w, h):
    """pbrs_tpu/cli.py's --resolution camera resize."""
    from pbrs_tpu.geometry import camera as jcam

    cam = scene.camera
    fresh = jcam.make_camera((w, h), 40.0)
    return scene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * ((cam.width // 2) / (w // 2)),
        b=cam.b * ((cam.height // 2) / (h // 2)), c=cam.c))


def test_interior_card_lanes_split_both_ways(interior):
    """The lanes of the interior (1024^2, depth 5, sample 0) where the
    wave and general paths part on the card, rendered on the CPU through
    pbrs_tpu's general path and the port's two paths. A rounding decides
    each of them (two surfaces at one t, a Fresnel or lobe choice, a test
    at its threshold): on the CPU the port's two paths agree on most, and
    pbrs_tpu's general path sides with the card's wave path on some and
    with the card's general path on others, so neither card path is the
    one that departs from the reference."""
    import json

    from pbrs_tpu_torch import cli

    with open(CARD_LANES) as f:
        card = json.load(f)
    (w, h), depth = card["resolution"], card["depth"]
    pix = np.asarray([ln["pixel"] for ln in card["lanes"]], np.int32)
    card_w = np.asarray([ln["wave"] for ln in card["lanes"]], np.float32)
    card_g = np.asarray([ln["general"] for ln in card["lanes"]], np.float32)
    tscene, jscene = interior
    jscene = _jax_with_resolution(jscene, w, h)
    tscene = cli.with_resolution(tscene, w, h)
    isect, occl = jdispatch.make_trace_fns(jscene, use_pallas=False)
    want = np.asarray(jwf.render_samples(
        jscene, jsmp.PCGSampler(0), jnp.asarray(pix), 0, max_depth=depth,
        msaa=card["msaa"], intersect_fn=isect, occlude_fn=occl))
    tpix = torch.from_numpy(pix)
    wave = fw.FusedWaveIntegrator(tscene).render_samples(
        tsmp.PCGSampler(0), tpix, 0, max_depth=depth,
        msaa=card["msaa"])[0].numpy()
    _, fn = render.make_integrator(tscene, tsmp.PCGSampler(0), depth,
                                   card["msaa"], "general")
    general = fn(tpix, 0)[0].numpy()

    def same(a, b):
        return np.isclose(a, b, atol=ATOL, rtol=RTOL).all(axis=1)

    n = len(pix)
    assert np.isfinite(want).all() and not same(card_w, card_g).any()
    assert same(wave, general).sum() >= 0.6 * n
    only_w = (same(want, card_w) & ~same(want, card_g)).sum()
    only_g = (same(want, card_g) & ~same(want, card_w)).sum()
    both = (same(want, card_g) & same(want, card_w)).sum()
    print(f"{n} card lanes: the port's CPU paths agree on "
          f"{same(wave, general).sum()}; pbrs_tpu's general path equals the "
          f"card's wave path alone on {only_w}, its general path alone on "
          f"{only_g}, both on {both}, neither on {n - only_w - only_g - both}"
          f"; the port's CPU general path on {same(want, general).sum()}")
    assert min(only_w, only_g) >= 0.25 * (only_w + only_g) > 0, (only_w,
                                                                  only_g)


def test_cli_renders_pbrt_file_on_cpu(tmp_path, capsys):
    from pbrs_tpu_torch import cli
    from pbrs_tpu_torch.io import image

    path = tmp_path / "box.pbrt"
    path.write_text(CORNELL_PBRT)
    out = str(tmp_path / "box.png")
    rc = cli.main(["--pbrt_file", str(path), "--resolution", "16x16",
                   "--msaa", "1", "--depth", "2", "--device", "cpu",
                   "--output", out])
    img = image.read_png(out)
    assert rc == 0 and img.shape == (16, 16, 3) and img.mean() > 0
    assert "plain path on cpu" in capsys.readouterr().out
