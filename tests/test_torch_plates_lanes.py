"""The plates lanes where K3 and the general path part on the card
(tests/plates_card_lanes.json), rendered on the CPU through both routes of
the port and of pbrs_tpu (its K3 in interpret mode); lane_diff's fused
route.

On these lanes a rounding decides the value, in one of two classes:

- "cone": both sides carry the same terms and differ by at most one ulp
  of the smallest sphere light's cone pdf, 1 / (2 pi (1 - cos theta_max)).
  That light (radius 0.2, ~20 units away) keeps 1 - cos theta_max near
  5e-5, so one ulp of cos theta_max moves the pdf, and the lane, by up to
  CONE_ULP = 2^-24 / (1 - cos theta_max) at the plate farthest from it
  (1.3e-3). Two float orders of |p - c|^2 (XLA's fused dot against
  PyTorch's sum of products, or K3 against the general path) land on
  neighbouring floats of cos theta_max.
- "arm": a whole term is on one side only (the other side's lane is 0):
  an arm's validity test went the other way.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import torch

from pbrs_tpu.accel import fused_single_lobe as jfsl
from pbrs_tpu.core import sampler as jsmp
from pbrs_tpu.geometry import camera as jcam
from pbrs_tpu.integrators import wavefront as jwf
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import cli, lane_diff, render
from pbrs_tpu_torch.accel import fused_single_lobe as fsl
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.scene import presets
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

CARD_LANES = os.path.join(os.path.dirname(__file__), "plates_card_lanes.json")


def _cone_ulp(scene):
    """2^-24 / (1 - cos theta_max) of the smallest sphere light, at the
    glossy plate (quads 2..) centre farthest from it."""
    g = scene.geom
    r = g.sph_radius.numpy().ravel()
    j = int(np.argmin(r))
    c = g.sph_center.numpy()[j].astype(np.float64)
    ctr = (g.quad_origin.numpy() + 0.5 * g.quad_u.numpy()
           + 0.5 * g.quad_v.numpy())[2:].astype(np.float64)
    d2 = ((ctr - c) ** 2).sum(1)
    return float((2.0 ** -24 / (1 - np.sqrt(1 - r[j] ** 2 / d2))).max())


def _classes(a, b, same, cone):
    """{lane: "cone" | "arm" | None} for the lanes where a and b part."""
    out = {}
    for i in np.flatnonzero(~same(a, b)):
        if (a[i] == 0).all() != (b[i] == 0).all():
            out[i] = "arm"
        elif (np.abs(a[i] - b[i]) <= cone * np.abs(b[i])).all():
            out[i] = "cone"
        else:
            out[i] = None
    return out


def test_plates_card_lanes_split_both_ways():
    """A sample of the plates lanes (1024^2, depth 5, msaa 2, sample 0)
    where K3 and the general path part on the card (lane_diff --route
    fused), on the CPU through the port's K3 plain version and general
    path and pbrs_tpu's K3 (interpret mode) and general path. The port's
    CPU general path gives the card's general-path value; every lane where
    a port route parts from pbrs_tpu's same route, or pbrs_tpu's two
    routes part, is a "cone" or an "arm" lane; and pbrs_tpu's general path
    sides with the card's K3 on some lanes and with the card's general
    path on others, so neither card path is the one that departs from the
    reference."""
    with open(CARD_LANES) as f:
        card = json.load(f)
    (w, h), depth, msaa = card["resolution"], card["depth"], card["msaa"]
    pix = np.asarray([ln["pixel"] for ln in card["lanes"]], np.int32)
    card_f = np.asarray([ln["fused"] for ln in card["lanes"]], np.float32)
    card_g = np.asarray([ln["general"] for ln in card["lanes"]], np.float32)
    jscene = jpresets.plates()
    cam = jscene.camera
    fresh = jcam.make_camera((w, h), 40.0)
    jscene = jscene.replace(camera=fresh.replace(
        center=cam.center, orientation=cam.orientation,
        a=cam.a * ((cam.width // 2) / (w // 2)),
        b=cam.b * ((cam.height // 2) / (h // 2)), c=cam.c))
    jgen = np.asarray(jwf.render_samples(
        jscene, jsmp.PCGSampler(0), jnp.asarray(pix), 0, max_depth=depth,
        msaa=msaa))
    jk3 = np.asarray(jfsl.FusedSingleLobeIntegrator(
        jscene, interpret=True).render_samples(
            jsmp.PCGSampler(0), jnp.asarray(pix), 0, max_depth=depth,
            msaa=msaa))
    tscene = cli.with_resolution(presets.plates(), w, h)
    tpix = torch.from_numpy(pix)
    _, fn = render.make_integrator(tscene, tsmp.PCGSampler(0), depth, msaa,
                                   "general")
    gen = fn(tpix, 0)[0].numpy()
    k3 = fsl.FusedSingleLobeIntegrator(tscene).render_samples(
        tsmp.PCGSampler(0), tpix, 0, max_depth=depth, msaa=msaa)[0].numpy()

    def same(a, b):
        return np.isclose(a, b, atol=card["atol"], rtol=card["rtol"]).all(1)

    n = len(pix)
    cone = _cone_ulp(tscene)
    assert np.isfinite(jgen).all() and np.isfinite(jk3).all()
    assert not same(card_f, card_g).any()
    assert same(gen, card_g).sum() >= 0.9 * n
    pairs = {"K3 port/pbrs_tpu": (k3, jk3),
             "general port/pbrs_tpu": (gen, jgen),
             "pbrs_tpu K3/general": (jk3, jgen),
             "port K3/general": (k3, gen)}
    for name, (a, b) in pairs.items():
        cls = _classes(a, b, same, cone)
        counts = {c: list(cls.values()).count(c) for c in ("cone", "arm")}
        print(f"{name}: part on {len(cls)} of {n} lanes {counts} "
              f"(cone ulp {cone:.3g})")
        assert None not in cls.values(), (name, [
            (int(pix[i]), a[i].tolist(), b[i].tolist())
            for i, c in cls.items() if c is None])
    only_f = (same(jgen, card_f) & ~same(jgen, card_g)).sum()
    only_g = (same(jgen, card_g) & ~same(jgen, card_f)).sum()
    print(f"pbrs_tpu's general path equals the card's K3 alone on {only_f}, "
          f"the card's general path alone on {only_g}, neither on "
          f"{n - only_f - only_g}")
    assert min(only_f, only_g) >= 0.25 * (only_f + only_g) > 0, (only_f,
                                                                  only_g)


def test_lane_diff_fused_route():
    """lane_diff's fused route on the CPU (K3's plain version beside the
    general path): every lane of a small plates view is classified, the
    fused path's bounces are logged, and lanes that agree read "same"."""
    scene = cli.with_resolution(presets.plates(), 32, 32)
    paths = lane_diff._Paths(scene, fast="fused")
    pix = torch.arange(0, 1024, 37, dtype=torch.int32)
    _, log, occl = paths.render("fused", pix, 3, 2, log=True)
    assert len(log) == 3 and occl == []
    assert log[0][0].shape == (pix.shape[0], 3) and bool(log[0][1].all())
    lanes = lane_diff.classify(scene, pix, 3, 2, paths)
    assert [ln["pixel"] for ln in lanes] == pix.tolist()
    assert all(ln["how"] == "same" and len(ln["fused"]) == 3
               for ln in lanes)
