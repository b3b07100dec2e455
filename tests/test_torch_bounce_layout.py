"""The host side of the fused bounces K2 and K3 as the kernels lay out
their work: the window order in which they take a launch's lanes
(fused_kernel.regroup_reference: each window's live lanes in lane order,
then its dead ones); the shadow sweeps the plain versions log for the
bound (the lanes whose result depends on each sweep, as the kernels'
guards say); K3's shading-class table against K4's key; the bank column
the kernels stage a quad's 1 / |n|^2 into; the bank-row ceiling K2's
eligibility routes by; and the bit transform that gives Sobol' dimension
1 in csrc/bounce_common.cuh. Inputs come from numpy seeds; everything
runs on the CPU."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pbrs_tpu_torch import cli, kernels
from pbrs_tpu_torch.accel import fused_kernel as fk
from pbrs_tpu_torch.accel import fused_single_lobe as fsl
from pbrs_tpu_torch.accel import fused_wave as fw
from pbrs_tpu_torch.accel import trace_kernel as tk
from pbrs_tpu_torch.core import sampler as smp
from pbrs_tpu_torch.geometry import camera as cam_mod
from pbrs_tpu_torch.integrators import wavefront
from pbrs_tpu_torch.scene import presets
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

SAMPLERS = {"pcg": smp.PCGSampler, "sobol": smp.SobolSampler}


def _cornell(size):
    cam = cam_mod.looking_at(cam_mod.make_camera((size, size), 40.0),
                             (278, 278, -800), (278, 278, 0), (0, 1, 0))
    return presets.cornell_box().replace(camera=cam)


def _scene(kind, size):
    if kind == "cornell":
        return _cornell(size)
    return cli.with_resolution(presets.PRESETS["plates"](), size, size)


def _launch(kind, size, bounce, rng):
    """(tables, lane tensors, keywords) of the plain bounce `bounce` of
    sample 0, reached through the plain versions from the camera rays:
    K2 lanes (fin, alive, pix, samp) on Cornell, K3 lanes (fin, alive,
    spec, pix, samp) on plates."""
    scene = _scene(kind, size)
    n = size * size
    pix = torch.arange(n, dtype=torch.int32)
    samp = torch.zeros(n, dtype=torch.int32)
    rays = wavefront.camera_rays(scene, SAMPLERS[rng](0), pix, 0, 2)
    fin = torch.cat([rays.origin.T, rays.dir.T, torch.ones(3, n)])
    alive = torch.ones(n, dtype=torch.int32)
    spec = torch.zeros(n, dtype=torch.int32)
    k2 = kind == "cornell"
    tab = (fk.FusedTables.from_scene(scene) if k2
           else fsl.SingleLobeTables.from_scene(scene))
    for b in range(bounce + 1):
        kw = dict(seed=0, bounce=b, bounce_is_first=b == 0, rr_active=b > 3,
                  rng=rng)
        lanes = ((fin, alive, pix, samp) if k2
                 else (fin, alive, spec, pix, samp))
        if b == bounce:
            return tab, lanes, kw
        if k2:
            fout, alive, _ = fk.bounce_reference(tab, *lanes, **kw)
        else:
            fout, alive, spec, _ = fsl.bounce2_reference(tab, *lanes, **kw)
        fin = fout[3:].contiguous()


def _plain(tab):
    return (fk.bounce_reference if isinstance(tab, fk.FusedTables)
            else fsl.bounce2_reference)


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


@pytest.mark.parametrize("window", [32, 256, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_regroup_reference_is_a_stable_window_order(window, seed):
    rng = np.random.default_rng(seed)
    n = 3 * window + 77  # a partial last window
    alive = torch.from_numpy(
        (rng.uniform(size=n) < rng.uniform(0.01, 0.9)).astype(np.int32))
    order = fk.regroup_reference(alive, window)
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    for start in range(0, n, window):
        got = order[start:start + window]
        lanes = torch.arange(start, min(start + window, n))
        live, dead = lanes[alive[lanes] > 0], lanes[alive[lanes] <= 0]
        assert torch.equal(got, torch.cat([live, dead]))


@pytest.mark.parametrize("kind,size,bounce", [
    ("cornell", 32, 0), ("cornell", 32, 2), ("plates", 32, 0),
    ("plates", 32, 2)])
def test_shadow_log_names_the_lanes_each_sweep_decides(kind, size, bounce,
                                                       monkeypatch):
    """shadow_log hands the bound each shadow sweep's rays and the lanes the
    kernel sweeps (its guards): flipping the occlusion of every other lane
    leaves the bounce's outputs unchanged bit for bit."""
    tab, lanes, kw = _launch(kind, size, bounce, "pcg")
    plain = _plain(tab)
    log = []
    want = plain(tab, *lanes, **kw, shadow_log=log)
    assert len(log) == 2
    for planes, need in log:
        assert len(planes) == 7 and need.dtype == torch.bool
        assert not bool((need & ~(lanes[1] > 0)).any())
    assert bool(log[0][1].any())  # the light-sampled arm's sweep
    masks = iter([need for _, need in log])
    mod = fk if isinstance(tab, fk.FusedTables) else fsl
    real = mod._occluded

    def flipped(tab_, *ray):
        occ = real(tab_, *ray)
        return torch.where(next(masks), occ, ~occ)

    monkeypatch.setattr(mod, "_occluded", flipped)
    got = plain(tab, *lanes, **kw)
    for g, w in zip(got, want):
        assert torch.equal(_bits(torch.as_tensor(g)), _bits(torch.as_tensor(w)))


@pytest.mark.parametrize("name", ["plates", "two_perlin_spheres",
                                  "mixed_spheres", "env_mapped", "quad_light",
                                  "earth"])
def test_k3_class_table_is_k4s_shading_key(name):
    scene = cli.with_resolution(presets.PRESETS[name](), 8, 8)
    assert fsl.scene_supports_single_lobe(scene)
    tab = fsl.SingleLobeTables.from_scene(scene)
    got, n = fsl.shading_class_table(tab)
    slots = 2 if tab.two_slots else 1
    want, n_want = fw.shading_classes(
        scene.materials.kind[:, :slots].numpy())
    assert np.array_equal(got, want) and n == n_want
    assert got.shape == (tab.mats.shape[0] + 1,)
    # The table the kernel reads (SingleLobeTables.mat_class).
    assert tab.mat_class.dtype == torch.int32 and tab.n_classes == n
    assert np.array_equal(tab.mat_class.numpy(), want)


@pytest.mark.parametrize("kind", ["cornell", "plates"])
def test_quad_reciprocal_column_is_free_in_the_bank(kind):
    """The kernels stage a quad row's 1 / |n|^2 into column QUAD_RCP_COL
    (14) of their shared copy of the bank: a column no family fills, so
    nothing read from a row changes. The staged value is the plain sweep's
    1.0 / p(12)."""
    scene = _scene(kind, 8)
    tab = (fk.FusedTables.from_scene(scene) if kind == "cornell"
           else fsl.SingleLobeTables.from_scene(scene))
    assert torch.equal(tab.bank[:, 14], torch.zeros(tab.bank.shape[0]))
    q0, q1 = tab.counts[0], tab.counts[0] + tab.counts[1]
    n2 = tab.bank[q0:q1, 12]
    assert q1 > q0 and bool((n2 > 0).all())
    staged = torch.tensor([np.float32(1.0) / np.float32(v) for v in
                           n2.tolist()], dtype=torch.float32)
    assert torch.equal(_bits(staged), _bits(1.0 / n2))


def _spheres_scene(n_rows):
    """A floor, a quad light and small Lambert spheres: a K2 scene whose
    bank has n_rows rows (the empty triangle and disk families hold a
    padding row each)."""
    from pbrs_tpu_torch.scene.buffers import SceneBuilder

    b = SceneBuilder()
    g, m = b.geometry, b.materials
    g.add_quad((-12, 0, -12), (24, 0, 0), (0, 0, 24),
               m.add_lambertian((0.6, 0.55, 0.5)))
    red = m.add_lambertian((0.7, 0.3, 0.2))
    for i in range(n_rows - 4):
        g.add_sphere((-10 + 0.3 * (i % 64), 0.1, -10 + 0.3 * (i // 64)), 0.1,
                     red)
    light_c = (6.0, 6.0, 6.0)
    g.add_quad((-2, 7, -2), (4, 0, 0), (0, 0, 4), m.add_diffuse_light(light_c))
    b.lights.add_area_quad(light_c, (-2, 7, -2), (4, 0, 0), (0, 0, 4))
    b.camera = _cornell(8).camera
    return b.build()


def _header_int(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("over", [0, 1])
def test_k2_takes_banks_up_to_the_shared_memory_ceiling(over):
    """K2 stages its bank whole beside its static arrays: the host's ceiling
    is the one csrc/trace_flat.cuh computes, and a Lambert scene one row
    over it takes the general path."""
    text = (Path(kernels.__file__).parent / "csrc"
            / "trace_flat.cuh").read_text()
    rows = ((_header_int(text, "MAX_SMEM_BYTES")
             - _header_int(text, "STATIC_SMEM_RESERVE"))
            // (_header_int(text, "BANK_COLS") * 4))
    assert tk.MAX_BANK_ROWS == rows
    scene = _spheres_scene(rows + over)
    assert fk.FusedTables.from_scene(scene).bank.shape[0] == rows + over
    assert fk.scene_supports_fused(scene) == (not over)


def _sobol_dim1_transform(idx):
    """csrc/bounce_common.cuh:sobol_u32, dimension 1, on uint64 arrays."""
    y = idx.astype(np.uint64)
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF), (16, 0x0000FFFF)):
        y ^= (y >> np.uint64(shift)) & np.uint64(mask)
    out = np.zeros_like(y)
    for b in range(32):  # __brev
        out |= ((y >> np.uint64(b)) & np.uint64(1)) << np.uint64(31 - b)
    return out


def test_sobol_dimension_one_transform_equals_the_direction_numbers():
    rng = np.random.default_rng(11)
    idx = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.uint64),
                          np.arange(1024, dtype=np.uint64),
                          np.asarray([0xFFFFFFFF], np.uint64)])
    want = smp.sobol_u32(torch.from_numpy(idx.astype(np.int64)), 1)
    got = _sobol_dim1_transform(idx)
    assert np.array_equal(got.astype(np.int64),
                          (want.numpy().astype(np.int64) & 0xFFFFFFFF))
