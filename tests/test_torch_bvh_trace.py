"""The port's BVH family trace (K5's plain version and its host walk) and
its flat + BVH tracer against pbrs_tpu's treelet tracer (both kernels,
interpret mode) and PallasTracer, on inputs made from numpy seeds."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import trace_pallas as jtp
from pbrs_tpu.accel import treelet as jtl
from pbrs_tpu.geometry import ray as jray
from pbrs_tpu.scene import subdivision as jsub
from pbrs_tpu_torch.accel import trace_kernel as tk
from pbrs_tpu_torch.accel import treelet as tl
from pbrs_tpu_torch.geometry import ray as tray
from pbrs_tpu_torch.scene import presets
from pbrs_tpu_torch.shapes import tables as ttables
from test_partition import _mixed_scene, _rays as _partition_rays


def _mesh(levels):
    """tests/test_treelet.py's octahedron sphere of radius 2."""
    pos = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                    [0, 0, 1], [0, 0, -1]], np.float32)
    idx = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                    [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    pos, idx = jsub.loop_subdivide(pos, idx, levels)
    pos = pos / np.linalg.norm(pos, axis=1, keepdims=True) * 2.0
    return pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]


def _rays(seed, n, center, spread, tmax_frac=0.3, dead_frac=0.1):
    """tests/test_treelet.py's rays aimed near `center`, some bounded, some
    dead (t_max 0)."""
    rng = np.random.default_rng(seed)
    o = (center + rng.standard_normal((n, 3)) * spread).astype(np.float32)
    d = (center - o) + rng.standard_normal((n, 3)).astype(np.float32) * 2.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.full(n, 1e30, np.float32)
    k = int(n * tmax_frac)
    t_max[:k] = rng.uniform(5.0, 12.0, k)
    t_max[k:k + int(n * dead_frac)] = 0.0
    return o, d, t_max


def _both(o, d, t_max):
    return (jray.RayBatch(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)),
            tray.make_rays(torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(t_max)))


def _family(kind, seed=3):
    """(port tracer, reference tracer factory) for one family at a numpy
    seed; the reference factory takes the treelet size."""
    rng = np.random.default_rng(seed)
    if kind == "tri":
        p = _mesh(3)
        return (tl.tri_tracer(*p, 17),
                lambda t: jtl.tri_tracer(*p, 17, interpret=True, treelet=t),
                np.zeros(3), 6.0)
    if kind == "sphere":
        c = rng.uniform(-6, 6, (700, 3)).astype(np.float32)
        r = rng.uniform(0.1, 0.6, 700).astype(np.float32)
        return (tl.sphere_tracer(c, r, 0),
                lambda t: jtl.sphere_tracer(c, r, 0, interpret=True,
                                            treelet=t),
                np.zeros(3), 9.0)
    qo = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    qu = rng.standard_normal((300, 3)).astype(np.float32) * 0.8
    qv = rng.standard_normal((300, 3)).astype(np.float32) * 0.8
    return (tl.quad_tracer(qo, qu, qv, 11),
            lambda t: jtl.quad_tracer(qo, qu, qv, 11, interpret=True,
                                      treelet=t),
            np.zeros(3), 8.0)


def _check_against_treelet(t_t, i_t, ta_t, t_j, i_j, ta_j):
    """tests/test_treelet.py's tolerance: hit and any-hit masks equal, t to
    rtol 1e-4 / atol 1e-5, ids equal on 99.5% of hit lanes (ties). ta_j is
    the reference's any-hit t, or None where only its closest hit ran."""
    fin = np.isfinite(t_t)
    np.testing.assert_array_equal(fin, np.isfinite(t_j))
    np.testing.assert_array_equal(np.isfinite(ta_t), fin)
    if ta_j is not None:
        np.testing.assert_array_equal(np.isfinite(ta_j), fin)
    assert fin.any() and not fin.all()
    np.testing.assert_allclose(t_t[fin], t_j[fin], rtol=1e-4, atol=1e-5)
    assert (i_t[fin] == i_j[fin]).mean() >= 0.995
    assert (i_t[~fin] == -1).all()


@pytest.mark.parametrize("mode", [None, "rowdense"], ids=["K5a", "K5b"])
@pytest.mark.parametrize("kind", ["tri", "sphere", "quad"])
def test_plain_version_matches_treelet_tracer(kind, mode):
    """Against both TPU kernels; the reference's any hit runs through K5a
    (its K5b any hit is the same contract, pinned by tests/test_rowdense.py
    against K5a)."""
    fam, ref, center, spread = _family(kind)
    jr, tr = _both(*_rays(7, 384, center, spread))
    t_t, i_t = (x.numpy() for x in tl.trace_reference(fam, tr))
    ta_t, _ = tl.traverse_reference(fam, tr, any_hit=True)[:2]
    jt = ref(jtl.TREELET)
    t_j, i_j = (np.asarray(x) for x in jt.trace(jr, mode=mode))
    ta_j = (np.asarray(jt.trace(jr, any_hit=True)[0]) if mode is None
            else None)
    _check_against_treelet(t_t, i_t, ta_t.numpy(), t_j, i_j, ta_j)


@pytest.mark.parametrize("mode", [None, "rowdense"], ids=["K5a", "K5b"])
def test_plain_version_matches_multi_chunk_treelets(mode):
    """tests/test_rowdense.py:63-68's multi-chunk case: 2500 thin
    triangles cut into treelets of 8."""
    rng = np.random.default_rng(0)
    p0 = rng.uniform(-1, 1, (2500, 3)).astype(np.float32) * np.float32(
        [50, 1, 1])
    p1 = p0 + rng.uniform(-0.2, 0.2, (2500, 3)).astype(np.float32)
    p2 = p0 + rng.uniform(-0.2, 0.2, (2500, 3)).astype(np.float32)
    jt = jtl.tri_tracer(p0, p1, p2, 0, interpret=True, treelet=8)
    assert jt.n_chunks > 1
    fam = tl.tri_tracer(p0, p1, p2, 0)
    rng = np.random.default_rng(1)
    o = rng.uniform(-60, 60, (512, 3)).astype(np.float32)
    # Aim at the triangles' corners, give or take, so that some rays hit.
    d = (p0[rng.integers(0, 2500, 512)] - o
         + rng.normal(size=(512, 3)).astype(np.float32) * 0.3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jr, tr = _both(o, d.astype(np.float32), np.full(512, 3e38, np.float32))
    t_t, i_t = (x.numpy() for x in tl.trace_reference(fam, tr))
    ta_t = tl.traverse_reference(fam, tr, any_hit=True)[0].numpy()
    t_j, i_j = (np.asarray(x) for x in jt.trace(jr, mode=mode))
    ta_j = (np.asarray(jt.trace(jr, any_hit=True)[0]) if mode is None
            else None)
    _check_against_treelet(t_t, i_t, ta_t, t_j, i_j, ta_j)


def _scene_family(name):
    geom = (presets.mesh_ball(levels=4) if name == "mesh_ball"
            else presets.everything()).geom
    tracer = tk.Tracer(geom)
    assert len(tracer.families) == 1
    return tracer.families[0]


@pytest.mark.parametrize("case", ["tri", "sphere", "quad", "disk",
                                  "mesh_ball", "everything"])
def test_walk_equals_sweep(case):
    """The kernel's walk, repeated on the host, finds exactly the sweep's t
    and ids (closest hit) and its hit mask (any hit): the conservative node
    tests cull no hit. everything's abutting cuboids have coplanar faces,
    so its lanes can hold exact-t ties, which both settle by lowest id."""
    rng = np.random.default_rng(11)
    if case == "disk":
        c = rng.uniform(-6, 6, (600, 3)).astype(np.float32)
        n = rng.normal(size=(600, 3)).astype(np.float32)
        radial = np.cross(n, rng.normal(size=(600, 3))).astype(np.float32)
        fam = tl.disk_tracer(c, n / np.linalg.norm(n, axis=1)[:, None],
                             radial * 0.3, 5)
        o, d, t_max = _rays(2, 512, np.zeros(3), 9.0)
    elif case in ("mesh_ball", "everything"):
        fam = _scene_family(case)
        center = (np.zeros(3) if case == "mesh_ball"
                  else np.array([0.0, 50.0, 0.0]))
        spread = 3.0 if case == "mesh_ball" else 600.0
        o, d, t_max = _rays(2, 512, center, spread)
        t_max = np.where(t_max < 1e30, t_max * spread, t_max).astype(
            np.float32)
    else:
        fam, _, center, spread = _family(case)
        o, d, t_max = _rays(2, 512, center, spread)
    _, tr = _both(o, d, t_max)
    t_s, i_s = tl.trace_reference(fam, tr)
    t_w, i_w, nodes, prims = tl.traverse_reference(fam, tr)
    assert torch.equal(t_s, t_w) and torch.equal(i_s, i_w)
    t_a = tl.traverse_reference(fam, tr, any_hit=True)[0]
    assert torch.equal(torch.isfinite(t_a), torch.isfinite(t_s))
    assert torch.isfinite(t_s).sum() > 20
    assert (i_s[t_max <= 0] == -1).all()
    # The walk visits a fraction of the family, not all of it.
    live = int((torch.from_numpy(t_max) > 0).sum())
    assert nodes > live and prims < 0.5 * live * fam.n_prims


def test_tables_hold_the_tree():
    """Leaf slots cover every primitive once, interior nodes point to their
    right child, and each slot's id maps back to its primitive."""
    p = _mesh(3)
    fam = tl.tri_tracer(*p, 40)
    meta = fam.nodes[:, 6:8].contiguous().view(torch.int32).numpy()
    leaf = meta[:, 1] > 0
    slots = np.concatenate([np.arange(f, f + c) for f, c in meta[leaf]])
    assert np.array_equal(np.sort(slots), np.arange(fam.n_prims))
    assert (meta[~leaf, 0] > np.nonzero(~leaf)[0]).all()
    assert fam.depth <= tl.MAX_STACK and fam.builder in ("native", "numpy")
    gid = fam.slot_gid.numpy()
    fields = fam.fields.numpy()[:, :9]
    want = np.concatenate(p, 1)[gid - 40]
    np.testing.assert_array_equal(fields, want)
    # Boxes are padded outward around their primitives.
    assert (fam.nodes[0, 0:3].numpy() < np.min(np.stack(p), axis=(0, 1))).all()
    assert (fam.nodes[0, 3:6].numpy() > np.max(np.stack(p), axis=(0, 1))).all()


def test_id_map_gives_global_ids():
    p = _mesh(2)
    ids = np.arange(p[0].shape[0]) * 3 + 1000
    fam = tl.tri_tracer(*p, ids)
    assert set(fam.slot_gid.numpy().tolist()) == set(ids.tolist())


def test_partitioned_tracer_matches_pallas_tracer():
    """tests/test_partition.py:56-84 on the port, with its geometry carried
    across: a dense mesh in a room shell, BVH threshold 256, so the shell
    stays in the flat bank and the mesh goes to K5."""
    jgeom = _mixed_scene()
    tgeom = ttables.GeometryTables(**{
        f.name: torch.from_numpy(np.array(getattr(jgeom, f.name)))
        for f in dataclasses.fields(ttables.GeometryTables)})
    tr = tk.Tracer(tgeom, bvh_threshold=256)
    jt = jtp.PallasTracer(jgeom, interpret=True, bvh_threshold=256)
    assert tuple(tr.counts) == tuple(jt.counts)
    assert 0 < tr.counts[2] <= tk.PARTITION_MAX_FLAT and len(tr.families) == 1
    jr = _partition_rays(1024)
    rays = tray.make_rays(*(torch.from_numpy(np.array(x)) for x in (
        jr.origin, jr.dir, jr.t_max)))
    t_t, i_t = (x.numpy() for x in tr.trace(rays))
    t_j, i_j = (np.asarray(x) for x in jt.trace(jr))
    fin = np.isfinite(t_t)
    np.testing.assert_array_equal(fin, np.isfinite(t_j))
    np.testing.assert_allclose(t_t[fin], t_j[fin], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(i_t, i_j)
    # Global ids through the bank column and the id map: the same winners
    # as an unpartitioned tracer, and the same occlusion.
    whole = tk.Tracer(tgeom, bvh_threshold=10**6)
    assert not whole.families
    np.testing.assert_array_equal(i_t, whole.trace(rays)[1].numpy())
    np.testing.assert_array_equal(tr.occluded(rays).numpy(),
                                  np.asarray(jt.occluded(jr)))


def test_partition_heuristic_matches_reference():
    rng = np.random.default_rng(4)
    cases = [np.concatenate([np.full(2000, 1e-4), np.full(10, 5.0)]),
             np.full(5000, 1e-3),
             np.concatenate([np.full(2000, 1e-4), np.full(500, 5.0),
                             np.full(3, 100.0)]),
             rng.lognormal(0.0, 3.0, 3000)]
    for area in cases:
        got, want = tk._partition_big(area, 1024), jtp._partition_big(area,
                                                                      1024)
        assert (got[0] is None) == (want[0] is None)
        if want[0] is not None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["everything", "mesh_ball"])
def test_bank_subsets_equal_reference(name):
    """The flat side of each mesh scene equals PallasTracer's bank: whole
    families left out, column 15 global ids."""
    from pbrs_tpu.scene import presets as jpresets

    kw = {"levels": 4} if name == "mesh_ball" else {}
    jgeom = jpresets.PRESETS[name](**kw).geom
    tr = tk.Tracer(presets.PRESETS[name](**kw).geom)
    jt = jtp.PallasTracer(jgeom, interpret=True)
    assert tuple(tr.counts) == tuple(jt.counts)
    np.testing.assert_array_equal(
        tr.bank.numpy(), np.stack([np.asarray(c) for c in jt.params], axis=1))
    assert len(tr.families) == len(jt.bvhs) == 1
    assert tr.families[0].kind == jt.bvhs[0].kind


def test_no_cuda_launch_on_cpu_and_no_other_device():
    fam = tl.tri_tracer(*_mesh(1), 0)
    rays = tray.make_rays(torch.zeros(4, 3, device="meta"),
                          torch.ones(4, 3, device="meta"))
    with pytest.raises(ValueError):
        fam.trace(rays)
    with pytest.raises(ValueError, match="CUDA"):
        tl.trace_planes(fam, torch.zeros(7, 4))
    _, tr = _both(*_rays(0, 64, np.zeros(3), 5.0))
    fam.trace(tr)
    tk.Tracer(presets.mesh_ball(levels=3).geom, bvh_threshold=64).trace(tr)
    assert tl.LAUNCHES == 0 and tk.LAUNCHES == 0


def test_numpy_builder_trees_trace_alike(monkeypatch):
    """The NumPy builder stores no right child in `first` (the native one
    does); the family tracer takes it from the left child's miss link, so a
    tree from either builder finds the sweep's hits. (pbrs_tpu's
    build_treelets reads `first` and fills no slot from a NumPy-built
    tree.)"""
    from pbrs_tpu_torch.accel import bvh as tbvh

    build = tbvh.build_bvh
    monkeypatch.setattr(tbvh, "build_bvh", lambda lo, hi: build(
        lo, hi, use_native=False))
    fam = tl.tri_tracer(*_mesh(3), 17)
    assert fam.builder == "numpy"
    _, tr = _both(*_rays(4, 512, np.zeros(3), 6.0))
    t_s, i_s = tl.trace_reference(fam, tr)
    t_w, i_w = tl.traverse_reference(fam, tr)[:2]
    assert torch.equal(t_s, t_w) and torch.equal(i_s, i_w)
    assert torch.isfinite(t_s).sum() > 50
