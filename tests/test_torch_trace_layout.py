"""The data layouts of the trace kernels K1 and K5 and their host walks:
K1's packed, chunked bank (trace_kernel.pack_bank) and its chunk-culled
sweep (sweep_chunks_reference) against the plain sweep; K5's child-pair
node table walked on the host (treelet.traverse_reference) against its
plain sweep; the running hit handed to K5 against the merge the tracer
made before (closer = t2 < t); and the tracer against pbrs_tpu's
PallasTracer. Inputs come from numpy seeds; everything runs on the CPU."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import trace_pallas as jtp
from pbrs_tpu.geometry import ray as jray
from pbrs_tpu_torch.accel import bvh as tbvh
from pbrs_tpu_torch.accel import trace_kernel as tk
from pbrs_tpu_torch.accel import treelet as tl
from pbrs_tpu_torch.geometry import ray as tray
from pbrs_tpu_torch.scene import presets
from pbrs_tpu_torch.shapes import tables as ttables
from test_partition import _mixed_scene, _rays as _partition_rays
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

INF = float("inf")


def _rays(seed, n, lo, hi, t_scale, dead=0.1, bounded=0.3):
    """Rays from a box, pointing anywhere; some bounded, some dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    t_max = np.full(n, INF, np.float32)
    k = int(bounded * n)
    t_max[:k] = rng.uniform(0.0, t_scale, k)
    t_max[k:k + int(dead * n)] = 0.0
    return tray.make_rays(*(torch.from_numpy(x) for x in (o, d, t_max)))


def _bank_geom(name):
    """Flat banks: four families with exact duplicates (rows that tie in
    t), 1005 random spheres, Cornell, and everything's flat side."""
    rng = np.random.default_rng(7)
    if name == "duplicates":
        b = ttables.GeometryBuilder()
        p = lambda: rng.uniform(50, 500, 3)  # noqa: E731
        for _ in range(40):
            c, r = p(), rng.uniform(10, 60)
            o, u, v = p(), rng.normal(size=3) * 80, rng.normal(size=3) * 80
            t = (p(), p(), p())
            dc, dn, dr = p(), rng.normal(size=3), rng.normal(size=3) * 50
            for _ in range(2):  # each primitive twice, at two rows
                b.add_sphere(c, r, 0)
                b.add_quad(o, u, v, 0)
                b.add_triangle(*t, 0)
                b.add_disk(dc, dn, dr, 0)
        return b.build(), (0.0, 550.0), 900.0
    if name == "spheres_1005":
        b = ttables.GeometryBuilder()
        for c, r in zip(rng.uniform(-100, 100, (1005, 3)),
                        rng.uniform(1, 6, 1005)):
            b.add_sphere(c, r, 0)
        return b.build(), (-120.0, 120.0), 300.0
    if name == "cornell":
        return presets.cornell_box().geom, (0.0, 555.0), 900.0
    return presets.everything().geom, (-100.0, 600.0), 1200.0


def _flat(geom):
    tracer = tk.Tracer(geom, bvh_threshold=10**6 if sum(geom.counts) < 2000
                       else None)
    return tracer.flat


@pytest.mark.parametrize("name", ["duplicates", "spheres_1005", "cornell",
                                  "everything"])
def test_chunks_cover_every_row_once(name):
    """Each family's chunks cover its rows exactly once, each chunk's box
    holds its primitives, a packed row is its bank row bit for bit at the
    family's stride, and the ids are the bank's."""
    geom, _, _ = _bank_geom(name)
    flat = _flat(geom)
    bank = flat.bank.numpy()
    packed = flat.packed.numpy()
    lay = flat.layout.numpy()
    rows, chunks, offset = lay[0:4], lay[4:8], lay[8:12]
    assert tuple(rows) == flat.counts and tuple(chunks) == flat.chunks
    assert lay[13] == packed.size and packed.size % 4 == 0
    assert all(o % 4 == 0 for o in lay[8:13])
    table = packed[:tk.CHUNK_FLOATS * chunks.sum()].reshape(-1,
                                                            tk.CHUNK_FLOATS)
    meta = table[:, 6:8].copy().view(np.int32)
    ids = packed[lay[12]:lay[12] + rows.sum()].view(np.int32)
    np.testing.assert_array_equal(np.sort(ids),
                                  bank[:rows.sum(), 15].astype(np.int32))
    first_chunk = np.cumsum([0, *chunks])
    id_base = np.cumsum([0, *rows])
    for f in range(4):
        mine = meta[first_chunk[f]:first_chunk[f + 1]]
        covered = np.concatenate([np.arange(a, a + c) for a, c in mine]
                                 or [np.zeros(0, int)])
        assert np.array_equal(np.sort(covered), np.arange(rows[f]))
        assert (mine[:, 1] <= tk.CHUNK).all()
        stride = tk.FAMILY_STRIDE[f]
        fam_rows = packed[offset[f]:offset[f] + rows[f] * stride].reshape(
            -1, stride)
        fam_ids = ids[id_base[f]:id_base[f + 1]]
        want = bank[np.searchsorted(bank[:rows.sum(), 15], fam_ids)]
        np.testing.assert_array_equal(fam_rows.view(np.int32),
                                      want[:, :stride].view(np.int32))
        lo, hi = tk._row_boxes(f, fam_rows)
        for k, (a, c) in enumerate(mine):
            box = table[first_chunk[f] + k]
            assert (box[0:3] <= lo[a:a + c].min(0)).all()
            assert (box[3:6] >= hi[a:a + c].max(0)).all()


@pytest.mark.parametrize("name", ["duplicates", "spheres_1005", "cornell",
                                  "everything"])
def test_chunk_culled_sweep_equals_sweep(name):
    """The kernel's chunk-culled sweep, repeated on the host in shuffled
    chunk order, gives the plain sweep's t and ids bit for bit (exact ties
    between duplicated rows go to the lowest id), any hit its hit mask, and
    culls: fewer primitive tests than the full sweep."""
    geom, (lo, hi), t_scale = _bank_geom(name)
    flat = _flat(geom)
    rays = _rays(3, 768, lo, hi, t_scale)
    t_ref, id_ref = tk.trace_reference(flat.bank, flat.counts, rays)
    order = np.random.default_rng(5).permutation(sum(flat.chunks))
    t_c, id_c, _, prims = tk.sweep_chunks_reference(flat, rays, order)
    assert torch.equal(t_c.view(torch.int32), t_ref.view(torch.int32))
    assert torch.equal(id_c, id_ref)
    t_k, id_k, _, _ = tk.sweep_chunks_reference(flat, rays)
    assert torch.equal(t_k, t_ref) and torch.equal(id_k, id_ref)
    t_a = tk.sweep_chunks_reference(flat, rays, any_hit=True)[0]
    assert torch.equal(torch.isfinite(t_a), torch.isfinite(t_ref))
    assert int(torch.isfinite(t_ref).sum()) > 30
    live = int((rays.t_max > 0).sum())
    assert sum(prims) < live * sum(flat.counts)
    if name == "duplicates":
        # Every primitive comes twice, at ids 2k and 2k + 1 (each family
        # starts at an even id): a hit is always on the lower one.
        hit = id_ref >= 0
        assert (id_ref[hit] % 2 == 0).all()


def test_pack_bank_needs_rising_ids():
    geom, _, _ = _bank_geom("cornell")
    bank, counts = tk.prim_scalars(geom)
    with pytest.raises(ValueError, match="rise"):
        tk.pack_bank(bank.flip(0).contiguous(), counts)
    with pytest.raises(ValueError, match="CUDA"):
        tk.trace_planes(tk.pack_bank(bank, counts), torch.zeros(7, 4))
    assert tk.LAUNCHES == 0


def _family(kind):
    rng = np.random.default_rng(11)
    if kind == "tri":
        p0 = rng.uniform(-5, 5, (900, 3)).astype(np.float32)
        p1 = p0 + rng.normal(size=(900, 3)).astype(np.float32) * 0.5
        p2 = p0 + rng.normal(size=(900, 3)).astype(np.float32) * 0.5
        return tl.tri_tracer(p0, p1, p2, 30)
    if kind == "quad":
        o = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
        u = rng.normal(size=(500, 3)).astype(np.float32) * 0.6
        v = rng.normal(size=(500, 3)).astype(np.float32) * 0.6
        return tl.quad_tracer(o, u, v, 7)
    c = rng.uniform(-6, 6, (600, 3)).astype(np.float32)
    if kind == "sphere":
        return tl.sphere_tracer(c, rng.uniform(0.1, 0.5, 600).astype(
            np.float32), 3)
    n = rng.normal(size=(600, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    radial = np.cross(n, rng.normal(size=(600, 3))).astype(np.float32)
    return tl.disk_tracer(c, n, radial * 0.3, 5)


def _seed_of(t_fam, id_fam, seed):
    """A running hit per lane: a miss, a hit nearer or farther than the
    family's, or one at exactly the family's t with a lower or a higher
    id (the flat-vs-family ties of the tracer)."""
    rng = np.random.default_rng(seed)
    n = t_fam.shape[0]
    pick = torch.from_numpy(rng.integers(0, 5, n))
    fin = torch.isfinite(t_fam)
    base = torch.where(fin, t_fam, torch.tensor(5.0))
    t_in = torch.stack([torch.full((n,), INF), base * 0.5, base * 2.0, base,
                        base])[pick, torch.arange(n)]
    id_in = torch.stack([torch.full((n,), -1), torch.full((n,), 1),
                         torch.full((n,), 2), torch.full((n,), 0),
                         torch.full((n,), 10**6)])[pick, torch.arange(n)]
    return t_in, id_in.to(torch.int32)


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["tri", "quad", "sphere", "disk"])
def test_pair_walk_equals_sweep(kind, builder, monkeypatch):
    """K5's walk over the child-pair table, repeated on the host, gives the
    plain sweep's t and ids bit for bit, unseeded and seeded with a
    running hit; any hit gives its hit mask and skips lanes whose running
    hit is finite."""
    if builder == "numpy":
        build = tbvh.build_bvh
        monkeypatch.setattr(tbvh, "build_bvh", lambda lo, hi: build(
            lo, hi, use_native=False))
    fam = _family(kind)
    if builder == "numpy":
        assert fam.builder == "numpy"
    rays = _rays(9, 512, -8.0, 8.0, 12.0)
    t_s, i_s = tl.trace_reference(fam, rays)
    t_w, i_w, nodes, prims = tl.traverse_reference(fam, rays)
    assert torch.equal(t_s.view(torch.int32), t_w.view(torch.int32))
    assert torch.equal(i_s, i_w)
    assert int(torch.isfinite(t_s).sum()) > 20
    assert prims < 0.5 * 512 * fam.n_prims
    t_in, id_in = _seed_of(t_s, i_s, 2)
    t_m, i_m = tl.trace_reference(fam, rays, t_in, id_in)
    t_v, i_v, nodes_s, _ = tl.traverse_reference(fam, rays, False, t_in,
                                                 id_in)
    assert torch.equal(t_m.view(torch.int32), t_v.view(torch.int32))
    assert torch.equal(i_m, i_v)
    assert nodes_s < nodes  # the running hit culls nodes
    t_a, _, _, prims_a = tl.traverse_reference(fam, rays, True, t_in, id_in)
    assert torch.equal(torch.isfinite(t_a), torch.isfinite(t_m))
    assert prims_a < prims


@pytest.mark.parametrize("kind", ["tri", "sphere"])
def test_seeded_merge_equals_closer_merge(kind):
    """The family trace seeded with a running hit equals the merge the
    tracer made before: the unseeded family hit taken where t2 < t, the
    running hit kept on equal t whatever the ids."""
    fam = _family(kind)
    rays = _rays(4, 512, -8.0, 8.0, 12.0)
    t2, i2 = tl.trace_reference(fam, rays)
    t_in, id_in = _seed_of(t2, i2, 6)
    closer = t2 < t_in
    want_t = torch.where(closer, t2, t_in)
    want_i = torch.where(closer, i2, id_in)
    got_t, got_i = tl.trace_reference(fam, rays, t_in, id_in)
    assert torch.equal(got_t, want_t) and torch.equal(got_i, want_i)
    tie = torch.isfinite(t2) & (t_in == t2)
    assert int(tie.sum()) > 20
    assert torch.equal(got_i[tie], id_in[tie])
    # Dead lanes keep their running hit.
    dead = rays.t_max <= 0
    assert torch.equal(got_i[dead], id_in[dead])


def _old_trace(tracer, rays):
    """The tracer's result as the two-step merge computed it before."""
    t, idx = tk.trace_reference(tracer.bank, tracer.counts, rays)
    for fam in tracer.families:
        t2, idx2 = tl.trace_reference(fam, rays)
        closer = t2 < t
        t, idx = torch.where(closer, t2, t), torch.where(closer, idx2, idx)
    return t, idx


@pytest.mark.parametrize("name", ["mixed", "mesh_ball"])
def test_tracer_keeps_its_merge_and_matches_pallas(name):
    """Tracer's CPU path (K1's plain sweep seeding each family's) equals
    the explicit closer-t merge, and agrees with pbrs_tpu's PallasTracer
    in interpret mode as tests/test_torch_bvh_trace.py checks it."""
    if name == "mixed":
        jgeom = _mixed_scene()
        tgeom = ttables.GeometryTables(**{
            f.name: torch.from_numpy(np.array(getattr(jgeom, f.name)))
            for f in dataclasses.fields(ttables.GeometryTables)})
        thresh = 256
        jr = _partition_rays(512)
        rays = tray.make_rays(*(torch.from_numpy(np.array(x)) for x in (
            jr.origin, jr.dir, jr.t_max)))
    else:
        from pbrs_tpu.scene import presets as jpresets

        jgeom = jpresets.mesh_ball(levels=3).geom
        tgeom = presets.mesh_ball(levels=3).geom
        thresh = 64
        rays = _rays(8, 512, -3.0, 3.0, 4.0)
        jr = jray.RayBatch(*(jnp.asarray(x.numpy()) for x in (
            rays.origin, rays.dir, rays.t_max)))
    tracer = tk.Tracer(tgeom, bvh_threshold=thresh)
    assert tracer.families and tracer.flat_rows
    t, idx = tracer.trace(rays)
    t_old, idx_old = _old_trace(tracer, rays)
    assert torch.equal(t, t_old) and torch.equal(idx, idx_old)
    occ = tracer.occluded(rays)
    assert torch.equal(occ, torch.isfinite(t_old))
    jt = jtp.PallasTracer(jgeom, interpret=True, bvh_threshold=thresh)
    t_j, i_j = (np.asarray(x) for x in jt.trace(jr))
    fin = np.isfinite(t.numpy())
    np.testing.assert_array_equal(fin, np.isfinite(t_j))
    assert fin.any()
    np.testing.assert_allclose(t.numpy()[fin], t_j[fin], rtol=2e-5,
                               atol=2e-5)
    assert (idx.numpy()[fin] == i_j[fin]).mean() >= 0.995


def test_big_leaves_split_into_pairs(monkeypatch):
    """Leaves above treelet.LEAF_MAX primitives (what a builder leaves
    below depth 60; forced here with leaves of up to 40) become pairs of
    halves in the leaf's box: every leaf of the table holds at most
    LEAF_MAX, the stack covers the deeper walk, and the walk still finds
    the sweep's hits bit for bit."""
    build = tbvh.build_bvh
    monkeypatch.setattr(tbvh, "build_bvh", lambda lo, hi: build(
        lo, hi, max_leaf=40))
    fam = _family("tri")
    kids = fam.nodes[:, 12:16].contiguous().view(torch.int32).numpy()
    counts = kids[:, 1::2]
    assert counts.max() <= tl.LEAF_MAX
    assert fam.stack_depth > fam.depth
    rays = _rays(12, 512, -8.0, 8.0, 12.0)
    t_s, i_s = tl.trace_reference(fam, rays)
    t_w, i_w, _, _ = tl.traverse_reference(fam, rays)
    assert torch.equal(t_s.view(torch.int32), t_w.view(torch.int32))
    assert torch.equal(i_s, i_w)
    assert int(torch.isfinite(t_s).sum()) > 20
