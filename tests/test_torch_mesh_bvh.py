"""The port's primitive-BVH walk (K6's plain version, accel/mesh_bvh.py)
against pbrs_tpu's mesh_pallas tracers in interpret mode, on the cases of
tests/test_bvh.py: the subdivided octahedron, each of the four kinds, the
native and the NumPy tree, and a poisoned pair table; the tracers'
default device; and the child-pair table and its plain walk against the
skip-link walk it replaced (`skip_walk`, below): the same hits bit for
bit and the same leaves.

Bar: idx equal and t within rtol 1e-5 on at least 99.9% of lanes (the
lane share of test_bvh.py:60-61, at a tighter t). The TPU kernel descends
a node when any lane of its 4096-lane tile wants it; the port's walk
descends on each lane's own slab test. A lane may part only where its own
slab test culls the leaf holding the reference's hit by rounding: each
parting lane is printed and must be such a case (`_rounding_cull`).
Any hit: the reference keeps improving a lane's hit while its tile is
unresolved, so only which lanes hit is compared, and every port hit must
be a real hit of its ray.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrs_tpu.accel import mesh_pallas as jmp
from pbrs_tpu.geometry import ray as jray
from pbrs_tpu.scene import subdivision as jsub
from pbrs_tpu_torch.accel import mesh_bvh as mb
from pbrs_tpu_torch.geometry import ray as tray
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

RTOL = 1e-5
SHARE = 0.999


def _mesh(levels):
    """tests/test_bvh.py's unit octahedron sphere."""
    pos = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                    [0, 0, 1], [0, 0, -1]], np.float32)
    idx = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                    [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int64)
    pos, idx = jsub.loop_subdivide(pos, idx, levels)
    pos = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    return pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]


def _shell_rays(seed, n, spread):
    """tests/test_bvh.py's rays from a radius-3 shell aimed inward."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0
    d = -o + rng.normal(size=(n, 3)).astype(np.float32) * spread
    return o, d


def _both(o, d):
    return (jray.make_rays(jnp.asarray(o), jnp.asarray(d)),
            tray.make_rays(torch.from_numpy(o), torch.from_numpy(d)))


def _slab64(box, o, d):
    """The slab test in float64 on the same inputs: (t_enter, t_exit)."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    inv = 1.0 / np.where(d == 0.0, 1e-30, d)
    t0 = (box[:3].astype(np.float64) - o) * inv
    t1 = (box[3:6].astype(np.float64) - o) * inv
    return np.minimum(t0, t1).max(), np.maximum(t0, t1).min()


def _rounding_cull(tracer, o, d, gid_ref, t_ref):
    """True where the reference's hit lies in a leaf that the lane's own
    float32 slab test culls on the way down while the same test in float64
    (with the reference's t as the limit) keeps every node of that path:
    the lane parts by rounding at a box face."""
    tree = tracer.bvh
    boxes = np.concatenate([tree.bbox_min, tree.bbox_max], 1)
    slot = int(np.nonzero(tracer.slot_gid.numpy() == gid_ref)[0][0])
    count = np.where(tree.is_leaf > 0, tree.count, 0)
    leaf = int(np.nonzero((count > 0) & (tree.first <= slot)
                          & (slot < tree.first + count))[0][0])
    path = [i for i in range(leaf) if tree.skip[i] > leaf] + [leaf]
    planes = tray.to_planes(tray.make_rays(torch.from_numpy(o[None]),
                                           torch.from_numpy(d[None])))
    o32, inv = planes[0:3, 0], 1.0 / torch.where(planes[3:6, 0] == 0.0,
                                                 1e-30, planes[3:6, 0])
    culled32 = False
    for i in path:
        box = torch.from_numpy(boxes[i])
        t0 = (box[:3] - o32) * inv
        t1 = (box[3:6] - o32) * inv
        te = torch.minimum(t0, t1).max()
        tx = torch.maximum(t0, t1).min()
        culled32 |= not bool((te <= tx) & (tx >= mb.T_MIN) & (te < 3.0e38))
        te64, tx64 = _slab64(boxes[i], o, d)
        if not (te64 <= tx64 * (1 + 1e-12) and te64 <= t_ref * (1 + 1e-5)):
            return False
    return culled32


def _compare(tracer, o, d, t_ref, i_ref, t_got, i_got, any_hit):
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    t_got, i_got = t_got.numpy(), i_got.numpy()
    if any_hit:
        agree = np.isinf(t_ref) == np.isinf(t_got)
        hit = np.nonzero(np.isfinite(t_got))[0]
        if hit.size:
            # Every port hit is a real hit of its ray at its t.
            gids = tracer.slot_gid.numpy()
            slot_of = np.zeros(gids.max() + 1, np.int64)
            slot_of[gids] = np.arange(gids.size)
            row = tracer.fields[torch.from_numpy(slot_of[i_got[hit]])]
            r = [torch.from_numpy(x[hit])[:, None] for x in
                 (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]
            t_chk = mb.prim_t(tracer.kind, lambda k: row[:, None, k], *r,
                              torch.full((hit.size, 1), float("inf")))
            np.testing.assert_array_equal(t_chk[:, 0].numpy(), t_got[hit])
    else:
        both_inf = np.isinf(t_ref) & np.isinf(t_got)
        agree = (i_ref == i_got) & (both_inf | np.isclose(
            t_got, t_ref, rtol=RTOL, atol=0.0))
    part = np.nonzero(~agree)[0]
    print(f"lanes parting from mesh_pallas: {part.size} of {agree.size}")
    assert agree.mean() >= SHARE, agree.mean()
    for lane in part:
        assert i_ref[lane] >= 0 and _rounding_cull(
            tracer, o[lane], d[lane], int(i_ref[lane]), float(t_ref[lane])), (
            lane, t_ref[lane], i_ref[lane], t_got[lane], i_got[lane])


@pytest.fixture(scope="module")
def octahedron():
    """Level-2 octahedron (512 triangles), 512 shell rays, both tracers
    and the reference's closest and any hits."""
    p0, p1, p2 = _mesh(2)
    o, d = _shell_rays(0, 512, 0.8)
    jr, tr = _both(o, d)
    jt = jmp.MeshBVHTracer(p0, p1, p2, global_base=0, interpret=True)
    ref = {ah: jt.trace(jr, any_hit=ah) for ah in (False, True)}
    return (mb.MeshBVHTracer(p0, p1, p2, global_base=0, device="cpu"), o,
            d, tr, ref)


@pytest.mark.parametrize("any_hit", [False, True])
def test_octahedron_matches_interpret_kernel(octahedron, any_hit):
    tracer, o, d, tr, ref = octahedron
    t, idx = tracer.trace(tr, any_hit=any_hit)
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    _compare(tracer, o, d, *ref[any_hit], t, idx, any_hit)
    # The sort is an order of lanes only: the unsorted walk agrees.
    t2, i2 = tracer.trace(tr, any_hit=any_hit, sort_rays=False)
    np.testing.assert_array_equal(i2.numpy(), idx.numpy())
    np.testing.assert_array_equal(t2.numpy(), t.numpy())


def _kind_inputs(kind, seed=5, n=96):
    """(slot columns, bbox lo, bbox hi) of n random primitives of a kind
    in [-2, 2]^3, gid = 100 + index."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    gid = (100 + np.arange(n)).astype(np.float32)
    if kind == mb.KIND_TRI:
        p1 = (c + rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
        p2 = (c + rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
        cols = jmp.tri_slot_cols(c, p1, p2, gid)
        pts = np.stack([c, p1, p2])
        return cols, pts.min(0), pts.max(0)
    if kind == mb.KIND_QUAD:
        eu = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
        ev = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
        cols = jmp.quad_slot_cols(c, eu, ev, gid)
        pts = np.stack([c, c + eu, c + ev, c + eu + ev])
        return cols, pts.min(0), pts.max(0)
    if kind == mb.KIND_SPHERE:
        r = rng.uniform(0.05, 0.4, n).astype(np.float32)
        return (jmp.sphere_slot_cols(c, r, gid), c - r[:, None],
                c + r[:, None])
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    radial = np.cross(nrm, rng.normal(size=(n, 3))).astype(np.float32)
    radial *= (rng.uniform(0.1, 0.5, (n, 1))
               / np.linalg.norm(radial, axis=1, keepdims=True))
    radial = radial.astype(np.float32)
    rad = np.linalg.norm(radial, axis=1, keepdims=True)
    return (jmp.disk_slot_cols(c, nrm, radial, gid), c - rad, c + rad)


@pytest.mark.parametrize("kind", [mb.KIND_TRI, mb.KIND_QUAD, mb.KIND_SPHERE,
                                  mb.KIND_DISK])
def test_each_kind_matches_interpret_kernel(kind):
    cols, lo, hi = _kind_inputs(kind)
    o, d = _shell_rays(kind + 11, 256, 1.5)
    o *= 1.5
    jr, tr = _both(o, d)
    jt = jmp.PrimBVHTracer(kind, cols, lo, hi, interpret=True)
    tracer = mb.PrimBVHTracer(kind, cols, lo, hi, device="cpu")
    t_ref, i_ref = jt.trace(jr)
    t, idx = tracer.trace(tr)
    _compare(tracer, o, d, t_ref, i_ref, t, idx, False)
    assert np.isfinite(t.numpy()).mean() > 0.1  # the rays hit
    # Any hit where the closest hit is (the any-hit walk's own kind-free
    # logic is held against interpret mode on the octahedron).
    t_any, _ = tracer.trace(tr, any_hit=True)
    np.testing.assert_array_equal(np.isfinite(t_any.numpy()),
                                  np.isfinite(t.numpy()))


def _reference_tracer(p0, p1, p2, use_native):
    """mesh_pallas.MeshBVHTracer (interpret mode) over the tree of the
    chosen builder, put together as tests/test_bvh.py's
    test_native_builder_matches_numpy_validity does."""
    from pbrs_tpu.accel import bvh as jbvh

    lo, hi = jbvh.triangle_bboxes(p0, p1, p2)
    gid = np.arange(p0.shape[0]).astype(np.float32)
    tracer = jmp.PrimBVHTracer.__new__(jmp.PrimBVHTracer)
    tracer.kind = jmp.KIND_TRI
    tracer.block_rows = jmp.BLOCK_ROWS
    tracer.bvh = jbvh.build_bvh(lo, hi, max_leaf=jmp.TRIS_PER_LEAF,
                                use_native=use_native)
    tracer.node_arrays, tracer.leaf_rows = jmp.pack_mesh(
        tracer.bvh, jmp.tri_slot_cols(p0, p1, p2, gid), 0)
    tracer.num_nodes = int(tracer.node_arrays[0].shape[0])
    tracer.interpret = True
    return tracer


@pytest.mark.parametrize("use_native", [True, False])
def test_native_and_numpy_trees(octahedron, use_native, monkeypatch):
    """Under either builder the port's tree is the reference's (order,
    skip links) and walks to its answer. The tracer builds through
    accel/bvh.py's build_bvh, pinned here to the builder under test."""
    tracer, o, d, tr, _ = octahedron
    p0, p1, p2 = _mesh(2)
    jt = _reference_tracer(p0, p1, p2, use_native)
    monkeypatch.setattr(mb.bvh_mod, "build_bvh", functools.partial(
        mb.bvh_mod.build_bvh, use_native=use_native))
    tracer = mb.MeshBVHTracer(p0, p1, p2, global_base=0, device="cpu")
    assert tracer.bvh.builder == ("native" if use_native else "numpy")
    np.testing.assert_array_equal(tracer.bvh.prim_order, jt.bvh.prim_order)
    np.testing.assert_array_equal(tracer.bvh.skip, jt.bvh.skip)
    t_ref, i_ref = jt.trace(_both(o, d)[0])
    t, idx = tracer.trace(tr)
    _compare(tracer, o, d, t_ref, i_ref, t, idx, False)


def test_poisoned_skip_terminates():
    """tests/test_bvh.py:test_wedge_guard_poisoned_skip_terminates on the
    table the walk reads now: every interior child of every pair below
    pair 0 points back to the root's pair, and the rays enter the root box
    (and a child box), so the walk cycles, the stack fills to its depth,
    and only the cap of n_pairs pair fetches ends it."""
    p0, p1, p2 = _mesh(1)
    tracer = mb.MeshBVHTracer(p0, p1, p2, global_base=0, device="cpu")
    refs = tracer.nodes[:, 12:16].view(torch.int32)
    root_pair = int(refs[0, 0])
    assert int(refs[0, 1]) == 0 and root_pair == 1
    for side in (0, 1):
        inner = refs[1:, 2 * side + 1] == 0
        assert bool(inner.any())
        refs[1:, 2 * side][inner] = root_pair
    n = 32
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = 3.0
    o[:, 1] = np.linspace(-0.3, 0.3, n)
    d = np.tile(np.array([[-1.0, 0, 0]], np.float32), (n, 1))
    rays = tray.make_rays(torch.from_numpy(o), torch.from_numpy(d))
    planes = tray.to_planes(rays)
    inv = 1.0 / torch.where(planes[3:6] == 0.0, 1e-30, planes[3:6])
    for box in (tracer.nodes[0, 0:6], tracer.nodes[1, 0:6]):
        wanted, _ = mb._slab(box[None].expand(n, 6), planes[0:3], inv,
                             torch.full((n,), 3.0e38))
        assert bool(wanted.all())  # the rays enter the root and its left
    for any_hit in (False, True):
        t, idx = tracer.trace(rays, any_hit=any_hit)
        assert torch.isinf(t).all() and (idx == -1).all()
        work = {}
        mb.walk_reference(tracer, planes, any_hit, work)
        assert work["node_tests"] == 2 * tracer.n_pairs * n
        assert work["prim_tests"] == 0


def test_dead_rays_and_cuda_only_launch():
    """t_max <= 0 misses without a walk; a CPU tensor never reaches the
    kernel wrapper, which takes CUDA planes only."""
    p0, p1, p2 = _mesh(1)
    tracer = mb.MeshBVHTracer(p0, p1, p2, global_base=0, device="cpu")
    o, d = _shell_rays(1, 16, 0.1)
    rays = tray.make_rays(torch.from_numpy(o), torch.from_numpy(d),
                          torch.zeros(16))
    t, idx = tracer.trace(rays)
    assert torch.isinf(t).all() and (idx == -1).all()
    with pytest.raises(ValueError, match="CUDA"):
        mb.trace_planes(tracer, tray.to_planes(rays))


def test_default_device_is_the_card(monkeypatch):
    """The tracers put their tables on the card unless asked for the CPU:
    without a card, the constructor without `device` raises."""
    p0, p1, p2 = _mesh(1)
    if torch.cuda.is_available():
        assert mb.MeshBVHTracer(p0, p1, p2, global_base=0).nodes.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.MeshBVHTracer(p0, p1, p2, global_base=0)
    cols, lo, hi = _kind_inputs(mb.KIND_SPHERE, n=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.PrimBVHTracer(mb.KIND_SPHERE, cols, lo, hi)


def test_cpu_tracer_takes_walk_reference(monkeypatch):
    """device="cpu" keeps the tables on the CPU, and trace takes the plain
    walk, never the kernel's wrapper."""
    p0, p1, p2 = _mesh(1)
    tracer = mb.MeshBVHTracer(p0, p1, p2, global_base=0, device="cpu")
    assert tracer.nodes.device.type == "cpu"
    calls = []
    walk = mb.walk_reference
    monkeypatch.setattr(mb, "walk_reference",
                        lambda *a, **k: calls.append(1) or walk(*a, **k))

    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper was called")

    monkeypatch.setattr(mb, "trace_planes", refuse)
    o, d = _shell_rays(2, 64, 0.3)
    t, _ = tracer.trace(tray.make_rays(torch.from_numpy(o),
                                       torch.from_numpy(d)))
    assert calls == [1] and bool(torch.isfinite(t).any())


# ------------------- the pair walk against the skip-link walk -------------------


def skip_walk(tracer, planes, any_hit=False, work=None):
    """The walk K6 made before its child-pair table (and its plain version
    then): one stackless walk a lane over the tree's DFS order and skip
    links, every live lane stepping together, up to num_nodes + 1 steps.
    A wanted interior node is descended (node + 1), a wanted leaf's
    primitives tested, any other node left by its skip link. (t, id) and,
    in `work`, its node and primitive tests."""
    tree = tracer.bvh
    boxes = torch.from_numpy(np.concatenate([tree.bbox_min, tree.bbox_max],
                                            1))
    count = torch.from_numpy(np.where(tree.is_leaf > 0, tree.count,
                                      0).astype(np.int64))
    first = torch.from_numpy(tree.first.astype(np.int64))
    skip = torch.from_numpy(tree.skip.astype(np.int64))
    num_nodes = boxes.shape[0]
    n = planes.shape[1]
    o, d, t_max = planes[0:3], planes[3:6], planes[6]
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    t_best = torch.full((n,), mb.BIG)
    g_best = torch.full((n,), -1, dtype=torch.int64)
    node = torch.zeros(n, dtype=torch.int64)
    lanes = torch.nonzero(t_max > 0.0).squeeze(1)
    ks = torch.arange(mb.TRIS_PER_LEAF)
    for _ in range(num_nodes + 1):
        lanes = lanes[node[lanes] < num_nodes]
        if any_hit:
            lanes = lanes[g_best[lanes] < 0]
        if lanes.numel() == 0:
            break
        nd = node[lanes]
        limit = torch.minimum(t_best[lanes], t_max[lanes])
        wanted, _ = mb._slab(boxes[nd], o[:, lanes], inv[:, lanes], limit)
        if work is not None:
            work["node_tests"] = work.get("node_tests", 0) + lanes.numel()
        cnt = count[nd]
        leaf = wanted & (cnt > 0)
        if bool(leaf.any()):
            ln, f, c = lanes[leaf], first[nd[leaf]], cnt[leaf]
            valid = ks[None, :] < c[:, None]
            if work is not None:
                work["prim_tests"] = work.get("prim_tests", 0) + int(c.sum())
            slot = torch.where(valid, f[:, None] + ks[None, :], f[:, None])
            row = tracer.fields[slot]
            r = [x[:, None] for x in (o[0, ln], o[1, ln], o[2, ln], d[0, ln],
                                      d[1, ln], d[2, ln], t_max[ln])]
            t = mb.prim_t(tracer.kind, lambda k: row[..., k], *r)
            t = torch.where(valid, t, mb.BIG)
            tb = t_best[ln]
            if any_hit:
                cand = t < tb[:, None]
            else:
                cand = (t == t.min(dim=1, keepdim=True).values) & (
                    t < tb[:, None])
            k_first = torch.where(cand, ks[None, :], mb.TRIS_PER_LEAF)
            k_first = k_first.min(dim=1).values
            take = k_first < mb.TRIS_PER_LEAF
            kk = torch.clamp_max(k_first, mb.TRIS_PER_LEAF - 1)
            t_best[ln] = torch.where(take, t.gather(1, kk[:, None])[:, 0],
                                     tb)
            g_new = tracer.slot_gid[slot.gather(1, kk[:, None])[:, 0]]
            g_best[ln] = torch.where(take, g_new.to(torch.int64), g_best[ln])
        node[lanes] = torch.where(wanted & (cnt == 0), nd + 1, skip[nd])
    hit = t_best < mb.BIG
    return (torch.where(hit, t_best, mb.INF),
            torch.where(hit, g_best, -1).to(torch.int32))


def _left_turns(tree):
    """Per leaf-order slot, the interior nodes above its leaf whose left
    subtree holds it: the right children an any-hit pair walk that ends in
    that leaf has tested ahead of the skip-link walk."""
    nn = tree.skip.shape[0]
    turns = np.zeros(tree.prim_order.shape[0], np.int64)
    for j in np.nonzero(tree.is_leaf > 0)[0]:
        up = [i for i in range(j) if tree.skip[i] > j]
        k = sum(1 for i in up if i + 1 < nn and j < tree.skip[i + 1])
        turns[tree.first[j]:tree.first[j] + tree.count[j]] = k
    return turns


@pytest.fixture(scope="module")
def walk_sets():
    """{label: (tracer, planes)}: the octahedron under each builder and
    each kind's random primitives, with dead lanes, finite t_max and
    direction components of 0 among the rays."""
    p0, p1, p2 = _mesh(2)
    o, d = _shell_rays(0, 512, 0.8)
    out = {}
    for use_native in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mb.bvh_mod, "build_bvh", functools.partial(
                mb.bvh_mod.build_bvh, use_native=use_native))
            tracer = mb.MeshBVHTracer(p0, p1, p2, global_base=0,
                                      device="cpu")
        assert tracer.bvh.builder == ("native" if use_native else "numpy")
        out[f"octahedron {tracer.bvh.builder}"] = (tracer, o, d)
    for kind in (mb.KIND_TRI, mb.KIND_QUAD, mb.KIND_SPHERE, mb.KIND_DISK):
        cols, lo, hi = _kind_inputs(kind)
        ko, kd = _shell_rays(kind + 11, 256, 1.5)
        out[f"kind {kind}"] = (mb.PrimBVHTracer(kind, cols, lo, hi,
                                                device="cpu"), ko * 1.5, kd)
    for label, (tracer, o, d) in out.items():
        n = o.shape[0]
        d = d.copy()
        d[::5, 0] = 0.0
        d[::7, 2] = 0.0
        t_max = np.full(n, np.inf, np.float32)
        t_max[::9] = -1.0
        t_max[::11] = 2.5
        out[label] = (tracer, tray.to_planes(tray.make_rays(
            torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max))))
    return out


WALK_SETS = ["octahedron native", "octahedron numpy", "kind 0", "kind 1",
             "kind 2", "kind 3"]


@pytest.mark.parametrize("label", WALK_SETS)
def test_pair_table_layout(walk_sets, label):
    """Pair 0 holds the root beside a NaN box; every interior node has one
    pair, and a child's pair index is above its parent's; a leaf child's
    ref and count are its DFS first slot and count; the stack depth is
    the tree's depth."""
    tracer = walk_sets[label][0]
    tree = tracer.bvh
    pairs = tracer.nodes.numpy()
    refs = pairs[:, 12:16].view(np.int32)
    leaf = tree.is_leaf > 0
    inner = np.nonzero(~leaf)[0]
    assert tracer.n_pairs == 1 + inner.size == pairs.shape[0]
    assert np.isnan(pairs[0, 6:12]).all() and tuple(refs[0, :2]) == (1, 0)
    np.testing.assert_array_equal(pairs[0, 0:3], tree.bbox_min[0])
    np.testing.assert_array_equal(pairs[0, 3:6], tree.bbox_max[0])
    for k, i in enumerate(inner):
        p = 1 + k
        for side, child in ((0, i + 1), (1, tree.skip[i + 1])):
            ref, cnt = refs[p, 2 * side], refs[p, 2 * side + 1]
            np.testing.assert_array_equal(pairs[p, 6 * side:6 * side + 3],
                                          tree.bbox_min[child])
            np.testing.assert_array_equal(pairs[p, 6 * side + 3:6 * side + 6],
                                          tree.bbox_max[child])
            if leaf[child]:
                assert (ref, cnt) == (tree.first[child], tree.count[child])
                assert 1 <= cnt <= mb.TRIS_PER_LEAF
            else:
                assert cnt == 0 and ref > p and inner[ref - 1] == child
    assert tracer.stack_depth == tree.depth >= 1


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("label", WALK_SETS)
def test_pair_walk_matches_skip_walk(walk_sets, label, any_hit):
    """The plain walk over the pair table finds the skip-link walk's hits
    bit for bit and tests the same primitives (the same leaves). Its box
    tests differ only by those a pair tests ahead: the NaN box beside the
    root (one a live lane) and, for an any hit, the right children above
    the hit's leaf whose left subtree holds it, which the skip-link walk
    never reached."""
    tracer, planes = walk_sets[label]
    w_pair, w_skip = {}, {}
    t, idx = mb.walk_reference(tracer, planes, any_hit, w_pair)
    t_s, idx_s = skip_walk(tracer, planes, any_hit, w_skip)
    np.testing.assert_array_equal(t.numpy().view(np.int32),
                                  t_s.numpy().view(np.int32))
    np.testing.assert_array_equal(idx.numpy(), idx_s.numpy())
    assert w_pair["prim_tests"] == w_skip["prim_tests"]
    live = int((planes[6] > 0).sum())
    ahead = 0
    if any_hit:
        slot_of = {int(g): s for s, g in enumerate(tracer.slot_gid.numpy())}
        turns = _left_turns(tracer.bvh)
        ahead = sum(int(turns[slot_of[int(g)]]) for g in idx.numpy()
                    if g >= 0)
    assert w_pair["node_tests"] == w_skip["node_tests"] + live + ahead
    assert 0.1 < float(torch.isfinite(t).float().mean()) < 0.9  # hits, misses
