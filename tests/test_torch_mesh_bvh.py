"""The port's primitive-BVH walk (K6's plain version, accel/mesh_bvh.py)
against pbrs_tpu's mesh_pallas tracers in interpret mode, on the cases of
tests/test_bvh.py: the subdivided octahedron, each of the four kinds, the
native and the NumPy tree, and the poisoned skip table.

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
    nodes = tracer.nodes.numpy()
    meta = nodes[:, 6:8].copy().view(np.int32)
    slot = int(np.nonzero(tracer.slot_gid.numpy() == gid_ref)[0][0])
    count = meta[:, 0] & ((1 << mb.LEAF_SHIFT) - 1)
    first = meta[:, 0] >> mb.LEAF_SHIFT
    leaf = int(np.nonzero((count > 0) & (first <= slot)
                          & (slot < first + count))[0][0])
    skip = meta[:, 1]
    path = [i for i in range(leaf) if skip[i] > leaf] + [leaf]
    planes = tray.to_planes(tray.make_rays(torch.from_numpy(o[None]),
                                           torch.from_numpy(d[None])))
    o32, inv = planes[0:3, 0], 1.0 / torch.where(planes[3:6, 0] == 0.0,
                                                 1e-30, planes[3:6, 0])
    culled32 = False
    for i in path:
        box = torch.from_numpy(nodes[i, :6])
        t0 = (box[:3] - o32) * inv
        t1 = (box[3:6] - o32) * inv
        te = torch.minimum(t0, t1).max()
        tx = torch.maximum(t0, t1).min()
        culled32 |= not bool((te <= tx) & (tx >= mb.T_MIN) & (te < 3.0e38))
        te64, tx64 = _slab64(nodes[i], o, d)
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
    return mb.MeshBVHTracer(p0, p1, p2, global_base=0), o, d, tr, ref


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
    tracer = mb.PrimBVHTracer(kind, cols, lo, hi)
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
    tracer = mb.MeshBVHTracer(p0, p1, p2, global_base=0)
    assert tracer.bvh.builder == ("native" if use_native else "numpy")
    np.testing.assert_array_equal(tracer.bvh.prim_order, jt.bvh.prim_order)
    np.testing.assert_array_equal(tracer.bvh.skip, jt.bvh.skip)
    t_ref, i_ref = jt.trace(_both(o, d)[0])
    t, idx = tracer.trace(tr)
    _compare(tracer, o, d, t_ref, i_ref, t, idx, False)


def test_poisoned_skip_terminates():
    """tests/test_bvh.py:test_wedge_guard_poisoned_skip_terminates: every
    skip link points back to the root and the rays miss the root box, so
    only the step cap ends the walk."""
    p0, p1, p2 = _mesh(1)
    tracer = mb.MeshBVHTracer(p0, p1, p2, global_base=0)
    tracer.nodes[:, 7] = 0.0  # skip := 0 (int32 zero bits) on every node
    o = np.full((32, 3), 100.0, np.float32)
    d = np.tile(np.array([[1.0, 0, 0]], np.float32), (32, 1))
    for any_hit in (False, True):
        t, idx = tracer.trace(tray.make_rays(torch.from_numpy(o),
                                             torch.from_numpy(d)),
                              any_hit=any_hit)
        assert torch.isinf(t).all() and (idx == -1).all()


def test_dead_rays_and_cuda_only_launch():
    """t_max <= 0 misses without a walk; a CPU tensor never reaches the
    kernel wrapper, which takes CUDA planes only."""
    p0, p1, p2 = _mesh(1)
    tracer = mb.MeshBVHTracer(p0, p1, p2, global_base=0)
    o, d = _shell_rays(1, 16, 0.1)
    rays = tray.make_rays(torch.from_numpy(o), torch.from_numpy(d),
                          torch.zeros(16))
    t, idx = tracer.trace(rays)
    assert torch.isinf(t).all() and (idx == -1).all()
    with pytest.raises(ValueError, match="CUDA"):
        mb.trace_planes(tracer, tray.to_planes(rays))
