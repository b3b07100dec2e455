"""The port's sharded renderer (pbrs_tpu_torch/parallel.py) and its entry
points on gloo CPU ranks: make_mesh's rank layout, render_image_sharded
against pbrs_tpu.parallel.render_image_sharded on a 16^2 Cornell box
(spp 4 at dp1xsp1, spp 9 at dp1xsp2, whose batch rounds up to 10 sample
indices), every dp layout bit-equal to dp1xsp1 and every sp layout within
the contract, render_batch_sharded over the fused integrators' plain
versions against the unsharded integrator, the dry run, the backend
choice and the refusal without a card.

The ranks run in one 4-rank spawn whose rank body
(tools/bench_multichip.layout_rank) lives in the port package: a spawned
rank imports neither this module nor JAX."""

import numpy as np
import pytest
import torch

from pbrs_tpu import parallel as jparallel
from pbrs_tpu.geometry import camera as jcam
from pbrs_tpu.scene import presets as jpresets
from pbrs_tpu_torch import graft_entry, parallel, render
from pbrs_tpu_torch.accel import fused_kernel as fk
from pbrs_tpu_torch.accel import fused_single_lobe as fsl
from pbrs_tpu_torch.core import sampler as tsmp
from pbrs_tpu_torch.scene import buffers
from pbrs_tpu_torch.tools import bench_multichip as bm
from test_fused_single_lobe import _shrunk
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

ATOL, RTOL = 2e-5, 1e-4  # tests/test_fused.py:38
SIZE, DEPTH, N_RANKS = 16, 3, 4
VIEW = ((278, 278, -800), (278, 278, 0), (0, 1, 0))
LAYOUTS = ((1, 1), (2, 1), (1, 2), (2, 2))
FUSED = {"fused_diffuse": ("cornell", fk.FusedDiffuseIntegrator),
         "fused_single_lobe": ("plates", fsl.FusedSingleLobeIntegrator)}
BATCH_LAYOUTS = ((2, 1), (2, 2))
SAMPLES = 4


def _jax_cornell():
    return jpresets.cornell_box().replace(camera=jcam.looking_at(
        jcam.make_camera((SIZE, SIZE), 40.0), *VIEW))


def _carry(jscene):
    return buffers.scene_from_arrays(buffers.scene_to_arrays(jscene))


def _jobs():
    jobs = [{"scene": "cornell", "dp": dp, "sp": sp, "depth": DEPTH,
             "spp": 4, "spans": (dp, sp) == (1, 2)} for dp, sp in LAYOUTS]
    jobs.append({"scene": "cornell", "dp": 1, "sp": 2, "depth": DEPTH,
                 "spp": 9})
    for kind, (scene, _) in FUSED.items():
        jobs += [{"scene": scene, "dp": dp, "sp": sp, "depth": DEPTH,
                  "samples": SAMPLES, "integrator": kind}
                 for dp, sp in BATCH_LAYOUTS]
    return jobs


@pytest.fixture(scope="module")
def scenes():
    """pbrs_tpu's Cornell box and plates at 16^2 and the port's copies."""
    jscenes = {"cornell": _jax_cornell(),
               "plates": _shrunk(jpresets.plates(), SIZE)}
    return jscenes, {k: _carry(v) for k, v in jscenes.items()}


@pytest.fixture(scope="module")
def ranks(scenes):
    """Every job of _jobs() on 4 gloo CPU ranks, in one spawn."""
    _, tscenes = scenes
    return parallel.run_ranks(
        bm.layout_rank, N_RANKS,
        {k: buffers.scene_to_arrays(v) for k, v in tscenes.items()},
        _jobs(), device="cpu")


def _out(ranks, **match):
    """Rank 0's output of the one job matching `match`."""
    idx = [i for i, job in enumerate(_jobs())
           if all(job.get(k) == v for k, v in match.items())]
    assert len(idx) == 1, match
    return ranks[0]["runs"][idx[0]]["out"]


@pytest.fixture(scope="module")
def jax_images(scenes):
    """pbrs_tpu.parallel.render_image_sharded on the 16^2 Cornell box:
    spp 4 at dp1xsp1 and spp 9 at dp1xsp2."""
    jscene = scenes[0]["cornell"]
    return {spp: np.asarray(jparallel.render_image_sharded(
        jscene, spp, jparallel.make_mesh(n_dp=1, n_sp=sp), max_depth=DEPTH))
        for spp, sp in ((4, 1), (9, 2))}


def test_make_mesh_rank_layout(ranks):
    """Rank r sits at (r // n_sp, r % n_sp) of every mesh; ranks past
    n_dp * n_sp are outside it."""
    for rank, res in enumerate(ranks):
        assert res["rank"] == rank
        for job, coord in zip(_jobs(), res["coords"]):
            dp, sp = job["dp"], job["sp"]
            want = (rank // sp, rank % sp) if rank < dp * sp else None
            assert coord == want, (job, rank)


@pytest.mark.parametrize("dp,sp", LAYOUTS)
def test_image_matches_reference_spp4(ranks, jax_images, dp, sp):
    got = _out(ranks, dp=dp, sp=sp, spp=4)
    assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_images[4], atol=ATOL, rtol=RTOL)


def test_image_matches_reference_spp9_sp2(ranks, jax_images):
    """msaa 3 at sp 2: five calls of 2 sample indices, the last past
    msaa^2 (a random stratum), the sum divided by 10."""
    got = _out(ranks, dp=1, sp=2, spp=9)
    np.testing.assert_allclose(got, jax_images[9], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dp,sp", [(2, 1), (2, 2)])
def test_dp_layouts_bit_equal(ranks, dp, sp):
    """A dp split changes no pixel's arithmetic: dpNxsp equals dp1xsp bit
    for bit."""
    np.testing.assert_array_equal(_out(ranks, dp=dp, sp=sp, spp=4),
                                  _out(ranks, dp=1, sp=sp, spp=4))


def test_sp_layout_within_contract(ranks):
    """An sp split re-associates each pixel's sum of samples (dp1xsp2
    renders with the recorder on, which changes no pixel)."""
    np.testing.assert_allclose(_out(ranks, dp=1, sp=2, spp=4),
                               _out(ranks, dp=1, sp=1, spp=4),
                               atol=ATOL, rtol=RTOL)


def test_sp_layout_records_its_all_reduce(ranks):
    """With the recorder on, each rank of dp1xsp2 records one pbrs.pass a
    sample index it renders and one pbrs.all_reduce a batch; the ranks
    outside that mesh, and the jobs without the recorder, record none."""
    job = next(i for i, j in enumerate(_jobs()) if j.get("spans"))
    for rank, res in enumerate(ranks):
        for i, run in enumerate(res["runs"]):
            if i != job or rank >= 2:
                assert run["spans"] == {}
                continue
            # spp 4 at sp 2: two batches of 2 sample indices, one a rank.
            assert run["spans"]["pbrs.pass"] == 2
            assert run["spans"]["pbrs.all_reduce"] == 2
            assert run["spans"]["pbrs.bounce"] == 2 * DEPTH


@pytest.fixture(scope="module")
def unsharded(scenes):
    """Each fused integrator's plain version, unsharded, summed over
    sample indices 0 .. SAMPLES - 1 in order."""
    out = {}
    for kind, (name, cls) in FUSED.items():
        integ = cls(scenes[1][name])
        pix = torch.arange(SIZE * SIZE, dtype=torch.int32)
        acc = torch.zeros(SIZE * SIZE, 3)
        for s in range(SAMPLES):
            acc = acc + integ.render_samples(tsmp.PCGSampler(0), pix, s,
                                             max_depth=DEPTH)[0]
        out[kind] = acc.numpy()
    return out


@pytest.mark.parametrize("kind", sorted(FUSED))
def test_batch_sharded_fused_dp(ranks, unsharded, kind):
    """render_batch_sharded(integrator=...) at dp2xsp1 equals the
    unsharded integrator's sum bit for bit."""
    got = _out(ranks, dp=2, sp=1, integrator=kind)
    np.testing.assert_array_equal(got, unsharded[kind])


@pytest.mark.parametrize("kind", sorted(FUSED))
def test_batch_sharded_fused_dp_sp(ranks, unsharded, kind):
    """At dp2xsp2 each pixel sums (s0 + s1) + (s2 + s3)."""
    got = _out(ranks, dp=2, sp=2, integrator=kind)
    assert np.abs(unsharded[kind]).sum() > 0
    np.testing.assert_allclose(got, unsharded[kind], atol=ATOL, rtol=RTOL)


def test_batch_sharded_checks_its_split():
    """The checks that run before a rank renders or joins a collective."""
    class Mesh:
        shape = (2, 2)

        @staticmethod
        def get_coordinate():
            return None

    pix = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="sp size"):
        parallel.render_batch_sharded(None, None, pix, 0, 3, Mesh)
    with pytest.raises(ValueError, match="dp size"):
        parallel.render_batch_sharded(None, None, pix[:7], 0, 2, Mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(parallel.dist, "get_rank", lambda: 5)
            parallel.render_batch_sharded(None, None, pix, 0, 2, Mesh)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multichip_cpu(n_devices):
    graft_entry.dryrun_multichip(n_devices, device="cpu")


def test_entry_renders_a_step():
    """entry()'s render step (64^2 Cornell, depth 5, msaa 2) on the CPU: a
    finite, lit radiance for every pixel, equal to the general route's
    launch of the same sample (render_samples is held against pbrs_tpu's
    by test_torch_render.py and test_torch_fused.py)."""
    fn, (pix, s) = graft_entry.entry(device="cpu")
    assert pix.shape == (64 * 64,) and s == 0
    got = fn(pix, s)
    assert got.shape == (64 * 64, 3) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all()) and float(got.mean()) > 0
    _, step = render.make_integrator(graft_entry.tiny_cornell(64),
                                     tsmp.PCGSampler(0), 5, 2, "general")
    np.testing.assert_array_equal(got.numpy(), step(pix, s)[0].numpy())


@pytest.mark.parametrize("device_type,n_ranks,n_devices,want", [
    ("cpu", 4, 0, "gloo"),
    ("cpu", 2, 8, "gloo"),
    ("cuda", 2, 1, "gloo"),  # two ranks share one card
    ("cuda", 8, 4, "gloo"),
    ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 8, "nccl"),
])
def test_choose_backend(device_type, n_ranks, n_devices, want):
    assert parallel.choose_backend(device_type, n_ranks, n_devices) == want


@pytest.mark.parametrize("call", [
    lambda: parallel.run_ranks(graft_entry._dryrun_rank, 2, 2),
    lambda: parallel.rank_device("cuda", 0),
    lambda: graft_entry.entry(),
    lambda: graft_entry.dryrun_multichip(2),
    lambda: bm.main(["--out", "build/never_written.json"]),
], ids=["run_ranks", "rank_device", "entry", "dryrun", "bench"])
def test_cuda_without_card_raises(monkeypatch, call):
    """The entry points default to the card and raise without one; no
    rank carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_bench_refuses_the_jax_record():
    with pytest.raises(SystemExit, match="JAX package's record"):
        bm.main(["--device", "cpu", "--out",
                 f"{bm.REPO}/MULTICHIP_BENCH.json"])


def test_bench_layouts():
    assert bm.layouts(4) == [(1, 1), (4, 1), (2, 2), (1, 4)]
    assert bm.layouts(8) == [(1, 1), (8, 1), (4, 2), (1, 8)]
    assert bm.layouts(2) == [(1, 1), (2, 1), (1, 2)]
