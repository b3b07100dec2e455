"""Trace-cost questions of tools/_prof_rounds.py, asked of the port on the
card.

    python -m pbrs_tpu_torch.tools.prof_rounds

Q2: what does one gather round cost? The reference times a bf16
    [1728, 128] x [128, 1024] product (its treelet kernel's one-hot gather
    shape) repeated `reps` times inside one kernel, mm_kernel. Here the
    same probe is a hand-written CUDA kernel (csrc/mm_probe.cu, wgmma on
    operands held in shared memory, launched by ``mm_probe``), timed at the reference's reps of 100 and 400 in
    microseconds a round, beside one cuBLAS ``torch.matmul`` of the same
    bf16 operands (the probe's library yardstick; the port never calls
    it).
Q3: trace time of mesh_ball(levels=5) on 2^20 coherent camera rays and
    2^20 incoherent rays, through the port's BVH tracer (K5,
    accel/treelet.py) and through the primitive-BVH walk (K6,
    accel/mesh_bvh.py) beside it.

Q1 (gather rounds per 1024-lane row of the treelet kernel) has no
counterpart: K5 walks one ray a thread and runs no gather rounds.

The probe's operands are the reference's: a random normal table and a
mask that is 1 on 1% of its entries, made with numpy from --seed (the
reference draws them with numpy's global generator, the incoherent rays
with jax.random: the port's rays are numpy's, from the same seed). CUDA
only: without a card the script exits non-zero. Prints one JSON line a
question, with the card's name.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import kernels

ROWS3 = 3 * 9 * 64  # 1728: _prof_rounds.py's gather rows
K = 128
COLS = 1024
# csrc/mm_probe.cu: a block computes a 64 x 128 tile of the result, so the
# probe takes rows in 64s and columns in 128s.
TILE_ROWS, TILE_COLS = 64, 128
# Published H100 SXM peaks: dense bf16 tensor-core rate and HBM3
# bandwidth.
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
SLEEP_CYCLES = 20_000_000  # ~10 ms of device clock ahead of a timed loop
N_RAYS = 1 << 20

# Kernel launches since the last reset (a plain count).
LAUNCHES = 0


def probe_operands(seed=0, device="cpu", rows=ROWS3, cols=COLS):
    """(table [rows, 128] bf16, mask [128, cols] bf16): normal entries, and
    a 0/1 mask that is 1 on 1% of its entries."""
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.standard_normal((rows, K)).astype(np.float32))
    mask = torch.from_numpy((rng.random((K, cols)) < 0.01).astype(np.float32))
    return (tab.to(torch.bfloat16).to(device),
            mask.to(torch.bfloat16).to(device))


def mm_reference(tab, mask, reps):
    """Plain version of the probe: `reps` accumulated float32 products of
    the bf16 operands, as mm_kernel's fori_loop adds each f32
    dot_general to its accumulator."""
    acc = torch.zeros(tab.shape[0], mask.shape[1], device=tab.device)
    a, b = tab.float(), mask.float()
    for _ in range(reps):
        acc = acc + a @ b
    return acc


def mm_probe(tab, mask, reps):
    """The probe: [m, 128] bf16 x [128, n] bf16, `reps` times, summed into
    [m, n] float32. CUDA tensors launch csrc/mm_probe.cu (m a multiple of
    64, n of 128); CPU tensors take mm_reference."""
    global LAUNCHES
    if tab.device.type == "cpu":
        return mm_reference(tab, mask, reps)
    if not (tab.is_cuda and mask.device == tab.device
            and tab.dtype == torch.bfloat16 and mask.dtype == torch.bfloat16
            and tab.dim() == 2 and mask.dim() == 2 and tab.shape[1] == K
            and mask.shape[0] == K and tab.shape[0] % TILE_ROWS == 0
            and mask.shape[1] % TILE_COLS == 0 and tab.is_contiguous()
            and mask.is_contiguous() and reps >= 0):
        raise ValueError("mm_probe takes contiguous CUDA bf16 [m, 128] and "
                         "[128, n] with m a multiple of 64 and n of 128, got "
                         f"{tab.dtype} {tuple(tab.shape)} on {tab.device} "
                         f"and {mask.dtype} {tuple(mask.shape)} on "
                         f"{mask.device}")
    out = torch.empty(tab.shape[0], mask.shape[1], device=tab.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(tab.device).cuda_stream
    rc = kernels.lib().pbrs_mm_probe(tab.data_ptr(), mask.data_ptr(),
                                     tab.shape[0], mask.shape[1], reps,
                                     out.data_ptr(), stream)
    kernels.check(rc, "mm_probe")
    LAUNCHES += 1
    return out


def bound_ms(m, n, reps):
    """(bound ms, what binds) of one probe launch: the products' flops over
    the dense bf16 peak, or its operands read once and its result written
    once over the memory rate."""
    t_ops = 2.0 * m * K * n * reps / PEAK_BF16_FLOPS * 1e3
    t_bytes = (2 * (m * K + K * n) + 4 * m * n) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, iters):
    """Mean device ms of fn over iters calls (CUDA events), after one
    warm-up call. The device first sleeps for SLEEP_CYCLES, so the host
    queues the calls before the start event and short kernels are not
    timed by their launch gaps."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def q2(dev, seed=0):
    """The probe at reps 100 and 400: its ms a launch and µs a round, its
    bound, one cuBLAS matmul of the same operands (a round's library
    time), and one cuBLAS matmul of the operands stacked `reps` times along
    k (the probe's whole sum of products in one library call)."""
    tab, mask = probe_operands(seed, dev)
    cublas_ms = cuda_ms(lambda: torch.matmul(tab, mask), 50)
    rows = []
    for reps in (100, 400):
        ms = cuda_ms(lambda: mm_probe(tab, mask, reps), 10)
        stacked = (tab.repeat(1, reps).contiguous(),
                   mask.repeat(reps, 1).contiguous())
        stacked_ms = cuda_ms(lambda: torch.matmul(*stacked), 10)
        b_ms, by = bound_ms(ROWS3, COLS, reps)
        macs = ROWS3 * K * COLS * reps
        rows.append({"reps": reps, "ms": ms, "us_per_round": ms / reps * 1e3,
                     "tmac_per_s": macs / (ms * 1e-3) / 1e12,
                     "bound_ms": b_ms, "bound_by": by,
                     "cublas_matmul_us": cublas_ms * 1e3,
                     "cublas_stacked_ms": stacked_ms})
    return rows


def ray_sets(scene, lo, hi, dev, seed=0, n=N_RAYS):
    """(coherent, incoherent) ray sets of n rays each: camera rays of the
    scene's view (sample 0, msaa 2, pixel = lane mod the pixel count), and
    rays from random origins in a box twice the extent [lo, hi] in normal
    random directions (tools/_prof_rounds.py's rays_c and rays_i)."""
    from ..core import sampler as smp
    from ..geometry import ray as ray_mod
    from ..integrators import wavefront

    cam = scene.camera
    pix = (torch.arange(n, device=dev) % (cam.width * cam.height)).to(
        torch.int32)
    coherent = wavefront.camera_rays(scene, smp.PCGSampler(0), pix,
                                     torch.zeros_like(pix), 2)
    rng = np.random.default_rng(seed)
    ctr, ext = (lo + hi) / 2, hi - lo
    orig = rng.random((n, 3)) * ext * 2 + (ctr - ext)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    incoherent = ray_mod.make_rays(
        torch.from_numpy(orig.astype(np.float32)).to(dev),
        torch.from_numpy(d.astype(np.float32)).to(dev),
        torch.full((n,), 3e38, device=dev))
    return coherent, incoherent


def mesh_ball_tris(dev):
    """mesh_ball(levels=5) on `dev` and its triangles (p0, p1, p2) as
    NumPy arrays."""
    from ..scene import presets

    scene = presets.mesh_ball(levels=5).to(dev)
    g = scene.geom
    return scene, tuple(x.cpu().numpy() for x in (g.tri_p0, g.tri_p1,
                                                  g.tri_p2))


def q3(dev, seed=0):
    """Closest-hit trace time of mesh_ball(levels=5) through K5 and K6."""
    from ..accel import mesh_bvh, treelet

    scene, (p0, p1, p2) = mesh_ball_tris(dev)
    coherent, incoherent = ray_sets(scene, p0.min(0), p0.max(0), dev, seed)
    tracers = {"K5 treelet.tri_tracer": treelet.tri_tracer(p0, p1, p2, 0,
                                                           device=dev),
               "K6 mesh_bvh.MeshBVHTracer": mesh_bvh.MeshBVHTracer(
                   p0, p1, p2, 0, device=dev)}
    rows = []
    for label, rays in (("coherent", coherent), ("incoherent", incoherent)):
        for name, tracer in tracers.items():
            ms = cuda_ms(lambda: tracer.trace(rays), 4)
            rows.append({"rays": label, "tracer": name, "ms": ms,
                         "mrays_per_s": N_RAYS / (ms * 1e-3) / 1e6})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pbrs_tpu_torch.tools.prof_rounds",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_rounds: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    print(json.dumps({"q2": q2(dev, args.seed), "device": card}))
    print(json.dumps({"q3": q3(dev, args.seed), "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
