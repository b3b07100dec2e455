"""Wavefront path integrator (the general path). Mirrors
pbrs_tpu/integrators/wavefront.py: camera rays with filter importance
sampling, the masked ``path_radiance`` loop with two-arm or folded NEE or
BSDF sampling alone (``use_nee=False``) and the ``--debug_checks`` audit,
block compaction (``auto_schedule``, ``measure_alive``, ``block_compact``,
``compact_step``, the sort-only ``resort`` pass) and ``render_samples``.

Every bounce runs intersect -> shading (textures overlaid) -> emission on
camera and post-delta segments -> NEE -> BSDF sample -> Russian roulette
on all lanes, with terminated lanes masked; the bounce loop is a Python
loop over whole-batch tensor ops. Given a shrink schedule, the same loop
runs each bounce on fewer lanes: between bounces the live lanes move, in
blocks of COMPACT_BLOCK, into a smaller batch whose size a measured static
schedule sets, and each lane banks its contributions onto its original
row. ``resort`` runs the same step as a pure permutation at every bounce
from the second on where the schedule keeps every lane: the live blocks go
into spatial order, none dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import profiling
from ..bxdf import bsdf as bsdf_mod
from ..core import filters as flt
from ..core import sampler as smp
from ..core import vecmath as vm
from ..geometry import camera as cam_mod
from ..geometry import ray as ray_mod
from ..lights import env_sampling as es
from ..lights import lights as lt
from ..materials import table as mat_mod
from . import debug_audit as aud_mod
from . import nee


def camera_rays(scene, sampler, pixel_idx, sample_idx, msaa,
                filter_table=None):
    """Camera ray batch with stratified per-sample jitter, warped through
    a reconstruction filter's inverse CDF when one is given."""
    rays, _ = camera_rays_weighted(scene, sampler, pixel_idx, sample_idx,
                                   msaa, filter_table)
    return rays


def camera_rays_weighted(scene, sampler, pixel_idx, sample_idx, msaa,
                         filter_table=None):
    """(rays, weight): weight is None without a filter or for a
    non-negative one, else each sample's signed filter weight [N]
    (weighted filter importance sampling, core/filters.py)."""
    with profiling.span("pbrs.camera_rays"):
        row, col = cam_mod.pixel_coords(scene.camera, pixel_idx)
        dx, dy = smp.stratified_jitter(sampler, pixel_idx, sample_idx, msaa)
        weight = None
        if filter_table is not None:
            ox, wx = flt.sample_filter_offset(filter_table, dx)
            oy, wy = flt.sample_filter_offset(filter_table, dy)
            dx = 0.5 + ox
            dy = 0.5 + oy
            if wx is not None:
                weight = wx * wy
        rays = cam_mod.shoot_rays(scene.camera, row, col,
                                  torch.stack([dx, dy], dim=-1))
    return rays, weight


def morton_pixel_order(width, height):
    """Pixel ids in Morton (Z-curve) order (host-side NumPy)."""
    w2 = 1 << int(np.ceil(np.log2(max(width, 1))))
    h2 = 1 << int(np.ceil(np.log2(max(height, 1))))
    s = max(w2, h2)
    xs, ys = np.meshgrid(np.arange(s, dtype=np.int64),
                         np.arange(s, dtype=np.int64), indexing="xy")

    def part1by1(v):
        v = (v | (v << 16)) & 0x0000FFFF0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
        v = (v | (v << 2)) & 0x3333333333333333
        v = (v | (v << 1)) & 0x5555555555555555
        return v

    code = part1by1(xs.reshape(-1)) | (part1by1(ys.reshape(-1)) << 1)
    order = np.argsort(code, kind="stable")
    xs, ys = xs.reshape(-1)[order], ys.reshape(-1)[order]
    keep = (xs < width) & (ys < height)
    return (ys[keep] * width + xs[keep]).astype(np.int32)


def _resolve_pending(pending, hit, env, p_env=None):
    """The previous bounce's folded BSDF-arm contribution, resolved by this
    bounce's closest hit: the env leg pays where the ray escaped, the area
    leg where nothing closer than the chosen light was hit. p_env (env-IS):
    the distribution pdf along this bounce's rays, for the env leg's
    deferred MIS weight (the BSDF pdf rides t_light there)."""
    coeff, t_light, is_env = (pending["coeff"], pending["t_light"],
                              pending["is_env"])
    vis_area = hit.t >= t_light * (1.0 - 1e-3)
    pend_valid = is_env | (t_light > 0.0)
    env_term = coeff * env
    if p_env is not None:
        w_e = nee._power2_heuristic(t_light, p_env)
        env_term = env_term * torch.where(is_env, w_e, 1.0)[..., None]
    contrib = torch.where(is_env[..., None], env_term, coeff)
    ok = pend_valid & torch.where(is_env, ~hit.hit, vis_area)
    return torch.where(ok[..., None], contrib, 0.0)


def _make_env_evaluator(scene, folded):
    """(env rgb, distribution pdf or None) along directions: folded env-IS
    takes both from one texel lookup."""
    if folded and scene.env.dist is not None:
        return lambda dirs: es.eval_env_pdf(scene.env, dirs)
    return lambda dirs: (lt.eval_env(scene.env, dirs), None)


def path_radiance(scene, rays, sampler, pixel_idx, sample_idx, intersect_fn,
                  occlude_fn, max_depth=5, rr_start=3, nee_mode="twoarm",
                  use_nee=True, audit=False, shrink_schedule=None,
                  resort=False):
    """(radiance [N,3], traced-ray count) along camera rays: closest hit,
    emission on camera segments, one-light NEE with MIS, BSDF sampling,
    Russian roulette after `rr_start`. The count (an int64 scalar) is the
    rays with a live extent at each closest hit plus one shadow ray per
    alive lane for each shadow batch.

    use_nee=False is the brute-force estimator (validation): no NEE,
    emission counted on every segment; it converges to the NEE image.
    audit=True adds a third result, the [K] violation counts of
    debug_audit.py summed over the bounces; it runs the masked loop.

    nee_mode "twoarm" traces a shadow ray for each MIS arm; "folded" shares
    the path's own BSDF sample with the BSDF arm and resolves its
    visibility from the next bounce's closest hit (one shadow batch a
    bounce). A lane that dies owing a pending keeps a segment bounded at
    the pending light for one more trace; one epilogue trace resolves the
    last bounce's.

    shrink_schedule (per-bounce lane capacities, schedule[0] >= N; the
    batch must tile into COMPACT_BLOCK blocks) compacts the lanes before
    each bounce whose capacity is below the lanes in hand
    (``compact_step``). Each lane draws from (pixel, sample, bounce) and
    banks its emission and NEE separately onto its original row, so with
    the roulette keeping every block (p = 1) each lane's radiance is the
    masked loop's. resort sorts the lanes' blocks at each bounce from the
    second on, where the schedule (or, without one, the batch) keeps every
    lane (``compact_step``). audit ignores the schedule and resort."""
    if audit:
        shrink_schedule, resort = None, False
    n = rays.origin.shape[0]
    dev = rays.origin.device
    folded = nee_mode == "folded" and use_nee and scene.num_lights > 0
    env_eval = _make_env_evaluator(scene, folded)
    radiance = torch.zeros(n, 3, device=dev)
    beta = torch.ones(n, 3, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular = torch.zeros(n, dtype=torch.bool, device=dev)
    ray_count = torch.zeros((), dtype=torch.int64, device=dev)
    pend = None
    counts = aud_mod.zero_counts(dev) if audit else None
    pix, sid, orig, bank = pixel_idx, sample_idx, None, _add

    for bounce in range(max_depth):
        with profiling.span("pbrs.bounce"):
            if shrink_schedule is not None or resort:
                (rays, beta, pix, sid, orig, specular, alive, pend,
                 bank) = compact_step(shrink_schedule, bounce, n, sampler,
                                      rays, beta, pix, sid, orig, specular,
                                      alive, pend, bank, resort)
            profiling.count_lanes(alive, rays.n)
            in_rays, alive_in = rays, alive
            (radiance, rays, beta, alive, specular, pend, traced,
             seen) = _bounce(scene, sampler, pix, sid, bounce, rays,
                             radiance, beta, alive, specular, pend, bank,
                             intersect_fn, occlude_fn, env_eval, folded,
                             use_nee, rr_start)
            ray_count = ray_count + traced
            if audit:
                counts = counts + aud_mod.audit_bounce(
                    in_rays, seen["hit"], seen["frame"], radiance, beta,
                    seen["f"], seen["wi"], seen["pdf"], alive_in,
                    lobes=seen["lobes"], emit=seen["emit"])

    if folded:
        radiance, traced = _epilogue(pend, rays, radiance, bank,
                                     intersect_fn, env_eval)
        ray_count = ray_count + traced
    if audit:
        return radiance, ray_count, counts
    return radiance, ray_count


def _add(radiance, contrib):
    return radiance + contrib


def _bounce(scene, sampler, pix, sid, bounce, rays, radiance, beta, alive,
            specular, pend, bank, intersect_fn, occlude_fn, env_eval, folded,
            use_nee, rr_start):
    """One bounce of the general path over the lanes in hand. `bank` adds a
    per-lane contribution into the radiance (the compacting loop scatters
    it to the lanes' original rows), emission and NEE separately, so each
    lane sums in the masked loop's order. Returns the new (radiance, rays,
    beta, alive, specular, pend), the bounce's traced-ray count and what
    the audit reads."""
    traced = (rays.t_max > 0.0).sum()
    hit = intersect_fn(rays)
    lobes, emit = mat_mod.shading_at(scene.materials, scene.textures,
                                     hit.mat_id, hit.uv, hit.pos)
    # Emission counts on camera segments and after delta bounces.
    env, p_env = env_eval(rays.dir)
    direct_seen = torch.where(hit.hit[..., None], emit, env)
    count_emission = (alive & ((bounce == 0) | specular) if use_nee
                      else alive)
    radiance = bank(radiance, torch.where(count_emission[..., None],
                                          beta * direct_seen, 0.0))
    if pend is not None:
        radiance = bank(radiance, _resolve_pending(pend, hit, env, p_env))
    alive = alive & hit.hit

    frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
    u_bsdf = sampler.u2(pix, sid, bounce, smp.DIM_BSDF_UV)
    f, wi, pdf, is_delta = bsdf_mod.sample_bsdf(lobes, frame, hit.wo, u_bsdf)

    if use_nee and scene.num_lights > 0:
        u_sel = sampler.u1(pix, sid, bounce, smp.DIM_LIGHT_SELECT)
        u_light = sampler.u2(pix, sid, bounce, smp.DIM_LIGHT_UV)
        u_scatter = sampler.u2(pix, sid, bounce, smp.DIM_SCATTER_UV)
        if folded:
            l_direct, new_pend = nee.uniform_sample_one_light(
                scene, lobes, frame, hit.pos, hit.normal, hit.wo, u_sel,
                u_light, u_scatter, occlude_fn=occlude_fn, alive=alive,
                path_sample=(f, wi, pdf, is_delta))
            pend = {"coeff": torch.where(alive[..., None],
                                         beta * new_pend["coeff"], 0.0),
                    "t_light": torch.where(alive, new_pend["t_light"], 0.0),
                    "is_env": alive & new_pend["is_env"]}
            # One shadow batch per alive lane (the light-sampled arm).
            traced = traced + alive.sum()
        else:
            l_direct = nee.uniform_sample_one_light(
                scene, lobes, frame, hit.pos, hit.normal, hit.wo, u_sel,
                u_light, u_scatter, occlude_fn=occlude_fn, alive=alive)
            # Two shadow batches per alive lane (light + BSDF arms).
            traced = traced + 2 * alive.sum()
        radiance = bank(radiance, torch.where(alive[..., None],
                                              beta * l_direct, 0.0))

    cos_term = torch.abs(vm.dot(wi, frame.n))
    step_ok = (pdf > 0.0) & ((f[..., 0] > 0.0) | (f[..., 1] > 0.0)
                             | (f[..., 2] > 0.0))
    alive = alive & step_ok
    beta = torch.where(alive[..., None],
                       beta * f * (cos_term * vm.weak_recip(pdf))[..., None],
                       beta)
    rays = ray_mod.spawn(hit.pos, hit.normal, wi)

    # Russian roulette.
    if bounce > rr_start:
        q = torch.clamp_min(1.0 - vm.luminance(beta), 0.05)
        u_rr = sampler.u1(pix, sid, bounce, smp.DIM_RUSSIAN_ROULETTE)
        alive = alive & ~(u_rr < q)
        rr_scale = torch.where(alive, 1.0 / torch.clamp_min(1.0 - q, 1e-6),
                               1.0)
        beta = beta * rr_scale[..., None]
    # Dead lanes get t_max=0 so tracers can skip them; folded, a dead lane
    # owing a pending keeps the extent it needs for one more trace.
    t_dead = torch.zeros_like(rays.t_max)
    if folded:
        t_dead = _owed_extent(pend, rays.t_max)
    rays = rays.replace(t_max=torch.where(alive, rays.t_max, t_dead))
    seen = {"hit": hit, "frame": frame, "f": f, "wi": wi, "pdf": pdf,
            "lobes": lobes, "emit": emit}
    return radiance, rays, beta, alive, is_delta, pend, traced, seen


def _epilogue(pend, rays, radiance, bank, intersect_fn, env_eval):
    """One closest hit bounded to what is owed resolves the last bounce's
    pending: (radiance, traced-ray count)."""
    rays = rays.replace(t_max=_owed_extent(pend, rays.t_max))
    traced = (rays.t_max > 0.0).sum()
    hit = intersect_fn(rays)
    env, p_env = env_eval(rays.dir)
    return bank(radiance, _resolve_pending(pend, hit, env, p_env)), traced


def _owed_extent(pend, t_max):
    """The extent a pending needs: the full one for an env leg, just past
    the chosen light for an area leg, none otherwise."""
    pend_valid = pend["is_env"] | (pend["t_light"] > 0.0)
    owed = torch.where(pend["is_env"], t_max,
                       pend["t_light"] * (1.0 + 1e-3))
    return torch.where(pend_valid, owed, 0.0)


COMPACT_BLOCK = 8  # lanes move in blocks of 8; see compact_step
STATE_COLS = 20


def auto_schedule(alive_counts, n, margin=1.5, min_cap=1 << 14,
                  quantum=None):
    """Static per-bounce lane capacities from measured covered-lane counts
    (lanes in COMPACT_BLOCK blocks that hold an alive lane, as
    ``measure_alive`` reports them): margin x covered, rounded up to
    `quantum` lanes, clamped to [min_cap, n]; a shrink is scheduled only
    where it saves at least a quarter of the current size. With the default
    margin the capacity roulette keeps every block (p = 1)."""
    if quantum is None:
        quantum = max(256, min(8192, (n // 8) // 256 * 256))
    caps = [n]
    cur = n
    for c in list(alive_counts)[1:]:
        want = max(min_cap, int(margin * float(c)))
        q = -(-want // quantum) * quantum
        cap = min(cur, q)
        if cap > (3 * cur) // 4:
            cap = cur
        caps.append(cap)
        cur = cap
    return tuple(caps)


def measure_alive(scene, sampler, pixel_idx, sample_idx, intersect_fn,
                  max_depth=5, msaa=2, owed=False):
    """Pilot pass: each bounce's covered-lane count (lanes in
    COMPACT_BLOCK blocks with an alive lane) under the masked loop's
    survival rules, for ``auto_schedule``: an int64 tensor [max_depth].

    owed=True (folded NEE) counts instead, from the second bounce on, the
    lanes alive after the previous bounce's hit: a lane that dies there
    (roulette, a failed sample) may still owe its pending a resolution
    segment, which keeps its block in the batch. Counting live lanes only,
    as the JAX package's pilot does, under-provisions folded runs, and the
    capacity roulette then thins blocks the masked loop keeps."""
    rays = camera_rays(scene, sampler, pixel_idx, sample_idx, msaa)
    n = rays.n
    G = COMPACT_BLOCK
    dev = rays.origin.device
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    need = alive
    beta = torch.ones(n, 3, device=dev)
    counts = []
    for bounce in range(max_depth):
        counts.append(need.view(-1, G).any(dim=1).sum() * G)
        hit = intersect_fn(rays)
        alive = alive & hit.hit
        after_hit = alive
        lobes, _ = mat_mod.shading_at(scene.materials, scene.textures,
                                      hit.mat_id, hit.uv, hit.pos)
        frame = bsdf_mod.make_frame(hit.normal, hit.dpdu)
        u_bsdf = sampler.u2(pixel_idx, sample_idx, bounce, smp.DIM_BSDF_UV)
        f, wi, pdf, _ = bsdf_mod.sample_bsdf(lobes, frame, hit.wo, u_bsdf)
        cos_term = torch.abs(vm.dot(wi, frame.n))
        step_ok = (pdf > 0.0) & ((f[..., 0] > 0.0) | (f[..., 1] > 0.0)
                                 | (f[..., 2] > 0.0))
        alive = alive & step_ok
        beta = torch.where(
            alive[..., None],
            beta * f * (cos_term * vm.weak_recip(pdf))[..., None], beta)
        if bounce > 3:
            q = torch.clamp_min(1.0 - vm.luminance(beta), 0.05)
            u_rr = sampler.u1(pixel_idx, sample_idx, bounce,
                              smp.DIM_RUSSIAN_ROULETTE)
            alive = alive & ~(u_rr < q)
        rays = ray_mod.spawn(hit.pos, hit.normal, wi)
        rays = rays.replace(t_max=torch.where(alive, rays.t_max, 0.0))
        need = after_hit if owed else alive
    return torch.stack(counts)


def _pack_state(rays, beta, pix, sid, orig, specular, alive, pend=None):
    """The lane state as one [M, 20] float32 matrix (int columns bitcast),
    so compaction is one row gather. Columns 15-19 carry a folded pending
    (coeff 3, t_light, is_env), zero in two-arm mode."""
    if pend is None:
        dev = rays.origin.device
        pend = {"coeff": torch.zeros(rays.n, 3, device=dev),
                "t_light": torch.zeros(rays.n, device=dev),
                "is_env": torch.zeros(rays.n, dtype=torch.bool, device=dev)}

    def as_f(a):
        return a.to(torch.int32).view(torch.float32)[:, None]

    return torch.cat([
        rays.origin, rays.dir, rays.t_max[:, None], beta, as_f(pix),
        as_f(sid), as_f(orig), specular.to(torch.float32)[:, None],
        alive.to(torch.float32)[:, None], pend["coeff"],
        pend["t_light"][:, None], pend["is_env"].to(torch.float32)[:, None],
    ], dim=1)


def _unpack_state(s):
    def as_i(a):
        return a.contiguous().view(torch.int32)

    rays = ray_mod.RayBatch(origin=s[:, 0:3], dir=s[:, 3:6], t_max=s[:, 6])
    pend = {"coeff": s[:, 15:18], "t_light": s[:, 18],
            "is_env": s[:, 19] > 0.5}
    return (rays, s[:, 7:10], as_i(s[:, 10]), as_i(s[:, 11]),
            as_i(s[:, 12]), s[:, 13] > 0.5, s[:, 14] > 0.5, pend)


def _block_sort_key(rays, G):
    """Spatial key of each G-lane block: its first lane's origin in Morton
    order (6 bits an axis over the batch's own bounds), then its direction
    octant."""
    o = rays.origin[0::G]
    d = rays.dir[0::G]
    lo = o.min(dim=0).values
    hi = o.max(dim=0).values
    # A tensor numerator: ``scalar / tensor`` would round twice.
    inv = torch.full_like(lo, 63.0) / torch.clamp_min(hi - lo, 1e-30)
    # Clamped before the cast: XLA's float -> int32 saturates and takes NaN
    # to 0.
    q = torch.nan_to_num((o - lo) * inv, nan=0.0).clamp(0.0, 63.0).to(
        torch.int32)

    def part1by2(x):
        x = (x | (x << 8)) & 0x0300F
        x = (x | (x << 4)) & 0x030C3
        x = (x | (x << 2)) & 0x09249
        return x

    morton = (part1by2(q[:, 0]) | (part1by2(q[:, 1]) << 1)
              | (part1by2(q[:, 2]) << 2))
    octant = ((d[:, 0] < 0).to(torch.int32)
              | ((d[:, 1] < 0).to(torch.int32) << 1)
              | ((d[:, 2] < 0).to(torch.int32) << 2))
    return (morton << 3) | octant


def block_compact(rays, beta, pix, sid, orig, specular, alive, cap, u_c,
                  pend=None):
    """Capacity roulette, then one packed row gather of whole
    COMPACT_BLOCK-lane blocks down to `cap` lanes.

    A block that needs a slot (an alive lane, or a folded pending still
    owed) is kept with probability p = 1 when every such block fits, else
    0.95 capB / blocks needed (one uniform from the block's first lane),
    its throughput and pending scaled by 1 / p. The kept blocks go in the
    order of ``_block_sort_key`` (a stable sort, as jnp.argsort is).
    Returns the state of the `cap` lanes: (rays, beta, pix, sid, orig,
    specular, alive, pend)."""
    G = COMPACT_BLOCK
    cur = rays.n
    dev = rays.origin.device
    cur_b, cap_b = cur // G, cap // G
    pend_valid = (torch.zeros(cur, dtype=torch.bool, device=dev)
                  if pend is None
                  else pend["is_env"] | (pend["t_light"] > 0.0))
    need = alive | pend_valid
    balive = need.view(cur_b, G).any(dim=1)
    nb = balive.sum().to(torch.float32)
    p = torch.where(nb <= cap_b, 1.0, torch.full_like(nb, 0.95 * cap_b)
                    / torch.clamp_min(nb, 1.0))
    keepb = balive & (u_c.view(cur_b, G)[:, 0] < p)
    inv_p = torch.where(keepb.repeat_interleave(G), 1.0 / p, 1.0)[:, None]
    beta = beta * inv_p
    if pend is not None:
        pend = dict(pend, coeff=pend["coeff"] * inv_p)
    skey = torch.where(keepb, _block_sort_key(rays, G), 2 ** 30)
    selb = torch.argsort(skey, stable=True)[:cap_b]
    slot_alive = keepb[selb]
    packed = _pack_state(rays, beta, pix, sid, orig, specular, alive,
                         pend).view(cur_b, G * STATE_COLS)
    sp = packed[selb].view(cap_b * G, STATE_COLS)
    (rays, beta, pix, sid, orig, specular, lane_alive,
     pend) = _unpack_state(sp)
    slot_alive = slot_alive.repeat_interleave(G)
    alive = lane_alive & slot_alive
    lane_pend = pend["is_env"] | (pend["t_light"] > 0.0)
    pend["is_env"] = pend["is_env"] & slot_alive
    pend["t_light"] = torch.where(slot_alive, pend["t_light"], 0.0)
    keep_extent = alive | (lane_pend & slot_alive)
    rays = rays.replace(t_max=torch.where(keep_extent, rays.t_max, 0.0))
    return rays, beta, pix, sid, orig, specular, alive, pend


def block_bank(orig, n):
    """bank(radiance [n, 3], contrib [m, 3]) for lanes in the order `orig`
    gives (their original rows, moved in whole COMPACT_BLOCK blocks): each
    block row of the contribution adds onto its original block row."""
    G = COMPACT_BLOCK
    borig = (orig.view(-1, G)[:, 0] // G).to(torch.int64)

    def bank(radiance, contrib):
        return radiance.view(n // G, G * 3).index_add(
            0, borig, contrib.reshape(-1, G * 3)).view(n, 3)
    return bank


def compact_step(schedule, bounce, n, sampler, rays, beta, pix, sid, orig,
                 specular, alive, pend, bank, resort=False):
    """The shrink before bounce `bounce` of an n-lane batch: where
    schedule[bounce], in whole COMPACT_BLOCK blocks, is below the lanes in
    hand, ``block_compact`` on the lanes' DIM_COMPACT draws, and a bank
    that adds the kept lanes' contributions onto their original rows
    (``block_bank``). resort: at bounce >= 1 also where nothing shrinks,
    ``block_compact`` to the lanes in hand, a pure permutation into the
    blocks' spatial order (pbrs_tpu/integrators/wavefront.py:657-661);
    schedule None then keeps all n lanes. orig None is the identity layout
    (nothing moved yet); pend None carries no pending. Returns (rays, beta,
    pix, sid, orig, specular, alive, pend, bank), as given where nothing
    moves."""
    G = COMPACT_BLOCK
    head = n if schedule is None else schedule[0]
    assert head >= n and n % G == 0, (
        f"the compacting loop moves lanes in {G}-lane blocks from a "
        f"schedule measured at {n} lanes; got {head} for {n}: use the "
        f"masked loop")
    cap = n if schedule is None else min(schedule[bounce], n)
    cap -= cap % G
    if cap >= rays.n and not (resort and bounce > 0):
        return rays, beta, pix, sid, orig, specular, alive, pend, bank
    cap = min(cap, rays.n)
    if orig is None:
        dev = rays.origin.device
        pix = torch.as_tensor(pix, device=dev).to(torch.int32)
        sid = torch.as_tensor(sid, device=dev).to(torch.int32).expand(
            rays.n).contiguous()
        orig = torch.arange(rays.n, dtype=torch.int32, device=dev)
    u_c = sampler.u1(pix, sid, bounce, smp.DIM_COMPACT)
    (rays, beta, pix, sid, orig, specular, alive,
     pend_c) = block_compact(rays, beta, pix, sid, orig, specular, alive,
                             cap, u_c, pend=pend)
    return (rays, beta, pix, sid, orig, specular, alive,
            None if pend is None else pend_c, block_bank(orig, n))


def render_samples(scene, sampler, pixel_idx, sample_idx, intersect_fn,
                   occlude_fn, max_depth=5, msaa=2, nee_mode="twoarm",
                   use_nee=True, filter_table=None, audit=False,
                   shrink_schedule=None, resort=False):
    """Camera rays + path integration for a (pixel, sample) batch:
    (radiance [N,3], traced-ray count), plus the audit counts with
    audit=True. A weighted filter scales each sample's radiance by its
    signed filter weight. shrink_schedule compacts the lanes between
    bounces and resort sorts them (``path_radiance``)."""
    rays, weight = camera_rays_weighted(scene, sampler, pixel_idx,
                                        sample_idx, msaa, filter_table)
    out = path_radiance(scene, rays, sampler, pixel_idx, sample_idx,
                        intersect_fn, occlude_fn, max_depth=max_depth,
                        nee_mode=nee_mode, use_nee=use_nee, audit=audit,
                        shrink_schedule=shrink_schedule, resort=resort)
    if weight is None:
        return out
    return (out[0] * weight[..., None],) + tuple(out[1:])
