"""Next-event estimation with multiple importance sampling. Mirrors
pbrs_tpu/integrators/nee.py for delta lights, area lights and every
environment kind, with the importance-sampled arm of an image
environment, in its two-arm and folded modes.

One light is chosen uniformly per ray among delta + area + env. Two-arm:
two shadow batches per call, the light-sampled direction and the
BSDF-sampled one (shared by the area-MIS arm and the env arm). Folded:
the path's own BSDF sample is the second arm's, so only the light-sampled
batch is traced and the second arm is returned as a pending contribution
for the next bounce's closest hit to resolve.
"""

from __future__ import annotations

import torch

from ..bxdf import bsdf as bsdf_mod
from ..core import vecmath as vm
from ..geometry import ray as ray_mod
from ..lights import env_sampling as es
from ..lights import lights as lt


def _power2_heuristic(f_pdf, g_pdf):
    f2 = f_pdf * f_pdf
    g2 = g_pdf * g_pdf
    return f2 / torch.clamp_min(f2 + g2, 1e-30)


def uniform_sample_one_light(scene, lobes, frame, hit_pos, hit_normal, wo,
                             u_select, u_light, u_scatter, occlude_fn, alive,
                             path_sample=None):
    """Direct lighting [N,3] at shading points. `occlude_fn(rays)` is the
    any-hit query; lanes with `alive` false get t_max=0 shadow rays.

    path_sample: the folded mode. Given the path's own BSDF sample (f, wi,
    pdf, is_delta), returns (light-arm radiance, pending): the
    BSDF-sampled arm is not traced here, and pending is {coeff [N,3],
    t_light [N], is_env [N]}: at the next hit add coeff * env(dir) where
    is_env and the ray escaped, and coeff where not is_env and hit.t >=
    t_light (the chosen light was the closest thing along the ray). Under
    env-IS the env lanes carry the BSDF pdf in t_light, for the deferred
    MIS weight."""
    def mask_dead(rays):
        return rays.replace(t_max=torch.where(alive, rays.t_max, 0.0))

    n_delta = scene.delta_lights.count
    n_area = scene.area_lights.count
    has_env = 1 if scene.env.kind != lt.ENV_NONE else 0
    n_lights = n_delta + n_area + has_env
    if n_lights == 0:
        return torch.zeros_like(hit_pos)

    chosen = torch.clamp_max((u_select * n_lights).to(torch.int32),
                             n_lights - 1)
    arm_delta = chosen < n_delta
    arm_area = (chosen >= n_delta) & (chosen < n_delta + n_area)
    arm_env = chosen >= n_delta + n_area
    result = torch.zeros_like(hit_pos)
    a_idx = torch.clamp(chosen - n_delta, 0, max(n_area - 1, 0))
    # An image environment with a distribution gets a light-sampled leg
    # too; both legs MIS-combine with the power-2 heuristic.
    env_is = bool(has_env) and scene.env.dist is not None

    # ------------- light-sampled arm (delta + area + env-IS) -------------
    if n_delta + n_area > 0 or env_is:
        z_axis = torch.tensor([0.0, 0.0, 1.0], device=hit_pos.device)
        li_l = torch.zeros_like(hit_pos)
        wi_l = z_axis.expand_as(hit_pos)
        target_l = hit_pos
        pdf_l = torch.ones_like(hit_pos[..., 0])
        if n_delta > 0:
            li_d, wi_d, target_d = lt.sample_delta(
                scene.delta_lights, torch.clamp(chosen, 0, n_delta - 1),
                hit_pos)
            d3 = arm_delta[..., None]
            li_l = torch.where(d3, li_d, li_l)
            wi_l = torch.where(d3, wi_d, wi_l)
            target_l = torch.where(d3, target_d, target_l)
        if n_area > 0:
            li_a, wi_a, pdf_a, pt_a = lt.sample_area(
                scene.area_lights, a_idx, hit_pos, u_light)
            a3 = arm_area[..., None]
            li_l = torch.where(a3, li_a, li_l)
            wi_l = torch.where(a3, wi_a, wi_l)
            target_l = torch.where(a3, pt_a, target_l)
            pdf_l = torch.where(arm_area, pdf_a, pdf_l)
        if env_is:
            wi_e, li_e, pdf_e = es.sample_env(scene.env.dist, u_light)
            e3 = arm_env[..., None]
            li_l = torch.where(e3, li_e, li_l)
            wi_l = torch.where(e3, wi_e, wi_l)
            pdf_l = torch.where(arm_env, pdf_e, pdf_l)

        f_l = bsdf_mod.eval_bsdf(lobes, frame, wo, wi_l) * torch.abs(
            vm.dot(hit_normal, wi_l))[..., None]
        scatter_pdf = bsdf_mod.pdf_bsdf(lobes, frame, wo, wi_l)
        shadow = ray_mod.spawn_limited_to(hit_pos, hit_normal, target_l)
        if env_is:
            # Env-arm visibility is an unbounded ray along wi_e.
            unb = ray_mod.spawn(hit_pos, hit_normal, wi_l)
            e3 = arm_env[..., None]
            shadow = ray_mod.RayBatch(
                origin=torch.where(e3, unb.origin, shadow.origin),
                dir=torch.where(e3, unb.dir, shadow.dir),
                t_max=torch.where(arm_env, unb.t_max, shadow.t_max))
        occluded_l = occlude_fn(mask_dead(shadow))
        # MIS weight: 1 for delta lights, power 2 otherwise.
        weight = torch.where(arm_delta, 1.0,
                             _power2_heuristic(pdf_l, scatter_pdf))
        arm_sampled = arm_delta | arm_area
        if env_is:
            arm_sampled = arm_sampled | arm_env
        valid = (arm_sampled & ~occluded_l & (pdf_l > 0.0)
                 & ((li_l[..., 0] > 0.0) | (li_l[..., 1] > 0.0)
                    | (li_l[..., 2] > 0.0)))
        contrib = f_l * li_l * (weight * vm.weak_recip(pdf_l))[..., None]
        result = result + torch.where(valid[..., None], contrib, 0.0)

    if path_sample is not None:
        return result * float(n_lights), _folded_pending(
            scene, path_sample, hit_pos, hit_normal, a_idx, arm_area, arm_env,
            n_lights, env_is)
    if not (n_area > 0 or has_env):
        return result * float(n_lights)

    # ---------------- BSDF-sampled arm (area MIS + env) ----------------
    f_b, wi_b, pdf_b, is_delta_b = bsdf_mod.sample_bsdf(lobes, frame, wo,
                                                        u_scatter)
    f_b = f_b * torch.abs(vm.dot(hit_normal, wi_b))[..., None]
    if n_area > 0:
        li_b, pdf_light_b, hit_light, pt_b = lt.area_radiance_to(
            scene.area_lights, a_idx, hit_pos, wi_b)
    else:
        pt_b = hit_pos

    # Shared shadow batch: bounded to the light point on the area arm,
    # unbounded on the env arm.
    shadow_b = ray_mod.spawn_limited_to(hit_pos, hit_normal, pt_b)
    env_rays = ray_mod.spawn(hit_pos, hit_normal, wi_b)
    e3 = arm_env[..., None]
    shadow2 = ray_mod.RayBatch(
        origin=torch.where(e3, env_rays.origin, shadow_b.origin),
        dir=torch.where(e3, env_rays.dir, shadow_b.dir),
        t_max=torch.where(arm_env, env_rays.t_max, shadow_b.t_max))
    occluded_b = occlude_fn(mask_dead(shadow2))

    if n_area > 0:
        weight_b = _power2_heuristic(pdf_b, pdf_light_b)
        # Delta-sampled directions are excluded from the NEE BSDF arm.
        valid_b = (arm_area & hit_light & ~is_delta_b & ~occluded_b
                   & (pdf_b > 0.0) & (pdf_light_b > 0.0)
                   & ((f_b[..., 0] > 0.0) | (f_b[..., 1] > 0.0)
                      | (f_b[..., 2] > 0.0)))
        contrib_b = f_b * li_b * (weight_b * vm.weak_recip(pdf_b))[..., None]
        result = result + torch.where(valid_b[..., None], contrib_b, 0.0)

    if has_env:
        valid_e = arm_env & ~is_delta_b & ~occluded_b & (pdf_b > 0.0)
        if env_is:
            # One texel lookup for the radiance and the MIS pdf.
            li_env, p_e = es.eval_env_pdf(scene.env, wi_b)
            weight_e = _power2_heuristic(pdf_b, p_e)
        else:
            li_env = lt.eval_env(scene.env, wi_b)
            weight_e = 1.0
        contrib_e = f_b * li_env * (weight_e
                                    * vm.weak_recip(pdf_b))[..., None]
        result = result + torch.where(valid_e[..., None], contrib_e, 0.0)

    # 1 / light_pdf = n_lights.
    return result * float(n_lights)


def _folded_pending(scene, path_sample, hit_pos, hit_normal, a_idx, arm_area,
                    arm_env, n_lights, env_is):
    """The BSDF-sampled arm of the folded mode, as the next bounce's
    pending contribution (see uniform_sample_one_light)."""
    n = hit_pos.shape[0]
    coeff = torch.zeros_like(hit_pos)
    t_light = torch.zeros(n, device=hit_pos.device)
    is_env = torch.zeros(n, dtype=torch.bool, device=hit_pos.device)
    if scene.area_lights.count == 0 and scene.env.kind == lt.ENV_NONE:
        return {"coeff": coeff, "t_light": t_light, "is_env": is_env}
    f_b, wi_b, pdf_b, is_delta_b = path_sample
    f_b = f_b * torch.abs(vm.dot(hit_normal, wi_b))[..., None]
    if scene.area_lights.count > 0:
        li_b, pdf_light_b, hit_light, pt_b = lt.area_radiance_to(
            scene.area_lights, a_idx, hit_pos, wi_b)
        weight_b = _power2_heuristic(pdf_b, pdf_light_b)
        valid_b = (arm_area & hit_light & ~is_delta_b & (pdf_b > 0.0)
                   & (pdf_light_b > 0.0)
                   & ((f_b[..., 0] > 0.0) | (f_b[..., 1] > 0.0)
                      | (f_b[..., 2] > 0.0)))
        contrib_b = f_b * li_b * (weight_b * vm.weak_recip(pdf_b))[
            ..., None] * float(n_lights)
        coeff = torch.where(valid_b[..., None], contrib_b, coeff)
        # Distance along the continuation ray (spawned the same way) to the
        # light point.
        org = ray_mod.spawn(hit_pos, hit_normal, wi_b).origin
        t_light = torch.where(valid_b, vm.dot(pt_b - org, wi_b), t_light)
    if scene.env.kind != lt.ENV_NONE:
        # The env radiance is the next bounce's escape term: the
        # coefficient leaves it (and, under env-IS, the MIS weight) out.
        valid_e = arm_env & ~is_delta_b & (pdf_b > 0.0)
        ce = f_b * vm.weak_recip(pdf_b)[..., None] * float(n_lights)
        coeff = torch.where(valid_e[..., None], ce, coeff)
        if env_is:
            t_light = torch.where(valid_e, pdf_b, t_light)
        is_env = valid_e
    return {"coeff": coeff, "t_light": t_light, "is_env": is_env}
