"""Next-event estimation with balance-heuristic MIS (replaces direct.fut).

Per bounce, each live lane stochastically selects ONE light (uniform over
scene lights + per-ray transmitter fan), then combines a light-area sample
and a BSDF sample with the balance heuristic — UniformSampleOneLight of
PBR Book 14.3 (direct.fut:106-122).

Wavefront shape: the reference appends the transmitter to the light
list per ray (integrator.fut:96, flagged by its own TODO as a strange
pattern); we instead treat the transmitter as an explicit per-ray
light-table extension: indices [0, L) fetch the packed static light
table via ops/tables.py (rows come back transposed — its (23, N) rows
ARE the V3 vertex blocks, zero relayout), [L, L+8) select the lane's own transmitter fan
sector by a static where-chain. The light's emission spectrum is
evaluated ONCE per lane at the hero wavelength; both MIS halves reuse it.
The two shadow queries per bounce batch into two any_hit calls.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from tracer_tpu.models import camera as cam_mod
from tracer_tpu.models import lights as lights_mod
from tracer_tpu.models import scene as scene_mod
from tracer_tpu.ops import linalg as la
from tracer_tpu.ops import materials, shapes, tables
from tracer_tpu.ops import rng as prng
from tracer_tpu.ops import spectrum as spec

OCCLUSION_EPS = 0.01  # direct.fut:11


class LaneLights(NamedTuple):
    """The one light each lane selected, with its emission already
    evaluated at the lane's hero wavelength. Vertices are V3 (3, N)."""
    kind: jax.Array    # (N,) f32 (lights_mod.KIND_* as float)
    a: jax.Array       # (3, N)
    b: jax.Array       # (3, N)
    c: jax.Array       # (3, N)
    theta: jax.Array   # (N,)
    em_val: jax.Array  # (N,)


def select_lane_light(state, scene: scene_mod.Scene,
                      trans_sectors, transmitter_kind: str,
                      trans_theta, trans_emission, wavelen, n_rays: int):
    """Uniformly pick one light per lane from scene lights + transmitter
    fan (random_select, direct.fut:118). Returns (state, LaneLights,
    n_lights) or (state, None, 0) when there are no lights at all."""
    n_scene = scene.lights.count
    n_trans = 0 if trans_sectors is None else len(trans_sectors)
    n_lights = n_scene + n_trans
    if n_lights == 0:
        return state, None, 0

    state, li = prng.select(state, n_lights)

    if n_scene > 0:
        si = jnp.clip(li, 0, n_scene - 1)
        rows = tables.take_rows_t(scene.light_table, si)  # (23, N)
        va, vb, vc = rows[0:3], rows[3:6], rows[6:9]
        em_val = spec.lookup_pairs(
            wavelen, [(rows[9 + 2 * k], rows[10 + 2 * k]) for k in range(6)])
        theta = rows[21]
        kind = rows[22]
    else:
        zero3 = jnp.zeros((3, n_rays), jnp.float32)
        va, vb, vc = zero3, zero3, zero3
        em_val = jnp.zeros((n_rays,), jnp.float32)
        theta = jnp.zeros((n_rays,), jnp.float32)
        kind = jnp.zeros((n_rays,), jnp.float32)

    if n_trans > 0:
        ti = li - n_scene
        # static where-chain over the 8 fan sectors — no gather
        ta, tb, tc = trans_sectors[0]
        for k in range(1, n_trans):
            m = ti == k
            sa, sb, sc = trans_sectors[k]
            ta = jnp.where(m, sa, ta)
            tb = jnp.where(m, sb, tb)
            tc = jnp.where(m, sc, tc)
        t_kind = float(lights_mod.KIND_FRUSTUM_AREA
                       if transmitter_kind == cam_mod.TRANSMITTER_SCANNING
                       else lights_mod.KIND_DIFFUSE_AREA)
        t_em = spec.lookup_pairs(
            wavelen, [(trans_emission[k, 0], trans_emission[k, 1])
                      for k in range(6)])
        is_t = li >= n_scene
        kind = jnp.where(is_t, t_kind, kind)
        va = jnp.where(is_t, ta, va)
        vb = jnp.where(is_t, tb, vb)
        vc = jnp.where(is_t, tc, vc)
        theta = jnp.where(is_t, trans_theta, theta)
        em_val = jnp.where(is_t, t_em, em_val)

    return state, LaneLights(kind=kind, a=va, b=vb, c=vc, theta=theta,
                             em_val=em_val), n_lights


def _shadow_ray(hit_pos, hit_normal, lightp):
    """Backface test + shadow-ray setup (occluded, direct.fut:7-15),
    query deferred so callers can batch several into one any_hit."""
    v = lightp - hit_pos
    w = la.v3_normalize(v, eps=1e-30)
    backface = la.v3_dot(w, hit_normal) <= 0
    dist = la.v3_norm(v)
    o, d = shapes.mkray_adjust_acne_v(hit_pos, hit_normal, w)
    return backface, o, d, dist - OCCLUSION_EPS


def occluded(scene, hit_pos, hit_normal, lightp):
    """Backface test + shadow ray (occluded, direct.fut:7-15)."""
    backface, o, d, tmax = _shadow_ray(hit_pos, hit_normal, lightp)
    return backface | scene_mod.any_hit(scene, tmax, o, d)


def balance(pdf_f, pdf_g):
    """Balance heuristic with nf = ng = 1 (direct.fut:56-58)."""
    return pdf_f / (pdf_f + pdf_g)


def incident_radiance(light: LaneLights, hitp, lightp):
    """arealight_incident_radiance (light.fut:19-55) with the spectrum
    value precomputed; per-lane kind dispatch."""
    v = lightp - hitp
    wi = la.v3_normalize(v, eps=1e-30)
    dist_sq = jnp.maximum(la.v3_quadrance(v), 1e-30)
    lnormal = shapes.triangle_normal_v(light.a, light.b, light.c)
    cos_theta_l = la.v3_dot(-wi, lnormal)
    diffuse = jnp.maximum(0.0, light.em_val * cos_theta_l / dist_sq)
    inside = jnp.arccos(jnp.clip(cos_theta_l, -1.0, 1.0)) <= light.theta
    frustum = jnp.where(inside, light.em_val / dist_sq, 0.0)
    point = light.em_val / dist_sq
    return jnp.where(light.kind == lights_mod.KIND_FRUSTUM_AREA, frustum,
                     jnp.where(light.kind == lights_mod.KIND_POINT, point,
                               diffuse))


def estimate_direct(state, scene: scene_mod.Scene, wo,
                    inter: scene_mod.Interaction, light: LaneLights,
                    mask=None):
    """MIS light-sample + BSDF-sample estimate toward each lane's light
    (estimate_direct, direct.fut:63-103). Returns (state, radiance (N,)).

    mask (N,) bool, optional: lanes whose result the caller will discard
    (dead/miss lanes in the pooled integrator). Their shadow rays — and
    any half whose contribution is provably zero before the occlusion
    test (backface, zero BSDF toward the light, BSDF sample that misses
    the light) — are traced with tmax 0, so the intersector's schedule
    and slab cull skip them. The estimator is unchanged: only queries
    whose results are multiplied by zero are suppressed; RNG stream
    order is untouched (occlusion consumes no RNG)."""
    is_point = light.kind == lights_mod.KIND_POINT
    e1 = light.b - light.a
    e2 = light.c - light.a
    area = la.v3_norm(la.v3_cross(e1, e2)) * 0.5
    inv_area = 1.0 / jnp.maximum(area, 1e-30)

    # --- light sampling (sample_light, direct.fut:24-53)
    state, (u, v) = prng.in_triangle(state)
    p_area = light.a + u * e1 + v * e2
    lightp = jnp.where(is_point, light.a, p_area)
    wi_l = la.v3_normalize(lightp - inter.pos, eps=1e-30)

    in_radiance = incident_radiance(light, inter.pos, lightp)
    light_pdf = jnp.where(is_point, 1.0, inv_area)

    f_l = (materials.bsdf_f(wo, wi_l, inter.normal, inter.mat)
           * jnp.abs(la.v3_dot(wi_l, inter.normal)))
    scattering_pdf = materials.bsdf_pdf(wo, wi_l, inter.normal, inter.mat)
    weight_l = balance(light_pdf, scattering_pdf)

    # --- BSDF sampling toward the same light (direct.fut:79-102);
    # zero for point lights (a BSDF sample almost surely misses a point).
    state, wi_b, bsdf_b, pdf_b, kind_b = materials.sample_dir(
        state, wo, inter.normal, inter.mat)
    o_b, d_b = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi_b)
    hit_ok, _, lh_pos, _ = shapes.hit_triangle_v(
        shapes.F32_HIGHEST, o_b, d_b, light.a, light.b, light.c)

    # Both MIS halves' shadow queries batch into ONE any_hit over 2N
    # rays — occlusion consumes no RNG, so stream order is unchanged.
    bf_l, so_l, sd_l, st_l = _shadow_ray(inter.pos, inter.normal, lightp)
    bf_b, so_b, sd_b, st_b = _shadow_ray(inter.pos, inter.normal, lh_pos)
    in_rad_b = incident_radiance(light, inter.pos, lh_pos)

    # Zero-contribution suppression: every factor below also gates the
    # corresponding *_part expression, so a suppressed query's (garbage)
    # occlusion bit never reaches the estimate.
    live_l = (~bf_l & (light_pdf != 0) & (in_radiance != 0) & (f_l != 0)
              & (weight_l != 0))
    live_b = (~is_point & hit_ok & ~bf_b & (in_rad_b != 0)
              & (((kind_b == materials.PDF_DELTA)
                  | (kind_b == materials.PDF_NONZERO)) & (bsdf_b != 0)))
    if mask is not None:
        live_l &= mask
        live_b &= mask
    # Occupancy repacking: per lane at most one half is usually live (a
    # diffuse lobe's BSDF sample almost surely misses the light; a delta
    # lobe's light sample has f_l == 0), so slot 0 carries whichever half
    # is live and slot 1 only the rare both-live lanes. The second N-lane
    # block is then almost entirely tmax-0, so its ray tiles' schedules
    # are empty and the kernel skips them — vs the unpacked layout where
    # live BSDF rays scatter through the whole second half. Measured on
    # SpectrumSphere 512x512/64spp: anyhit 1.30 -> ~0.9 ms/iter.
    b_only = live_b & ~live_l
    both = live_b & live_l
    pick = lambda l, b: jnp.where(b_only, b, l)
    n = wi_l.shape[-1]
    blocked = scene_mod.any_hit(
        scene,
        jnp.concatenate([
            jnp.where(live_l | live_b, pick(st_l, st_b), 0.0),
            jnp.where(both, st_b, 0.0)]),
        jnp.concatenate([pick(so_l, so_b), so_b], axis=1),
        jnp.concatenate([pick(sd_l, sd_b), sd_b], axis=1))
    occ = bf_l | blocked[:n]
    occ_b = bf_b | jnp.where(both, blocked[n:], blocked[:n])

    in_radiance = jnp.where(occ, 0.0, in_radiance)
    light_part = jnp.where(
        (light_pdf == 0) | (in_radiance == 0), 0.0,
        f_l * weight_l * in_radiance / light_pdf)

    f_b = bsdf_b * jnp.abs(la.v3_dot(wi_b, inter.normal))
    weight_b = balance(pdf_b, inv_area)
    contrib = jnp.where(
        kind_b == materials.PDF_DELTA, f_b * in_rad_b,
        jnp.where(kind_b == materials.PDF_NONZERO,
                  f_b * in_rad_b * weight_b / jnp.maximum(pdf_b, 1e-30),
                  0.0))
    bsdf_part = jnp.where(is_point | ~hit_ok | occ_b, 0.0, contrib)

    return state, light_part + bsdf_part


def direct_radiance(state, scene: scene_mod.Scene, wo,
                    inter: scene_mod.Interaction, wavelen,
                    trans_sectors, transmitter_kind: str,
                    trans_theta, trans_emission, mask=None):
    """One-light estimate scaled by light count (direct_radiance,
    direct.fut:111-122). Returns (state, radiance (N,)). mask: see
    estimate_direct — lanes whose result the caller discards."""
    n_rays = wo.shape[-1]
    state, light, n_lights = select_lane_light(
        state, scene, trans_sectors, transmitter_kind, trans_theta,
        trans_emission, wavelen, n_rays)
    if light is None:
        return state, jnp.zeros((n_rays,), jnp.float32)
    state, radiance = estimate_direct(state, scene, wo, inter, light,
                                      mask=mask)
    return state, radiance * jnp.float32(n_lights)
