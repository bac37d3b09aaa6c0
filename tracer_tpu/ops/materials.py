"""Uber-BSDF material model, fully vectorized (replaces material.fut).

The material is a metalness-lerped blend of a metal and a dielectric;
the dielectric blends Fresnel-weighted Torrance-Sparrow (Beckmann)
reflection against an opacity-lerped diffuse/transmission refraction
(reference src/material.fut:12-18, :317-370). All evaluation happens at a
single wavelength per path (spectral rendering with one hero wavelength).

Re-design notes:
  * Every function maps over (N,) lanes; directions are TRANSPOSED
    vectors (3, N) (linalg.py V3 convention) so (N,) scalars and vectors
    mix without layout changes.
  * The reference's stochastic if/else branch tree (material.fut:336-344,
    :365-370) becomes compute-all-candidates + select, which keeps the
    lanes convergent: the three candidate lobes (microfacet reflection, cosine
    diffuse, specular transmission) are a handful of elementwise ops each.
  * "Local space" maps the shading normal to +z via an orthonormal basis
    (material.fut:372-410); component reads are free major-axis slices.
  * The sample PDF sum type #delta|#impossible|#nonzero (material.fut:45-54)
    becomes (value f32, kind int32) lane pairs.

Preserved quirks (documented, deliberate):
  * uber_pdf lerps (metal, dielectric, metalness) while uber_bsdf lerps
    (dielectric, metal, metalness) — the reference's reversed order
    (material.fut:358 vs :361) only skews MIS weights, not energy.
  * the dispersion hack ref_ix' = ref_ix - (wavelen-589)/1e4
    (material.fut:38-41).
  * Beckmann alpha = 1.62142 * max(roughness, 0.004) (material.fut:241-248).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tracer_tpu.ops import linalg as la
from tracer_tpu.ops import rng as prng
from tracer_tpu.ops import spectrum as spec

# PDF kinds (material.fut:45-54)
PDF_IMPOSSIBLE = 0
PDF_DELTA = 1
PDF_NONZERO = 2

_EPS_ROUGHNESS = 0.004
_ALPHA_SCALE = 1.62142


class MaterialTable(NamedTuple):
    """SoA material table, byte-compatible with the loader's 28-float rows
    (reference src/scene.fut:37-53)."""
    color: jnp.ndarray      # (M, 6, 2)
    roughness: jnp.ndarray  # (M,)
    metalness: jnp.ndarray  # (M,)
    ref_ix: jnp.ndarray     # (M,)
    opacity: jnp.ndarray    # (M,)
    emission: jnp.ndarray   # (M, 6, 2)


def parse_mats(mat_rows) -> MaterialTable:
    """Decode (M, 28) rows: 12 color knots, roughness, metalness, ref_ix,
    opacity, 12 emission knots (scene.fut:37-53)."""
    m = jnp.asarray(mat_rows, jnp.float32)
    return MaterialTable(
        color=m[:, 0:12].reshape(-1, 6, 2),
        roughness=m[:, 12],
        metalness=m[:, 13],
        ref_ix=m[:, 14],
        opacity=m[:, 15],
        emission=m[:, 16:28].reshape(-1, 6, 2),
    )


class MaterialLanes(NamedTuple):
    """Per-lane material properties at one wavelength (material' in
    material.fut:25-30)."""
    color: jnp.ndarray      # (N,)
    roughness: jnp.ndarray  # (N,)
    metalness: jnp.ndarray  # (N,)
    ref_ix: jnp.ndarray     # (N,)
    opacity: jnp.ndarray    # (N,)


def at_wavelength(table: MaterialTable, mat_ix, wavelen) -> MaterialLanes:
    """Gather per-lane material rows and evaluate at the hero wavelength
    (material_at_wavelen, material.fut:32-42, incl. the dispersion hack).
    Cold-path variant (device gather); the integrator uses
    at_wavelength_rows instead."""
    mat_ix = jnp.asarray(mat_ix, jnp.int32)
    color = spec.lookup(wavelen, table.color[mat_ix])
    ref_ix = table.ref_ix[mat_ix] - (wavelen - 589.0) / 10000.0
    return MaterialLanes(
        color=color,
        roughness=table.roughness[mat_ix],
        metalness=table.metalness[mat_ix],
        ref_ix=ref_ix,
        opacity=table.opacity[mat_ix],
    )


def at_wavelength_rows(rows_t, wavelen):
    """Evaluate materials from transposed 28-float rows (28, N) — the
    hot-path variant fed by a one-hot matmul row lookup (ops/tables.py)
    instead of a device gather.

    Returns (MaterialLanes, emission_value (N,)): both the reflectance
    color and the emission spectrum evaluated at the hero wavelength
    (material_at_wavelen material.fut:32-42 + the emission lookup the
    integrator performs at the first bounce, integrator.fut:52)."""
    color = spec.lookup_pairs(
        wavelen, [(rows_t[2 * k], rows_t[2 * k + 1]) for k in range(6)])
    emission = spec.lookup_pairs(
        wavelen, [(rows_t[16 + 2 * k], rows_t[17 + 2 * k]) for k in range(6)])
    lanes = MaterialLanes(
        color=color,
        roughness=rows_t[12],
        metalness=rows_t[13],
        ref_ix=rows_t[14] - (wavelen - 589.0) / 10000.0,
        opacity=rows_t[15],
    )
    return lanes, emission


# ---------------------------------------------------------------------------
# Local frame (material.fut:372-410). All vectors are V3 = (3, N).

def make_onb(normal):
    """Orthonormal basis with the normal as +z (material.fut:374-379)."""
    nx, ny, nz = normal[0], normal[1], normal[2]
    use_x = jnp.abs(nx) > jnp.abs(nz)
    zeros = jnp.zeros_like(nx)
    binormal = jnp.where(use_x,
                         la.v3(-ny, nx, zeros),
                         la.v3(zeros, -nz, ny))
    binormal = la.v3_normalize(binormal, eps=1e-30)
    tangent = la.v3_cross(binormal, normal)
    return tangent, binormal, normal


def world_to_local(onb, w):
    tangent, binormal, normal = onb
    return la.v3(la.v3_dot(w, tangent), la.v3_dot(w, binormal),
                 la.v3_dot(w, normal))


def local_to_world(onb, w):
    tangent, binormal, normal = onb
    return w[0] * tangent + w[1] * binormal + w[2] * normal


# ---------------------------------------------------------------------------
# Local-space trig helpers (material.fut:69-86)

def cos_theta(w):
    return w[2]


def cos2_theta(w):
    return w[2] * w[2]


def sin2_theta(w):
    return jnp.maximum(0.0, 1.0 - cos2_theta(w))


def tan2_theta(w):
    return sin2_theta(w) / cos2_theta(w)


def same_hemisphere(w, u):
    return w[2] * u[2] > 0


def reflect(w, n):
    """material.fut:90-91"""
    return 2.0 * la.v3_dot(w, n) * n - w


# ---------------------------------------------------------------------------
# Lobes

def diffuse_bsdf(m: MaterialLanes):
    return m.color * la.INV_PI


def diffuse_pdf(wo, wi):
    return jnp.where(same_hemisphere(wo, wi), cos_theta(wi) * la.INV_PI, 0.0)


def cosine_sample_hemisphere(state):
    """Malley's method (material.fut:106-112)."""
    state, (dx, dy) = prng.in_unit_disk_xy(state)
    sin2t = dx * dx + dy * dy
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2t))
    return state, la.v3(dx, dy, z)


def refract(wi, n, eta):
    """Snell refraction with total-internal-reflection fallback
    (material.fut:132-142). Returns (wt, tir_mask)."""
    cos_i = la.v3_dot(n, wi)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta * eta * sin2_i
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    wt = -eta * wi + (eta * cos_i - cos_t) * n
    wt = jnp.where(tir, reflect(wi, n), wt)
    return wt, tir


def transmission_sample(wo, m: MaterialLanes):
    """Specular transmission / TIR (material.fut:166-183). The BSDF value
    1/|cos| with a delta pdf mirrors the reference, including its admitted
    approximation for the TIR branch."""
    entering = cos_theta(wo) > 0
    local_n = la.v3_const(0.0, 0.0, 1.0)
    n = jnp.where(entering, local_n, -local_n)
    eta = jnp.where(entering, 1.0 / m.ref_ix, m.ref_ix)
    wi, _ = refract(wo, n, eta)
    bsdf = 1.0 / jnp.maximum(jnp.abs(cos_theta(wi)), 1e-12)
    return wi, bsdf


def fresnel_reflectance(wo, m: MaterialLanes):
    """Schlick approximation, air outside (material.fut:207-211)."""
    r0 = ((1.0 - m.ref_ix) / (1.0 + m.ref_ix)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_theta(wo)) ** 5


def beckmann_alpha(roughness):
    return _ALPHA_SCALE * jnp.maximum(roughness, _EPS_ROUGHNESS)


def microfacet_distribution(alpha, wh):
    """Beckmann-Spizzichino D (material.fut:218-223)."""
    t2 = tan2_theta(wh)
    c2 = cos2_theta(wh)
    d = jnp.exp(-t2 / (alpha * alpha)) / (
        math.pi * alpha * alpha * c2 * c2)
    return jnp.where(jnp.isinf(t2) | jnp.isnan(t2), 0.0, d)


def _lambda_beckmann(alpha, w):
    abs_tan = jnp.sqrt(jnp.maximum(tan2_theta(w), 0.0))
    a = 1.0 / (alpha * abs_tan)
    lam = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    lam = jnp.where(a >= 1.6, 0.0, lam)
    return jnp.where(jnp.isinf(abs_tan) | jnp.isnan(abs_tan), 0.0, lam)


def self_shadowing_factor(alpha, wo, wi):
    """Rational-approximation Beckmann G (material.fut:229-239)."""
    return 1.0 / (1.0 + _lambda_beckmann(alpha, wo) + _lambda_beckmann(alpha, wi))


def microfacet_factor(wo, wi, m: MaterialLanes):
    wh = la.v3_normalize(wi + wo, eps=1e-30)
    alpha = beckmann_alpha(m.roughness)
    return microfacet_distribution(alpha, wh) * self_shadowing_factor(alpha, wo, wi)


def dielectric_reflection_bsdf(wo, wi, m: MaterialLanes):
    """Torrance-Sparrow without the F factor: F is realized by sampling
    reflection with frequency F instead (material.fut:258-266)."""
    denom = 4.0 * cos_theta(wo) * cos_theta(wi)
    return microfacet_factor(wo, wi, m) / denom


def dielectric_reflection_pdf(wo, wi, m: MaterialLanes):
    """material.fut:298-302"""
    wh = la.v3_normalize(wo + wi, eps=1e-30)
    alpha = beckmann_alpha(m.roughness)
    pdf_wh = microfacet_distribution(alpha, wh) * jnp.abs(cos_theta(wh))
    pdf = pdf_wh / (4.0 * la.v3_dot(wo, wh))
    return jnp.where(same_hemisphere(wo, wi), pdf, 0.0)


def _sample_beckmann_wh(state, wo, m: MaterialLanes):
    """Sample a halfway vector from Beckmann D (material.fut:283-296).
    Returns (state, wh, pdf_wh)."""
    state, (u0, u1) = prng.in_unit_square(state)
    log_sample = jnp.log(1.0 - u0)
    alpha = beckmann_alpha(m.roughness)
    t2 = -alpha * alpha * log_sample
    phi = u1 * 2.0 * math.pi
    ct = 1.0 / jnp.sqrt(1.0 + t2)
    st = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
    wh = la.v3(st * jnp.cos(phi), st * jnp.sin(phi), ct)
    wh = jnp.where(same_hemisphere(wo, wh), wh, -wh)
    pdf_wh = microfacet_distribution(alpha, wh) * jnp.abs(ct)
    bad = jnp.isinf(log_sample)
    return state, jnp.where(bad, 0.0, wh), jnp.where(bad, 0.0, pdf_wh)


def dielectric_reflection_sample(state, wo, m: MaterialLanes):
    """material.fut:305-315. Returns (state, wi, bsdf, pdf, kind)."""
    state, wh, pdf_wh = _sample_beckmann_wh(state, wo, m)
    wi = reflect(wo, wh)
    pdf = pdf_wh / (4.0 * la.v3_dot(wo, wh))
    kind = jnp.where(pdf_wh > 0, PDF_NONZERO, PDF_IMPOSSIBLE)
    ok = same_hemisphere(wo, wi)
    bsdf = jnp.where(ok, dielectric_reflection_bsdf(wo, wi, m), 0.0)
    kind = jnp.where(ok, kind, PDF_IMPOSSIBLE)
    wi = jnp.where(ok, wi, 0.0)
    return state, wi, bsdf, jnp.where(ok, pdf, 0.0), kind


# ---------------------------------------------------------------------------
# Composite dielectric / metal / uber evaluation (material.fut:317-361)

TRANSMISSION_BSDF = 0.0  # delta lobes evaluate to 0 (material.fut:144-162)
TRANSMISSION_PDF = 0.0


def dielectric_refraction_bsdf(m: MaterialLanes):
    return la.lerp(TRANSMISSION_BSDF, diffuse_bsdf(m), m.opacity)


def dielectric_refraction_pdf(wo, wi, m: MaterialLanes):
    return la.lerp(TRANSMISSION_PDF, diffuse_pdf(wo, wi), m.opacity)


def dielectric_bsdf(wo, wi, m: MaterialLanes):
    reflectance = jnp.where(cos_theta(wo) <= 0, 0.0,
                            fresnel_reflectance(wo, m))
    return la.lerp(dielectric_refraction_bsdf(m),
                   dielectric_reflection_bsdf(wo, wi, m),
                   reflectance)


def dielectric_pdf(wo, wi, m: MaterialLanes):
    refr = dielectric_refraction_pdf(wo, wi, m)
    refl = dielectric_reflection_pdf(wo, wi, m)
    blended = la.lerp(refr, refl, fresnel_reflectance(wo, m))
    return jnp.where(cos_theta(wo) <= 0, refr, blended)


def metal_bsdf(wo, wi, m: MaterialLanes):
    return m.color * dielectric_reflection_bsdf(wo, wi, m)


def metal_pdf(wo, wi, m: MaterialLanes):
    return dielectric_reflection_pdf(wo, wi, m)


def uber_bsdf(wo, wi, m: MaterialLanes):
    return la.lerp(dielectric_bsdf(wo, wi, m), metal_bsdf(wo, wi, m),
                   m.metalness)


def uber_pdf(wo, wi, m: MaterialLanes):
    # NOTE: argument order intentionally mirrors the reference's reversed
    # lerp (material.fut:360-361); see module docstring.
    return la.lerp(metal_pdf(wo, wi, m), dielectric_pdf(wo, wi, m),
                   m.metalness)


# ---------------------------------------------------------------------------
# Sampling (compute-all-lobes + select)

def uber_sample_dir(state, wo, m: MaterialLanes):
    """Sample an outgoing direction in local space (material.fut:365-370
    branch tree flattened). Returns (state, wi, bsdf, pdf, kind).

    Random-number usage differs from the reference (every lane draws the
    uniforms for every lobe so streams stay aligned across the SIMD batch);
    only distribution equivalence is preserved, per SURVEY.md section 7.
    """
    state, p_metal = prng.next_unit(state)
    state, p_fresnel = prng.next_unit(state)
    state, p_opacity = prng.next_unit(state)

    # Candidate 1: microfacet reflection (metal & dielectric-reflection).
    state, wi_r, bsdf_r, pdf_r, kind_r = dielectric_reflection_sample(
        state, wo, m)
    # Candidate 2: cosine diffuse.
    state, wi_d = cosine_sample_hemisphere(state)
    bsdf_d = diffuse_bsdf(m)
    pdf_d = cos_theta(wi_d) * la.INV_PI
    # Candidate 3: specular transmission / TIR.
    wi_t, bsdf_t = transmission_sample(wo, m)

    metal_branch = p_metal < m.metalness
    from_inside = cos_theta(wo) <= 0
    fresnel = fresnel_reflectance(wo, m)
    refl_branch = (~metal_branch) & (~from_inside) & (p_fresnel < fresnel)
    use_reflection = metal_branch | refl_branch
    diffuse_branch = (~use_reflection) & (p_opacity < m.opacity)

    bsdf_refl = jnp.where(metal_branch, m.color * bsdf_r, bsdf_r)

    wi = jnp.where(use_reflection, wi_r,
                   jnp.where(diffuse_branch, wi_d, wi_t))
    bsdf = jnp.where(use_reflection, bsdf_refl,
                     jnp.where(diffuse_branch, bsdf_d, bsdf_t))
    pdf = jnp.where(use_reflection, pdf_r,
                    jnp.where(diffuse_branch, pdf_d, 0.0))
    kind = jnp.where(use_reflection, kind_r,
                     jnp.where(diffuse_branch, PDF_NONZERO, PDF_DELTA))
    return state, wi, bsdf, pdf, kind


# ---------------------------------------------------------------------------
# World-space wrappers (material.fut:393-410)

def bsdf_f(wo_world, wi_world, normal, m: MaterialLanes):
    onb = make_onb(normal)
    return uber_bsdf(world_to_local(onb, wo_world),
                     world_to_local(onb, wi_world), m)


def bsdf_pdf(wo_world, wi_world, normal, m: MaterialLanes):
    onb = make_onb(normal)
    return uber_pdf(world_to_local(onb, wo_world),
                    world_to_local(onb, wi_world), m)


def sample_dir(state, wo_world, normal, m: MaterialLanes):
    """World-space BSDF importance sample. Returns
    (state, wi_world, bsdf, pdf, kind)."""
    onb = make_onb(normal)
    wo = world_to_local(onb, wo_world)
    state, wi, bsdf, pdf, kind = uber_sample_dir(state, wo, m)
    return state, local_to_world(onb, wi), bsdf, pdf, kind
