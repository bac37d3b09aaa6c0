"""Independent numpy transliteration of the reference estimator.

Parity evidence that shares NO code with the JAX/Pallas estimator in
`tracer_tpu/`: a direct, line-by-line reading of
the Futhark sources rendered in vectorized numpy, so a shared
misreading of integrator/direct/material semantics in the JAX code
cannot hide.  Transliterated from:

  - integrator.fut:27-76   path_trace (bounce loop, unit-weight RR,
                           emission at bounce 0, ambience on miss)
  - integrator.fut:78-103  sample_pixel (wavelength -> camera ray ->
                           path, incl. the rng-reuse quirks)
  - direct.fut:63-122      NEE + MIS (balance heuristic, both halves)
  - material.fut           uber-BSDF (all lobes, reversed-lerp pdf
                           quirk, dispersion hack, Beckmann alpha)
  - camera.fut:68-110      sensor-channel + probit wavelength sampling,
                           thin-lens ray
  - spectrum.fut:30-49     6-knot lookup with sentinel semantics
  - light.fut:19-31        diffuselight incident radiance
  - scene.fut:37-66        28-float material rows, emissive-tri lights
  - shapes.fut:41-46,66-86 acne offset, Moller triangle test
  - bvh.fut:25-43          the fake-BVH oracle (brute-force closest /
                           any hit; reduce tie keeps the LATER object)
  - rand.fut:5-46          minstd_rand draws (bitwise engine:
                           x' = 48271 x mod 2^31-1, the cpprandom /
                           C++ std::minstd_rand contract) and the
                           derived samplers
  - lib.fut:20-33          the visual_conf sensor constants

Deliberate deviation (documented, distribution-level only): cpprandom's
`split_rng`/`rng_from_seed` are not vendored in the reference tree, so
their bitwise stream-assignment cannot be recovered; per-(pixel, frame)
streams are instead seeded by a splitmix32 hash.  The engine itself and
every draw made FROM a stream are bitwise-faithful; stream assignment
only needs independence, which both constructions provide.  The
comparison against tracer_tpu is therefore statistical (per-pixel mean
within combined standard error), exactly as the two RNGs differ.

All math is float32, matching the Futhark `f32` estimator.
"""

from __future__ import annotations

import numpy as np

F = np.float32
PI = F(np.pi)
INV_PI = F(1.0 / np.pi)
PATH_LEN = 16

# ---------------------------------------------------------------------------
# rand.fut / cpprandom: minstd_rand engine + derived samplers.
# Engine: x' = 48271 * x mod (2^31 - 1); outputs in [1, 2^31-2]
# (C++ std::minstd_rand: min() = 1, max() = m - 2... max() = m - 1 - 0;
# for c == 0 the state never reaches 0, so outputs span [1, m-1]).

M31 = np.uint64(2147483647)          # 2^31 - 1 (prime modulus)
MINSTD_A = np.uint64(48271)


def rand(st):
    """One engine step: (state', output) with output = state'."""
    st = (MINSTD_A * st) % M31
    return st, st


def dist_rand(st, lo, hi):
    """cpprandom uniform_real_distribution.rand (lo, hi): map the
    engine output range [min, max] = [1, m-2+1] affinely onto
    [lo, hi]."""
    st, v = rand(st)
    u = (v.astype(np.float64) - 1.0) / float(M31 - np.uint64(2))
    return st, (F(lo) + F(hi - lo) * u.astype(F))


def random_unit_exclusive(st):
    """rand.fut:15-16 — [0, 0.9999)."""
    return dist_rand(st, 0.0, 0.9999)


def random_in_unit_square(st):
    st, x = random_unit_exclusive(st)
    st, y = random_unit_exclusive(st)
    return st, (x, y)


def random_in_unit_disk(st):
    """rand.fut:21-25: theta then radius^2 (NOT chained past theta in
    the reference either — it chains internally, theta draw then u)."""
    st, theta = dist_rand(st, 0.0, 2.0 * np.pi)
    st, u = random_unit_exclusive(st)
    r = np.sqrt(u)
    return st, np.stack([r * np.cos(theta), r * np.sin(theta),
                         np.zeros_like(r)], axis=-1).astype(F)


def random_in_triangle(st):
    """rand.fut:34-37 (PBR 13.6.5)."""
    st, (u, v) = random_in_unit_square(st)
    su = np.sqrt(u)
    return st, ((1.0 - su).astype(F), (v * su).astype(F))


def random_select_ix(st, n):
    """rand.fut:39-43: engine output modulo the element count."""
    st, v = rand(st)
    return st, (v % np.uint64(n)).astype(np.int64)


def splitmix32(x):
    """Stream seeding hash (the documented deviation — see module
    docstring). Standard splitmix32 mix on uint64 lanes."""
    x = (x + np.uint64(0x9E3779B9)) & np.uint64(0xFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(16))) * np.uint64(0x85EBCA6B)) \
        & np.uint64(0xFFFFFFFF)
    z = ((z ^ (z >> np.uint64(13))) * np.uint64(0xC2B2AE35)) \
        & np.uint64(0xFFFFFFFF)
    return z ^ (z >> np.uint64(16))


def stream_states(seed, frame, pixel_ix):
    """One independent minstd stream per (pixel, frame): a nonzero
    31-bit state from hashing (seed, frame, pixel)."""
    h = splitmix32(np.uint64(seed) * np.uint64(0x1000003)
                   + np.uint64(frame))
    st = splitmix32(pixel_ix.astype(np.uint64)
                    ^ (h * np.uint64(0x100000001)))
    st = st % (M31 - np.uint64(1)) + np.uint64(1)   # in [1, m-1]
    return st


# ---------------------------------------------------------------------------
# linalg.fut helpers (vectorized over (..., 3) arrays)

def dot(a, b):
    return np.sum(a * b, axis=-1)


def cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                    axis=-1)


def norm(a):
    return np.sqrt(dot(a, a))


def normalise(a):
    with np.errstate(invalid="ignore", divide="ignore"):
        return (a / norm(a)[..., None]).astype(F)


def lerp(a, b, r):
    """f32.lerp: (1-r)*a + r*b."""
    return ((1.0 - r) * a + r * b).astype(F)


def same_side(dominant, w):
    """linalg.fut:30-31: flip w to dominant's side (f32.sgn factor)."""
    return (np.sign(dot(dominant, w))[..., None] * w).astype(F)


# ---------------------------------------------------------------------------
# spectrum.fut:30-49 — 6-knot lookup with exact sentinel semantics

def spectrum_lookup(v, knots):
    """v (...,), knots (..., 6, 2) [(wavelen, intensity)]. Transliterates
    the sequential fold: track (w_below, x_below) init (-1, 0) and
    (w_above, x_above) init (inf, 0); knots with w > w_below and w <= v
    update below, knots with w < w_above and w > v update above."""
    w_below = np.full(np.shape(v), -1.0, F)
    x_below = np.zeros(np.shape(v), F)
    w_above = np.full(np.shape(v), np.inf, F)
    x_above = np.zeros(np.shape(v), F)
    for k in range(6):
        w = knots[..., k, 0]
        x = knots[..., k, 1]
        is_below = (w > w_below) & (w <= v)
        is_above = (w < w_above) & (w > v)
        w_below = np.where(is_below, w, w_below)
        x_below = np.where(is_below, x, x_below)
        w_above = np.where(is_above & ~is_below, w, w_above)
        x_above = np.where(is_above & ~is_below, x, x_above)
    none_below = w_below < 0
    none_above = np.isinf(w_above)
    with np.errstate(invalid="ignore", divide="ignore"):
        interp = lerp(x_below, x_above,
                      (v - w_below) / (w_above - w_below))
    out = np.where(none_below & none_above, F(0),
                   np.where(none_below, x_above,
                            np.where(none_above, x_below, interp)))
    return out.astype(F)


# ---------------------------------------------------------------------------
# scene.fut:37-53 — 28-float material rows

class Mats:
    """Column-major views of the material table (n_mats, 28)."""

    def __init__(self, rows):
        rows = np.asarray(rows, F)
        self.color = rows[:, 0:12].reshape(-1, 6, 2)
        self.roughness = rows[:, 12]
        self.metalness = rows[:, 13]
        self.ref_ix = rows[:, 14]
        self.opacity = rows[:, 15]
        self.emission = rows[:, 16:28].reshape(-1, 6, 2)


class MatAtWavelen:
    """material.fut:32-42 material_at_wavelen, gathered per lane."""

    def __init__(self, mats: Mats, mat_ix, wavelen):
        self.color = spectrum_lookup(wavelen, mats.color[mat_ix])
        self.roughness = mats.roughness[mat_ix]
        self.metalness = mats.metalness[mat_ix]
        # dispersion hack, material.fut:38-41
        self.ref_ix = (mats.ref_ix[mat_ix]
                       - (wavelen - F(589)) / F(10000)).astype(F)
        self.opacity = mats.opacity[mat_ix]


# ---------------------------------------------------------------------------
# shapes.fut — triangle test (RTR 22.16 variant), acne offset

ACNE_EPS = F(0.001)
TRI_EPS = F(0.00001)


def mkray_adjust_acne(hit_pos, hit_normal, wi):
    """shapes.fut:41-46."""
    off = ACNE_EPS * same_side(wi, hit_normal)
    return (hit_pos + off).astype(F), normalise(wi)


def hit_triangles(origin, direction, tmax, tri_a, tri_e1, tri_e2, tri_n):
    """All-pairs Moller test: origin/direction (L, 3), triangles (T, ...).
    Returns (valid (L,T), t (L,T), normal is tri_n). shapes.fut:66-86."""
    a = -(direction @ tri_n.T)                       # (L, T)
    s = origin[:, None, :] - tri_a[None, :, :]       # (L, T, 3)
    m = cross(s, direction[:, None, :])
    with np.errstate(invalid="ignore", divide="ignore"):
        inv_a = F(1.0) / a
        t = np.einsum("ltk,tk->lt", s, tri_n) * inv_a
        u = np.einsum("ltk,tk->lt", m, tri_e2) * inv_a
        v = -np.einsum("ltk,tk->lt", m, tri_e1) * inv_a
    nondeg = np.abs(a) >= TRI_EPS                    # !(approx_zero a eps)
    in_tri = (u >= 0) & (v >= 0) & (u + v <= 1)
    in_bounds = (t < tmax) & (t > 0)                 # shapes.fut:64
    return (nondeg & in_tri & in_bounds), t.astype(F)


def hit_one_triangle(origin, direction, tmax, a3, b3, c3):
    """hit_triangle against ONE (possibly per-lane) triangle; a3/b3/c3
    (L, 3) or (3,). Returns (valid, t, pos)."""
    e1 = (b3 - a3).astype(F)
    e2 = (c3 - a3).astype(F)
    n = cross(e1, e2)
    a = -dot(n, direction)
    s = (origin - a3).astype(F)
    m = cross(s, direction)
    with np.errstate(invalid="ignore", divide="ignore"):
        inv_a = F(1.0) / a
        t = dot(n, s) * inv_a
        u = dot(m, e2) * inv_a
        v = -dot(m, e1) * inv_a
    valid = ((np.abs(a) >= TRI_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1)
             & (t < tmax) & (t > 0))
    pos = (origin + t[..., None] * direction).astype(F)
    return valid, t.astype(F), pos


class Tris:
    """Precomputed per-triangle data for the brute-force oracle."""

    def __init__(self, tris, mat_ix):
        tris = np.asarray(tris, F)        # (T, 3, 3)
        self.a = tris[:, 0]
        self.b = tris[:, 1]
        self.c = tris[:, 2]
        self.e1 = self.b - self.a
        self.e2 = self.c - self.a
        self.n = cross(self.e1, self.e2)  # unnormalized geometric normal
        self.n_unit = normalise(self.n)
        self.mat_ix = np.asarray(mat_ix, np.int64)
        self.count = tris.shape[0]


def closest_hit(origin, direction, tmax, tris: Tris):
    """bvh.fut:31-39 fake-BVH closest: reduce select_min_hit keeps the
    LATER element on an exact t tie (`if ah.t < bh.t then a else b`)."""
    valid, t = hit_triangles(origin, direction, tmax,
                             tris.a, tris.e1, tris.e2, tris.n)
    tv = np.where(valid, t, np.inf)
    # argmin with ties to the LARGEST index: reverse, argmin, unreverse
    ix = tris.count - 1 - np.argmin(tv[:, ::-1], axis=1)
    lane = np.arange(origin.shape[0])
    best_t = tv[lane, ix]
    hit = np.isfinite(best_t)
    pos = (origin + best_t[:, None] * direction).astype(F)
    normal = tris.n_unit[ix]
    return hit, best_t.astype(F), pos, normal, tris.mat_ix[ix]


def any_hit(origin, direction, tmax, tris: Tris):
    """bvh.fut:41-42: any t in (0, tmax)."""
    valid, _ = hit_triangles(origin, direction,
                             np.asarray(tmax, F)[:, None],
                             tris.a, tris.e1, tris.e2, tris.n)
    return valid.any(axis=1)


# ---------------------------------------------------------------------------
# material.fut — local-frame uber BSDF

def mk_onb(normal):
    """material.fut:374-380 mk_orthonormal_basis."""
    ax = np.abs(normal[..., 0]) > np.abs(normal[..., 2])
    binormal = np.where(
        ax[..., None],
        np.stack([-normal[..., 1], normal[..., 0],
                  np.zeros_like(normal[..., 0])], axis=-1),
        np.stack([np.zeros_like(normal[..., 0]), -normal[..., 2],
                  normal[..., 1]], axis=-1))
    binormal = normalise(binormal)
    tangent = cross(binormal, normal)
    return tangent, binormal, normal


def world_to_local(onb, w):
    t, b, n = onb
    return np.stack([dot(w, t), dot(w, b), dot(w, n)], axis=-1).astype(F)


def local_to_world(onb, w):
    t, b, n = onb
    return (w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n).astype(F)


def cos_theta(w):
    return w[..., 2]


def sin2_theta(w):
    return np.maximum(F(0), 1 - cos_theta(w) ** 2)


def tan2_theta(w):
    with np.errstate(invalid="ignore", divide="ignore"):
        return sin2_theta(w) / (cos_theta(w) ** 2)


def tan_theta(w):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.sqrt(sin2_theta(w)) / cos_theta(w)


def same_hemisphere(w, u):
    return cos_theta(w) * cos_theta(u) > 0


def reflect(w, n):
    return (-w + 2 * dot(w, n)[..., None] * n).astype(F)


def beckmann_alpha(roughness):
    return (F(1.62142) * np.maximum(F(0.004), roughness)).astype(F)


def microfacet_distribution(alpha, wh):
    """Beckmann D, material.fut:218-223."""
    t2 = tan2_theta(wh)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        d = (np.exp(-t2 / (alpha * alpha))
             / (PI * alpha * alpha * cos_theta(wh) ** 4))
    return np.where(np.isinf(t2) | ~np.isfinite(d), F(0), d).astype(F)


def self_shadowing_factor(alpha, wo, wi):
    """Beckmann G approx, material.fut:229-239."""
    def lam(w):
        att = np.abs(tan_theta(w))
        with np.errstate(invalid="ignore", divide="ignore"):
            a = 1.0 / (alpha * att)
            val = np.where(a >= 1.6, F(0),
                           (1 - 1.259 * a + 0.396 * a * a)
                           / (3.535 * a + 2.181 * a * a))
        return np.where(np.isinf(att) | np.isnan(att), F(0), val)
    return (1.0 / (1.0 + lam(wo) + lam(wi))).astype(F)


def microfacet_factor(wo, wi, m):
    wh = normalise(wo + wi)
    alpha = beckmann_alpha(m.roughness)
    return (microfacet_distribution(alpha, wh)
            * self_shadowing_factor(alpha, wo, wi)).astype(F)


def fresnel_reflectance(wo, m):
    """Schlick, material.fut:207-211."""
    r0 = ((1 - m.ref_ix) / (1 + m.ref_ix)) ** 2
    return (r0 + (1 - r0) * (1 - cos_theta(wo)) ** 5).astype(F)


def diffuse_bsdf(m):
    return (m.color * INV_PI).astype(F)


def diffuse_pdf(wo, wi):
    return np.where(same_hemisphere(wo, wi),
                    cos_theta(wi) * INV_PI, F(0)).astype(F)


def dielectric_reflection_bsdf(wo, wi, m):
    with np.errstate(invalid="ignore", divide="ignore"):
        v = microfacet_factor(wo, wi, m) / (4 * cos_theta(wo)
                                            * cos_theta(wi))
    return v.astype(F)


def dielectric_reflection_pdf(wo, wi, m):
    wh = normalise(wo + wi)
    alpha = beckmann_alpha(m.roughness)
    wh_pdf = microfacet_distribution(alpha, wh) * np.abs(cos_theta(wh))
    with np.errstate(invalid="ignore", divide="ignore"):
        pdf = wh_pdf / (4 * dot(wo, wh))
    return np.where(same_hemisphere(wo, wi), pdf, F(0)).astype(F)


def dielectric_refraction_bsdf(m):
    # lerp(transmission_bsdf = 0, diffuse, opacity)
    return lerp(F(0), diffuse_bsdf(m), m.opacity)


def dielectric_refraction_pdf(wo, wi, m):
    return lerp(F(0), diffuse_pdf(wo, wi), m.opacity)


def dielectric_bsdf(wo, wi, m):
    refl = np.where(cos_theta(wo) <= 0, F(0), fresnel_reflectance(wo, m))
    return lerp(dielectric_refraction_bsdf(m),
                dielectric_reflection_bsdf(wo, wi, m), refl)


def dielectric_pdf(wo, wi, m):
    inside = cos_theta(wo) <= 0
    outside_pdf = lerp(dielectric_refraction_pdf(wo, wi, m),
                       dielectric_reflection_pdf(wo, wi, m),
                       fresnel_reflectance(wo, m))
    return np.where(inside, dielectric_refraction_pdf(wo, wi, m),
                    outside_pdf).astype(F)


def metal_bsdf(wo, wi, m):
    return (m.color * dielectric_reflection_bsdf(wo, wi, m)).astype(F)


def uber_bsdf(wo, wi, m):
    return lerp(dielectric_bsdf(wo, wi, m), metal_bsdf(wo, wi, m),
                m.metalness)


def uber_pdf(wo, wi, m):
    """material.fut:360-361 — NOTE the reversed lerp order vs uber_bsdf
    (metal first): the preserved reference quirk."""
    return lerp(dielectric_reflection_pdf(wo, wi, m),  # metal_pdf
                dielectric_pdf(wo, wi, m), m.metalness)


def bsdf_f(wo, wi, normal, m):
    onb = mk_onb(normal)
    return uber_bsdf(world_to_local(onb, wo), world_to_local(onb, wi), m)


def bsdf_pdf(wo, wi, normal, m):
    onb = mk_onb(normal)
    return uber_pdf(world_to_local(onb, wo), world_to_local(onb, wi), m)


# --- sampling (per-lane branch simulation: every branch is evaluated
# from the same entry state, then state AND outputs are selected
# per-lane, preserving exact per-lane draw sequences) ---

PDF_IMPOSSIBLE, PDF_DELTA, PDF_NONZERO = 0, 1, 2


class DirSample:
    def __init__(self, wi, bsdf, kind, val):
        self.wi, self.bsdf, self.kind, self.val = wi, bsdf, kind, val

    @staticmethod
    def select(cond, a, b):
        c = cond[..., None]
        return DirSample(np.where(c, a.wi, b.wi).astype(F),
                         np.where(cond, a.bsdf, b.bsdf).astype(F),
                         np.where(cond, a.kind, b.kind),
                         np.where(cond, a.val, b.val).astype(F))


def cosine_sample_hemisphere(st):
    """Malley's method, material.fut:106-112."""
    st, d = random_in_unit_disk(st)
    sin2 = d[..., 0] ** 2 + d[..., 1] ** 2
    z = np.sqrt(np.maximum(F(0), 1 - sin2))
    wi = np.stack([d[..., 0], d[..., 1], z], axis=-1).astype(F)
    return st, wi


def diffuse_sample_dir(st, m):
    st, wi = cosine_sample_hemisphere(st)
    return st, DirSample(wi, diffuse_bsdf(m),
                         np.full(wi.shape[:-1], PDF_NONZERO),
                         (cos_theta(wi) * INV_PI).astype(F))


def transmission_sample_dir(wo, m):
    """material.fut:166-183 (no draws)."""
    entering = cos_theta(wo) > 0
    nloc = np.zeros_like(wo)
    nloc[..., 2] = np.where(entering, 1.0, -1.0)
    eta = np.where(entering, 1.0 / m.ref_ix, m.ref_ix).astype(F)
    cos_i = dot(nloc, wo)
    sin2_i = np.maximum(F(0), 1 - cos_i * cos_i)
    sin2_t = eta * eta * sin2_i
    tir = sin2_t >= 1
    cos_t = np.sqrt(np.maximum(F(0), 1 - sin2_t))
    wt = (-eta[..., None] * wo
          + (eta * cos_i - cos_t)[..., None] * nloc).astype(F)
    wr = reflect(wo, nloc)
    wi = np.where(tir[..., None], wr, wt).astype(F)
    with np.errstate(invalid="ignore", divide="ignore"):
        b = (1.0 / np.abs(cos_theta(wi))).astype(F)
    return DirSample(wi, b, np.full(wi.shape[:-1], PDF_DELTA),
                     np.zeros(wi.shape[:-1], F))


def dielectric_reflection_sample_dir(st, wo, m):
    """material.fut:283-313 (sample_wh then reflect)."""
    st, (u0, u1) = random_in_unit_square(st)
    with np.errstate(divide="ignore"):
        log_sample = np.log(1 - u0).astype(F)
    degenerate = np.isinf(log_sample)
    alpha = beckmann_alpha(m.roughness)
    t2 = -alpha * alpha * log_sample
    phi = u1 * 2 * PI
    ct = (1.0 / np.sqrt(1 + t2)).astype(F)
    stheta = np.sqrt(np.maximum(F(0), 1 - ct * ct))
    wh = np.stack([stheta * np.cos(phi), stheta * np.sin(phi), ct],
                  axis=-1).astype(F)
    flip = ~same_hemisphere(wo, wh)
    wh = np.where(flip[..., None], -wh, wh)
    pdf_wh = microfacet_distribution(alpha, wh) * np.abs(ct)
    wh = np.where(degenerate[..., None], F(0), wh)
    pdf_wh = np.where(degenerate, F(0), pdf_wh).astype(F)
    wi = reflect(wo, wh)
    with np.errstate(invalid="ignore", divide="ignore"):
        pdf_val = (pdf_wh / (4 * dot(wo, wh))).astype(F)
    kind = np.where(pdf_wh > 0, PDF_NONZERO, PDF_IMPOSSIBLE)
    smp = DirSample(wi, dielectric_reflection_bsdf(wo, wi, m), kind,
                    pdf_val)
    # null_sample when wi crosses the hemisphere (material.fut:310-313)
    null = ~same_hemisphere(wo, wi)
    zero = DirSample(np.zeros_like(wi), np.zeros(wi.shape[:-1], F),
                     np.full(wi.shape[:-1], PDF_IMPOSSIBLE),
                     np.zeros(wi.shape[:-1], F))
    return st, DirSample.select(null, zero, smp)


def dielectric_refraction_sample_dir(st, wo, m):
    """material.fut:196-202: p < opacity -> diffuse, else transmission."""
    st2, p = random_unit_exclusive(st)
    st_d, smp_d = diffuse_sample_dir(st2, m)
    smp_t = transmission_sample_dir(wo, m)
    take_diffuse = p < m.opacity
    st_out = np.where(take_diffuse, st_d, st2)
    return st_out, DirSample.select(take_diffuse, smp_d, smp_t)


def dielectric_sample_dir(st, wo, m):
    """material.fut:336-344."""
    inside = cos_theta(wo) <= 0
    st_in, smp_in = dielectric_refraction_sample_dir(st, wo, m)
    st2, p = random_unit_exclusive(st)
    st_r, smp_r = dielectric_reflection_sample_dir(st2, wo, m)
    st_f, smp_f = dielectric_refraction_sample_dir(st2, wo, m)
    take_refl = p < fresnel_reflectance(wo, m)
    st_out = np.where(take_refl, st_r, st_f)
    smp_out = DirSample.select(take_refl, smp_r, smp_f)
    st_fin = np.where(inside, st_in, st_out)
    return st_fin, DirSample.select(inside, smp_in, smp_out)


def metal_sample_dir(st, wo, m):
    st, smp = dielectric_reflection_sample_dir(st, wo, m)
    return st, DirSample(smp.wi, (m.color * smp.bsdf).astype(F),
                         smp.kind, smp.val)


def uber_sample_dir(st, wo, m):
    """material.fut:365-370."""
    st, p = random_unit_exclusive(st)
    st_m, smp_m = metal_sample_dir(st, wo, m)
    st_d, smp_d = dielectric_sample_dir(st, wo, m)
    take_metal = p < m.metalness
    return (np.where(take_metal, st_m, st_d),
            DirSample.select(take_metal, smp_m, smp_d))


def sample_dir(st, wo, normal, m):
    """material.fut:404-410: to local frame, sample, back to world."""
    onb = mk_onb(normal)
    st, smp = uber_sample_dir(st, world_to_local(onb, wo), m)
    return st, DirSample(local_to_world(onb, smp.wi), smp.bsdf,
                         smp.kind, smp.val)


# ---------------------------------------------------------------------------
# light.fut / scene.fut — diffuse area lights from emissive triangles

class Lights:
    """Per-light triangle + emission knots, in obj order
    (scene.fut:58-66 get_lights)."""

    def __init__(self, tris, mat_ix, mats: Mats):
        em = mats.emission[np.asarray(mat_ix, np.int64)]   # (T, 6, 2)
        is_light = ((em[:, :, 0] >= 0) & (em[:, :, 1] > 0)).any(axis=1)
        sel = np.nonzero(is_light)[0]
        t = np.asarray(tris, F)[sel]
        self.a, self.b, self.c = t[:, 0], t[:, 1], t[:, 2]
        self.emission = em[sel]
        e1 = self.b - self.a
        e2 = self.c - self.a
        n = cross(e1, e2)
        self.normal = normalise(n)
        self.area = (norm(n) / 2).astype(F)
        self.count = len(sel)


def diffuselight_incident_radiance(lights, li, hitp, lightp, wavelen):
    """light.fut:19-31."""
    v = lightp - hitp
    d2 = dot(v, v)
    wi = normalise(v)
    lnormal = lights.normal[li]
    cos_l = dot(-wi, lnormal)
    em = spectrum_lookup(wavelen, lights.emission[li])
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.maximum(F(0), em * cos_l / d2).astype(F)


def occluded(hit_pos, hit_normal, lightp, tris: Tris):
    """direct.fut:7-15."""
    v = lightp - hit_pos
    w = normalise(v)
    distance = norm(v)
    o, d = mkray_adjust_acne(hit_pos, hit_normal, w)
    backface = dot(w, hit_normal) <= 0
    return backface | any_hit(o, d, (distance - F(0.01)).astype(F), tris)


# Test-only hook mirroring engine/direct.py MIS_HALF_SCALE (parity
# bisection of the two MIS halves); (1, 1) is the identity.
MIS_HALF_SCALE = (1.0, 1.0)


def balance(pdf_f, pdf_g):
    """direct.fut:58-60 with nf = ng = 1."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return (pdf_f / (pdf_f + pdf_g)).astype(F)


def estimate_direct(st, wo, hit_pos, hit_normal, m, wavelen,
                    lights: Lights, li, tris: Tris):
    """direct.fut:63-122 for one (per-lane) diffuse arealight.

    Transliterated quirk: sample_arealight (direct.fut:32-42) draws
    (u, v) but RETURNS THE INCOMING rng (`let (_rng, ...) = ...`), so
    the BSDF-MIS half's sample_dir re-reads the same engine outputs."""
    # --- light half ---
    _, (u, v) = random_in_triangle(st)       # rng deliberately discarded
    e1 = lights.b[li] - lights.a[li]
    e2 = lights.c[li] - lights.a[li]
    p = (lights.a[li] + u[..., None] * e1 + v[..., None] * e2).astype(F)
    wi_l = normalise(p - hit_pos)
    in_rad = diffuselight_incident_radiance(lights, li, hit_pos, p,
                                            wavelen)
    with np.errstate(invalid="ignore", divide="ignore"):
        light_pdf_s = (F(1.0) / lights.area[li]).astype(F)
    occ = occluded(hit_pos, hit_normal, p, tris)
    in_rad = np.where(occ, F(0), in_rad)
    f_l = (bsdf_f(wo, wi_l, hit_normal, m)
           * np.abs(dot(wi_l, hit_normal))).astype(F)
    scat_pdf = bsdf_pdf(wo, wi_l, hit_normal, m)
    w_l = balance(light_pdf_s, scat_pdf)
    with np.errstate(invalid="ignore", divide="ignore"):
        light_rad = (f_l * w_l * in_rad / light_pdf_s).astype(F)
    light_rad = np.where((light_pdf_s == 0) | (in_rad == 0), F(0),
                         light_rad)
    light_rad = np.where(np.isfinite(light_rad), light_rad, F(0))

    # --- bsdf half (arealight case) ---
    st, smp = sample_dir(st, wo, hit_normal, m)
    o2, d2 = mkray_adjust_acne(hit_pos, hit_normal, smp.wi)
    lv, lt, lpos = hit_one_triangle(o2, d2, F(np.finfo(np.float32).max),
                                    lights.a[li], lights.b[li],
                                    lights.c[li])
    occ2 = occluded(hit_pos, hit_normal, lpos, tris)
    in_rad2 = diffuselight_incident_radiance(lights, li, hit_pos, lpos,
                                             wavelen)
    f_b = (smp.bsdf * np.abs(dot(smp.wi, hit_normal))).astype(F)
    light_pdf_b = (F(1.0) / lights.area[li]).astype(F)
    w_b = balance(smp.val, light_pdf_b)
    with np.errstate(invalid="ignore", divide="ignore"):
        nonzero_contrib = (f_b * in_rad2 * w_b / smp.val).astype(F)
    contrib = np.where(
        smp.kind == PDF_DELTA, f_b * in_rad2,
        np.where(smp.kind == PDF_NONZERO, nonzero_contrib, F(0)))
    bsdf_rad = np.where(lv & ~occ2, contrib, F(0)).astype(F)
    bsdf_rad = np.where(np.isfinite(bsdf_rad), bsdf_rad, F(0))
    return st, (F(MIS_HALF_SCALE[0]) * light_rad
                + F(MIS_HALF_SCALE[1]) * bsdf_rad).astype(F)


def direct_radiance(st, wo, hit_pos, hit_normal, m, wavelen,
                    lights: Lights, tris: Tris):
    """direct.fut:110-122: select one light uniformly, divide by its
    probability."""
    if lights.count == 0:
        return st, np.zeros(hit_pos.shape[:-1], F)
    st, li = random_select_ix(st, lights.count)
    st, rad = estimate_direct(st, wo, hit_pos, hit_normal, m, wavelen,
                              lights, li, tris)
    return st, (rad * F(lights.count)).astype(F)


# ---------------------------------------------------------------------------
# camera.fut — visual_conf, wavelength + thin-lens ray sampling

# lib.fut:20-28 visual_conf sensor (mu, sigma) + channel colors
SENSOR_MU = np.array([455.0, 535.0, 610.0], F)
SENSOR_SIGMA = np.array([22.0, 32.0, 26.0], F)
SENSOR_COLOR = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], F)
FOV_DEG = F(80.0)
OFFSET_RADIUS = F(1.0)
APERTURE = F(0.0)
FOCAL_DIST = F(1.0)


def probit(p):
    """Inverse normal CDF (Acklam's rational approximation, ~1.15e-9
    relative error) — the statistics package's quantile sampler
    (camera.fut:76-79) without sharing its code."""
    p = np.asarray(p, np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    q = np.sqrt(-2 * np.log(np.clip(p, 1e-300, None)))
    lo = ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
           + c[5])
          / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    qh = np.sqrt(-2 * np.log(np.clip(1 - p, 1e-300, None)))
    hi = -((((((c[0] * qh + c[1]) * qh + c[2]) * qh + c[3]) * qh + c[4])
            * qh + c[5])
           / ((((d[0] * qh + d[1]) * qh + d[2]) * qh + d[3]) * qh + 1))
    r = p - 0.5
    s = r * r
    mid = ((((((a[0] * s + a[1]) * s + a[2]) * s + a[3]) * s + a[4]) * s
            + a[5]) * r
           / (((((b[0] * s + b[1]) * s + b[2]) * s + b[3]) * s + b[4]) * s
              + 1))
    return np.where(p < plow, lo, np.where(p > phigh, hi, mid)).astype(F)


def sample_camera_wavelength(st):
    """camera.fut:68-79: uniform channel pick, then probit sampling of
    that channel's normal distribution."""
    st, ch = random_select_ix(st, 3)
    st, p = random_unit_exclusive(st)
    wl = (SENSOR_MU[ch] + SENSOR_SIGMA[ch] * probit(p)).astype(F)
    return st, wl, ch


def sample_camera_ray(st, origin, w, h, j, i):
    """camera.fut:81-110 with pitch = yaw = 0: cam_dir = (0,0,-1),
    right = (1,0,0), up = (0,1,0). Returns (ray_o, ray_d); does NOT
    advance st (the reference's `let (_rng, ...)` reuse quirk — jitter
    and lens-disk draws both read from the same incoming rng)."""
    _, (ox, oy) = random_in_unit_square(st)
    x = ((j + OFFSET_RADIUS * ox) / F(w)).astype(F)
    # ji.y is already flipped by the caller (integrator.fut:87)
    y = ((i + OFFSET_RADIUS * oy) / F(h)).astype(F)
    ratio = F(w) / F(h)
    half_h = F(np.tan(np.deg2rad(FOV_DEG) / 2))
    half_w = ratio * half_h
    u = np.array([1, 0, 0], F)
    v = np.array([0, 1, 0], F)
    wv = np.array([0, 0, 1], F)            # -cam_dir
    lower_left = (origin - half_w * FOCAL_DIST * u
                  - half_h * FOCAL_DIST * v - FOCAL_DIST * wv)
    _, dsk = random_in_unit_disk(st)        # same st: the reuse quirk
    lens = (APERTURE / 2) * dsk
    lens_off = lens[..., 0:1] * u + lens[..., 1:2] * v
    o = (origin + lens_off).astype(F)
    d = (lower_left
         + (x * 2 * half_w * FOCAL_DIST)[..., None] * u
         + (y * 2 * half_h * FOCAL_DIST)[..., None] * v
         - o)
    return o, normalise(d)


# ---------------------------------------------------------------------------
# integrator.fut:27-76 — path_trace, vectorized over lanes

def path_trace(st, ray_o, ray_d, wavelen, tris: Tris, mats: Mats,
               lights: Lights, ambience_value=F(0.0)):
    """Returns the per-lane sum of per-bounce radiance (the color-mode
    reduction of the reference's 16-entry path; ambience = no_sky -> 0
    on miss unless overridden). Unit-weight Russian roulette, emission
    only at bounce 0, direct light via NEE+MIS at every bounce."""
    L = ray_o.shape[0]
    alive = np.ones(L, bool)
    total = np.zeros(L, F)
    fmax = F(np.finfo(np.float32).max)
    for bounce in range(PATH_LEN):
        if not alive.any():
            break
        hit, t, pos, normal, mix = closest_hit(ray_o, ray_d, fmax, tris)
        miss = alive & ~hit
        # miss: radiance = ambience (spectrum_lookup of no_sky = 0)
        total = np.where(miss, total + ambience_value, total)
        act = alive & hit
        # rng = advance_rng rng (one draw; only surviving lanes)
        st_adv, _ = random_unit_exclusive(st)
        st = np.where(act, st_adv, st)
        m = MatAtWavelen(mats, mix, wavelen)
        wo = -ray_d
        st_d, direct = direct_radiance(st, wo, pos, normal, m, wavelen,
                                       lights, tris)
        st = np.where(act, st_d, st)
        emis = spectrum_lookup(wavelen, mats.emission[mix])
        rad = direct + (emis if bounce == 0 else F(0))
        total = np.where(act, total + rad, total)
        # continuation sampling
        st_s, smp = sample_dir(st, wo, normal, m)
        st = np.where(act, st_s, st)
        pdf = np.where(smp.kind == PDF_DELTA, F(1),
                       np.where(smp.kind == PDF_NONZERO, smp.val,
                                F(0))).astype(F)
        cos_fall = np.abs(dot(normal, smp.wi))
        with np.errstate(invalid="ignore", divide="ignore"):
            p_term = (1 - smp.bsdf * cos_fall / pdf).astype(F)
        st_t, q = random_unit_exclusive(st)
        st = np.where(act, st_t, st)
        terminate = (pdf == 0) | (q < p_term) | ~np.isfinite(p_term)
        alive = act & ~terminate
        o2, d2 = mkray_adjust_acne(pos, normal, smp.wi)
        ray_o = np.where(alive[:, None], o2, ray_o)
        ray_d = np.where(alive[:, None], d2, ray_d)
    return st, total


def render(seed, w, h, spp, tris, tri_mats, mat_rows,
           cam_origin=(0.0, 0.8, 1.8), frame_chunk=16):
    """Full color-mode render of the reference estimator: returns
    (mean_img (h, w, 3), var_img (h, w, 3), spp). var_img is the
    per-pixel per-channel sample variance of the per-frame values
    (for standard-error computation in statistical comparisons)."""
    trs = Tris(tris, tri_mats)
    mats = Mats(mat_rows)
    lights = Lights(tris, tri_mats, mats)
    origin = np.asarray(cam_origin, F)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    j = jj.ravel().astype(F)
    i_flip = (F(h) - ii.ravel().astype(F) - F(1.0))   # integrator.fut:87
    pixel_ix = (ii.ravel() * w + jj.ravel()).astype(np.uint64)
    npix = w * h
    sum_img = np.zeros((npix, 3), np.float64)
    sumsq_img = np.zeros((npix, 3), np.float64)
    for f0 in range(0, spp, frame_chunk):
        fc = min(frame_chunk, spp - f0)
        # lanes = pixels x frames-in-chunk
        st = np.concatenate([stream_states(seed, f0 + k, pixel_ix)
                             for k in range(fc)])
        jL = np.tile(j, fc)
        iL = np.tile(i_flip, fc)
        st, wl, ch = sample_camera_wavelength(st)
        o, d = sample_camera_ray(st, origin, w, h, jL, iL)
        st, total = path_trace(st, o, d, wl, trs, mats, lights)
        # visualize (integrator.fut:165-170): x n_channels, channel color
        vals = (F(3.0) * total)[:, None] * SENSOR_COLOR[ch]
        vals = vals.reshape(fc, npix, 3).astype(np.float64)
        sum_img += vals.sum(axis=0)
        sumsq_img += (vals * vals).sum(axis=0)
    mean = sum_img / spp
    var = (sumsq_img - sum_img ** 2 / spp) / max(spp - 1, 1)
    return (mean.reshape(h, w, 3), var.reshape(h, w, 3), spp)


if __name__ == "__main__":
    import argparse
    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="ref_numpy.npz")
    ap.add_argument("--obj", default=os.path.join(
        os.environ.get("TRACER_ASSETS", "/root/reference/assets"),
        "CornellBox-Original.obj"))
    args = ap.parse_args()
    # input parsing is shared with the package deliberately: the loader
    # is validated separately (tests/test_loader.py, python == C++);
    # the ESTIMATOR shares nothing.
    from tracer_tpu.utils.objloader import load_obj
    tris, tm, mats = load_obj(args.obj)
    import time
    t0 = time.time()
    mean, var, n = render(args.seed, args.size, args.size, args.spp,
                          tris, tm, mats)
    print(f"rendered {args.size}x{args.size}x{args.spp}spp in "
          f"{time.time() - t0:.1f}s  img_mean={mean.mean():.5f}")
    np.savez(args.out, mean=mean, var=var, spp=n)
    print(f"wrote {args.out}")
