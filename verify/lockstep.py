"""Lane-locked differential test: the TRACER's exact per-frame
estimator (streams, draw order, branch discipline) re-expressed in
numpy on top of the ORACLE's formula implementations
(verify/ref_estimator_numpy.py).

Both sides consume IDENTICAL PCG streams (ops/rng.py constants), so a
frame renders lane-for-lane, bounce-for-bounce equal up to f32 noise.
Any difference beyond ~1e-3 relative is a real semantic divergence
between tracer_tpu's estimator composition and the reference formulas
— localized to (lane, bounce) deterministically, no statistics needed.

This is the terminal instrument of the round-4 mirrorbox bisection
(docs/PARITY.md "mirrorbox investigation"): every component-level A/B
(formulas, spectrum, occlusion, rng statistics, wavelength sampling)
matched, every distributional mechanism measured small, yet full
renders diverge +4% on green. Lockstep removes the Monte-Carlo noise
floor entirely.

Usage:  python verify/lockstep.py [--size 32] [--frames 4]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# a CPU tool: pin the platform before JAX starts
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

import verify.ref_estimator_numpy as R  # noqa: E402

F = np.float32
U64 = np.uint64
M32 = U64(0xFFFFFFFF)
MULT, INC = U64(747796405), U64(2891336453)
UNIT_SCALE = F(0.9999)
ASSETS = os.environ.get("TRACER_ASSETS", "/root/reference/assets")

PDF_IMPOSSIBLE, PDF_DELTA, PDF_NONZERO = 0, 1, 2


# ---------------------------------------------------------------------------
# ops/rng.py ported to numpy (exact same constants and mappings)

def _permute(st):
    word = (((st >> ((st >> U64(28)) + U64(4))) ^ st) * U64(277803737)) & M32
    return (word >> U64(22)) ^ word


def hash_u32(x):
    return _permute((np.asarray(x, U64) * MULT + INC) & M32)


def make_streams(seed, frame, lane_ids):
    base = hash_u32(U64(seed) ^ hash_u32(U64(frame)))
    return hash_u32(lane_ids.astype(U64) ^ base)


def next_u32(st):
    st = (st * MULT + INC) & M32
    return st, _permute(st)


def next_unit(st):
    st, bits = next_u32(st)
    u = (bits >> U64(8)).astype(F) * F(0.9999 / (1 << 24))
    return st, u


def next_uniform(st, lo, hi):
    st, bits = next_u32(st)
    u = (bits >> U64(8)).astype(F) * F(1.0 / (1 << 24))
    return st, (F(lo) + u * F(hi - lo)).astype(F)


def select(st, n):
    st, bits = next_u32(st)
    return st, (bits % U64(n)).astype(np.int64)


def in_unit_square(st):
    st, x = next_unit(st)
    st, y = next_unit(st)
    return st, (x, y)


def in_unit_disk_xy(st):
    st, theta = next_uniform(st, 0.0, 2.0 * np.pi)
    st, u = next_unit(st)
    r = np.sqrt(u)
    return st, (r * np.cos(theta).astype(F), r * np.sin(theta).astype(F))


def in_triangle(st):
    st, (u, v) = in_unit_square(st)
    su = np.sqrt(u)
    return st, ((1.0 - su).astype(F), (v * su).astype(F))


# ---------------------------------------------------------------------------
# models/camera.py sample_wavelength + sample_ray (tracer discipline)

_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key0, key1, x0, x1):
    """numpy mirror of ops/rng.py threefry2x32 (validated bit-exact
    against jax._src.prng.threefry_2x32)."""
    k0, k1 = U64(key0) & M32, U64(key1) & M32
    k2 = k0 ^ k1 ^ U64(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0 = (np.asarray(x0, U64) + k0) & M32
    x1 = (np.asarray(x1, U64) + k1) & M32
    for i in range(5):
        for r in _TF_ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << U64(r)) | (x1 >> U64(32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + U64(i + 1)) & M32
    return x0, x1


_SALT_WAVELENGTH = U64(0x3C6EF372)


def sample_wavelength(st):
    """Mirror of the FIXED production models/camera.py: channel/probit
    from one threefry block over the pre-advance state; chain advances
    twice."""
    st0 = st
    b0, b1 = threefry2x32(_SALT_WAVELENGTH, 0x9E3779B9, st0, 0x85EBCA6B)
    st, _ = next_u32(st)
    st, _ = next_u32(st)
    ch = (b0 % U64(3)).astype(np.int64)
    p = (b1 >> U64(8)).astype(F) * F(0.9999 / (1 << 24))
    if _CHDECOR["gen"] is not None:
        g = _CHDECOR["gen"]
        ch = np.asarray(g.integers(0, 3, size=ch.shape), np.int64)
        p = (g.random(p.shape) * 0.9999).astype(F)
    elif _SALT_MODE["on"]:
        # salted double-round hashes of the PRE-advance state; main
        # stream advance above is kept so all other draws are unchanged
        ch = (hash_u32(hash_u32(st0 ^ _SALT_CH)) % U64(3)).astype(
            np.int64)
        bits = hash_u32(hash_u32(st0 ^ _SALT_WL))
        p = (bits >> U64(8)).astype(F) * F(0.9999 / (1 << 24))
    # conf 0 sensor constants (lib.fut:20-28) in channel order 0,1,2
    mu = R.SENSOR_MU[ch]
    sigma = R.SENSOR_SIGMA[ch]
    wl = (mu + sigma * R.probit(np.maximum(p, F(1e-12)))).astype(F)
    return st, wl, ch


def sample_ray(st, origin, w, h, jx, iy):
    """Tracer models/camera.py sample_ray at pitch = yaw = 0,
    aperture 0 (conf 0): one in_unit_square draw; lens derived from the
    same draws (irrelevant at aperture 0). Returns the INCOMING state
    un-advanced (the reference's jitter-reuse quirk, camera.fut:86-102
    -> integrator.fut:86-101, matched by production since round 4)."""
    st0 = st
    st, (ox, oy) = in_unit_square(st)
    x = ((jx + ox) / F(w)).astype(F)
    y = ((iy + oy) / F(h)).astype(F)
    ratio = F(w) / F(h)
    half_h = F(np.tan(np.deg2rad(80.0) / 2))
    half_w = ratio * half_h
    u = np.array([1, 0, 0], F)
    v = np.array([0, 1, 0], F)
    w_vec = np.array([0, 0, 1], F)
    lower_left = origin - half_w * u - half_h * v - w_vec
    target = (lower_left + x[:, None] * (2 * half_w * u)
              + y[:, None] * (2 * half_h * v))
    d = target - origin
    return st0, np.broadcast_to(origin, d.shape).astype(F), R.normalise(d)


# ---------------------------------------------------------------------------
# ops/materials.py uber_sample_dir (tracer 7-draw compute-all discipline)
# on the oracle's formula implementations

def ts_sample_dir(st, wo_world, normal, m):
    onb = R.mk_onb(normal)
    wo = R.world_to_local(onb, wo_world)

    st, p_metal = next_unit(st)
    st, p_fres = next_unit(st)
    st, p_opac = next_unit(st)

    # candidate 1: Beckmann reflection
    st, (u0, u1) = in_unit_square(st)
    with np.errstate(divide="ignore"):
        log_sample = np.log(1 - u0).astype(F)
    alpha = R.beckmann_alpha(m.roughness)
    t2 = -alpha * alpha * log_sample
    phi = (u1 * F(2 * np.pi)).astype(F)
    ct = (1.0 / np.sqrt(1 + t2)).astype(F)
    stheta = np.sqrt(np.maximum(F(0), 1 - ct * ct))
    wh = np.stack([stheta * np.cos(phi), stheta * np.sin(phi), ct],
                  axis=-1).astype(F)
    wh = np.where(R.same_hemisphere(wo, wh)[..., None], wh, -wh)
    pdf_wh = (R.microfacet_distribution(alpha, wh) * np.abs(ct)).astype(F)
    bad = np.isinf(log_sample)
    wh = np.where(bad[..., None], F(0), wh)
    pdf_wh = np.where(bad, F(0), pdf_wh)
    wi_r = R.reflect(wo, wh)
    with np.errstate(invalid="ignore", divide="ignore"):
        pdf_r = (pdf_wh / (4 * R.dot(wo, wh))).astype(F)
    kind_r = np.where(pdf_wh > 0, PDF_NONZERO, PDF_IMPOSSIBLE)
    ok = R.same_hemisphere(wo, wi_r)
    bsdf_r = np.where(ok, R.dielectric_reflection_bsdf(wo, wi_r, m), F(0))
    kind_r = np.where(ok, kind_r, PDF_IMPOSSIBLE)
    wi_r = np.where(ok[..., None], wi_r, F(0))
    pdf_r = np.where(ok, pdf_r, F(0))

    # candidate 2: cosine diffuse (Malley)
    st, (dx, dy) = in_unit_disk_xy(st)
    sin2 = dx * dx + dy * dy
    z = np.sqrt(np.maximum(F(0), 1 - sin2))
    wi_d = np.stack([dx, dy, z], axis=-1).astype(F)
    bsdf_d = R.diffuse_bsdf(m)
    pdf_d = (R.cos_theta(wi_d) * R.INV_PI).astype(F)

    # candidate 3: transmission (no draws); jax clamps 1/|cos| at 1e-12
    smp_t = R.transmission_sample_dir(wo, m)
    wi_t, bsdf_t = smp_t.wi, smp_t.bsdf

    metal_branch = p_metal < m.metalness
    from_inside = R.cos_theta(wo) <= 0
    fres = R.fresnel_reflectance(wo, m)
    refl_branch = (~metal_branch) & (~from_inside) & (p_fres < fres)
    use_refl = metal_branch | refl_branch
    diffuse_branch = (~use_refl) & (p_opac < m.opacity)

    bsdf_refl = np.where(metal_branch, (m.color * bsdf_r).astype(F),
                         bsdf_r)
    wi = np.where(use_refl[..., None], wi_r,
                  np.where(diffuse_branch[..., None], wi_d, wi_t))
    bsdf = np.where(use_refl, bsdf_refl,
                    np.where(diffuse_branch, bsdf_d, bsdf_t)).astype(F)
    pdf = np.where(use_refl, pdf_r,
                   np.where(diffuse_branch, pdf_d, F(0))).astype(F)
    kind = np.where(use_refl, kind_r,
                    np.where(diffuse_branch, PDF_NONZERO, PDF_DELTA))
    return st, R.local_to_world(onb, wi), bsdf, pdf, kind


# ---------------------------------------------------------------------------
# engine/direct.py estimate_direct + direct_radiance (tracer discipline)

def ts_direct_radiance(st, wo, hit_pos, hit_normal, m, wavelen,
                       lights, tris):
    n_lights = lights.count
    if n_lights == 0:
        return st, np.zeros(hit_pos.shape[:-1], F)
    st, li = select(st, n_lights)
    a, b, c = lights.a[li], lights.b[li], lights.c[li]
    em_val = R.spectrum_lookup(wavelen, lights.emission[li])

    e1, e2 = b - a, c - a
    area = (R.norm(R.cross(e1, e2)) / 2).astype(F)
    inv_area = (1.0 / np.maximum(area, F(1e-30))).astype(F)

    # light half
    st, (u, v) = in_triangle(st)
    p = (a + u[..., None] * e1 + v[..., None] * e2).astype(F)
    vvec = p - hit_pos
    wi_l = (vvec / np.maximum(R.norm(vvec), F(1e-30))[..., None]).astype(F)
    dist_sq = np.maximum(R.dot(vvec, vvec), F(1e-30))
    lnormal = R.normalise(R.cross(e1, e2))
    cos_l = R.dot(-wi_l, lnormal)
    in_rad = np.maximum(F(0), em_val * cos_l / dist_sq).astype(F)
    f_l = (R.bsdf_f(wo, wi_l, hit_normal, m)
           * np.abs(R.dot(wi_l, hit_normal))).astype(F)
    scat_pdf = R.bsdf_pdf(wo, wi_l, hit_normal, m)
    w_l = (inv_area / (inv_area + scat_pdf)).astype(F)
    occ = R.occluded(hit_pos, hit_normal, p, tris)
    in_rad = np.where(occ, F(0), in_rad)
    with np.errstate(invalid="ignore", divide="ignore"):
        light_part = (f_l * w_l * in_rad / inv_area).astype(F)
    light_part = np.where((inv_area == 0) | (in_rad == 0), F(0),
                          light_part)

    # bsdf half
    st, wi_b, bsdf_b, pdf_b, kind_b = ts_sample_dir(st, wo, hit_normal, m)
    o2, d2 = R.mkray_adjust_acne(hit_pos, hit_normal, wi_b)
    lv, lt, lpos = R.hit_one_triangle(o2, d2, F(np.finfo(np.float32).max),
                                      a, b, c)
    occ2 = R.occluded(hit_pos, hit_normal, lpos, tris)
    vv2 = lpos - hit_pos
    d2sq = np.maximum(R.dot(vv2, vv2), F(1e-30))
    wi2 = (vv2 / np.maximum(R.norm(vv2), F(1e-30))[..., None]).astype(F)
    cos_l2 = R.dot(-wi2, lnormal)
    in_rad_b = np.maximum(F(0), em_val * cos_l2 / d2sq).astype(F)
    f_b = (bsdf_b * np.abs(R.dot(wi_b, hit_normal))).astype(F)
    w_b = (pdf_b / (pdf_b + inv_area)).astype(F)
    with np.errstate(invalid="ignore", divide="ignore"):
        nz = (f_b * in_rad_b * w_b / np.maximum(pdf_b, F(1e-30))).astype(F)
    contrib = np.where(kind_b == PDF_DELTA, (f_b * in_rad_b).astype(F),
                       np.where(kind_b == PDF_NONZERO, nz, F(0)))
    bsdf_part = np.where(lv & ~occ2, contrib, F(0)).astype(F)

    return st, ((light_part + bsdf_part) * F(n_lights)).astype(F)


# ---------------------------------------------------------------------------
# the per-frame path (engine/integrator.py sample_pixels semantics)

def lockstep_frame(seed, nonce, w, h, tris_obj, tm, mats_rows,
                   cam_origin):
    trs = R.Tris(tris_obj, tm)
    mats = R.Mats(mats_rows)
    lights = R.Lights(tris_obj, tm, mats)
    n = w * h
    lane = np.arange(n, dtype=np.uint32)
    jx = (lane % w).astype(F)
    iy = (F(h) - (lane // w).astype(F) - F(1.0))
    st = make_streams(seed, nonce, lane)
    st, wl, ch = sample_wavelength(st)
    origin = np.asarray(cam_origin, F)
    st, o, d = sample_ray(st, origin, w, h, jx, iy)

    alive = np.ones(n, bool)
    dist = np.full((R.PATH_LEN, n), np.inf, F)
    rad = np.zeros((R.PATH_LEN, n), F)
    cum = np.zeros(n, F)
    fmax = F(np.finfo(np.float32).max)
    o = o.copy()
    d = d.copy()
    for bounce in range(R.PATH_LEN):
        if not alive.any():
            break
        hit, t, pos, normal, mix = R.closest_hit(o, d, fmax, trs)
        hit = alive & hit
        miss = alive & ~hit
        m = R.MatAtWavelen(mats, mix, wl)
        wo = -d
        # tracer: ALL lanes advance their streams every bounce
        st, direct = ts_direct_radiance(st, wo, pos, normal, m, wl,
                                        lights, trs)
        emis = R.spectrum_lookup(wl, mats.emission[mix])
        radiance = np.where(hit,
                            direct + np.where(bounce == 0, emis, F(0)),
                            F(0))
        cum = np.where(hit, cum + t, cum)
        dist[bounce] = np.where(hit, cum, np.inf)
        rad[bounce] = np.where(hit, radiance, F(0))

        st, wi, bsdf, pdf_val, kind = ts_sample_dir(st, wo, normal, m)
        pdf = np.where(kind == PDF_DELTA, F(1),
                       np.where(kind == PDF_NONZERO, pdf_val,
                                F(0))).astype(F)
        cosf = np.abs(R.dot(normal, wi))
        with np.errstate(invalid="ignore", divide="ignore",
                         over="ignore"):
            p_term = (1 - bsdf * cosf / pdf).astype(F)
        st, u = next_unit(st)
        terminate = u < p_term
        alive = hit & (pdf != 0) & ~terminate
        o2, d2 = R.mkray_adjust_acne(pos, normal, wi)
        o = np.where(alive[:, None], o2, o)
        d = np.where(alive[:, None], d2, d)
    return dict(wl=wl, ch=ch, dist=dist, rad=rad)


def use_iid_engine(rng_seed):
    """Swap the tracer-PCG engine for TRUE iid numpy PCG64 draws while
    keeping the tracer draw discipline bit-for-bit. Arbiter experiment:
    if lockstep+iid still shows the +5% G, the DISCIPLINE (a draw
    mapped to two uses, or a semantic misreading) is guilty; if it
    vanishes, the tracer's counter-PCG stream structure is."""
    g = np.random.default_rng(rng_seed)
    gm = globals()

    def next_u32(st):
        return st, np.asarray(g.integers(0, 1 << 32, size=st.shape), U64)

    def next_unit(st):
        return st, (g.random(st.shape) * 0.9999).astype(F)

    def next_uniform(st, lo, hi):
        return st, (F(lo) + g.random(st.shape).astype(F) * F(hi - lo))

    def select(st, n):
        return st, np.asarray(g.integers(0, n, size=st.shape), np.int64)

    def make_streams(seed, frame, lane_ids):
        return np.ones(lane_ids.shape, U64)

    for f in (next_u32, next_unit, next_uniform, select, make_streams):
        gm[f.__name__] = f


_CHDECOR = {"gen": None}


def use_chdecor(rng_seed):
    """Channel/wavelength drawn from an independent iid source; the
    main stream still advances twice so every OTHER draw is identical
    to the production engine. Isolates channel<->path correlation
    through the tracer's hash chain (the first stream output feeds
    select(st, 3))."""
    _CHDECOR["gen"] = np.random.default_rng(rng_seed)


def use_deep_streams():
    """make_streams with one extra pcg_hash round (candidate fix: the
    production chain is hash(pix ^ hash(seed ^ hash(frame))) — the
    channel select is bits%3 of the FIRST output of a 1-round-hashed
    structured key)."""
    gm = globals()

    def make_streams(seed, frame, lane_ids):
        base = hash_u32(U64(seed) ^ hash_u32(U64(frame)))
        return hash_u32(hash_u32(lane_ids.astype(U64) ^ base))

    gm["make_streams"] = make_streams


_SALT_MODE = {"on": False}
_SALT_CH = U64(0x3C6EF372)
_SALT_WL = U64(0xDAA66D2B)


def use_salted_wavelength():
    """The candidate PRODUCTION fix, exactly as ops/rng.py would do it:
    channel and wavelength-p come from salted DOUBLE-round hashes of
    the pre-advance state (not from the sequential chain); the main
    stream still advances twice so every other draw is unchanged. If
    this matches chdecor's collapse, the correlation is broken to
    2-round-hash quality with zero iid dependence."""
    _SALT_MODE["on"] = True


def use_ctr_engine():
    """Counter-based engine prototype (the candidate ops/rng.py fix):
    state = key | (ctr << 32); draw k of lane key mixes (key, ctr) with
    two pcg_hash rounds. No shared orbit: two distinct keys can never
    merge tails (the current engine's single 2^32 LCG cycle gives ~3k
    merged lane pairs / 0.6% duplicated draws per 256-spp render)."""
    gm = globals()
    GAMMA = U64(0x9E3779B9)

    def next_u32(st):
        st = st + (U64(1) << U64(32))
        key = st & M32
        ctr = st >> U64(32)
        x = key ^ ((ctr * GAMMA) & M32)
        return st, hash_u32(hash_u32(x))

    def make_streams(seed, frame, lane_ids):
        base = hash_u32(U64(seed) ^ hash_u32(U64(frame)))
        return hash_u32(lane_ids.astype(U64) ^ base)  # key, ctr = 0

    gm["next_u32"] = next_u32
    gm["make_streams"] = make_streams


def render_energy(seed, size, spp, tris, tm, mats_rows, origin):
    """Full lockstep-estimator render -> per-channel mean image energy
    (the tracer's estimator semantics executed in numpy on the oracle's
    formulas)."""
    sums = np.zeros(3, np.float64)
    n = size * size
    for f in range(spp):
        L = lockstep_frame(seed, f, size, size, tris, tm, mats_rows,
                           origin)
        tot = L["rad"].sum(axis=0)          # (N,) per-lane path sum
        sc = R.SENSOR_COLOR[L["ch"]]        # (N, 3)
        sums += ((F(3.0) * tot)[:, None] * sc).astype(np.float64).sum(
            axis=0)
    return sums / (spp * n)


def capture_tri(seed, size, spp, tris, tm, mats_rows, origin, out):
    """Per-lane path radiance under each FORCED channel hypothesis.

    For every frame the chain consumes draws exactly as production
    (ch/p positions included), but the frame is evaluated 3x with
    channel forced to c (wavelength = mu_c + sigma_c * probit(p), same
    p). The result lets ANY channel labeling L be scored exactly:
      G_energy(L) = 3 * sum_{lanes: L=G} rad_1(lane) / (n * spp)
    — a zero-extra-noise comparator for label-mixer candidates."""
    n = size * size
    rad3 = np.zeros((spp, 3, n), np.float32)
    p_all = np.zeros((spp, n), np.float32)
    ch_all = np.zeros((spp, n), np.int8)
    st0_all = np.zeros((spp, n), np.uint64)
    trs = R.Tris(tris, tm)
    mats = R.Mats(mats_rows)
    lights = R.Lights(tris, tm, mats)
    lane = np.arange(n, dtype=np.uint32)
    jx = (lane % size).astype(F)
    iy = (F(size) - (lane // size).astype(F) - F(1.0))
    originv = np.asarray(origin, F)
    for f in range(spp):
        st_init = make_streams(seed, f, lane)
        st0_all[f] = st_init
        st, ch = select(st_init, 3)
        st, p = next_unit(st)
        p_all[f] = p
        ch_all[f] = ch
        st_post, o, d = sample_ray(st, originv, size, size, jx, iy)
        for c in range(3):
            wl = (R.SENSOR_MU[c]
                  + R.SENSOR_SIGMA[c]
                  * R.probit(np.maximum(p, F(1e-12)))).astype(F)
            Lf = _trace_from(st_post, o, d, wl, trs, mats, lights)
            rad3[f, c] = Lf
    np.savez_compressed(out, rad3=rad3, p=p_all, ch=ch_all,
                        st0=st0_all, spp=spp, n=n)
    print(f"captured tri-channel radiance -> {out}")


def _trace_from(st, o, d, wl, trs, mats, lights):
    """Path trace continuing from the given stream state (the part of
    lockstep_frame after camera sampling); returns per-lane radiance
    path sum."""
    n = o.shape[0]
    alive = np.ones(n, bool)
    tot = np.zeros(n, F)
    fmax = F(np.finfo(np.float32).max)
    o = o.copy()
    d = d.copy()
    for bounce in range(R.PATH_LEN):
        if not alive.any():
            break
        hit, t, pos, normal, mix = R.closest_hit(o, d, fmax, trs)
        hit = alive & hit
        m = R.MatAtWavelen(mats, mix, wl)
        wo = -d
        st, direct = ts_direct_radiance(st, wo, pos, normal, m, wl,
                                        lights, trs)
        emis = R.spectrum_lookup(wl, mats.emission[mix])
        radiance = np.where(hit,
                            direct + np.where(bounce == 0, emis, F(0)),
                            F(0))
        tot = tot + radiance
        st, wi, bsdf, pdf_val, kind = ts_sample_dir(st, wo, normal, m)
        pdf = np.where(kind == PDF_DELTA, F(1),
                       np.where(kind == PDF_NONZERO, pdf_val,
                                F(0))).astype(F)
        cosf = np.abs(R.dot(normal, wi))
        with np.errstate(invalid="ignore", divide="ignore",
                         over="ignore"):
            p_term = (1 - bsdf * cosf / pdf).astype(F)
        st, u = next_unit(st)
        terminate = u < p_term
        alive = hit & (pdf != 0) & ~terminate
        o2, d2 = R.mkray_adjust_acne(pos, normal, wi)
        o = np.where(alive[:, None], o2, o)
        d = np.where(alive[:, None], d2, d)
    return tot


def score_labels(capture_path, golden_path):
    """Score channel-label mixers on captured tri-channel radiance."""
    d = np.load(capture_path)
    rad3, st0 = d["rad3"], d["st0"]
    spp, n = int(d["spp"]), int(d["n"])
    g = np.load(golden_path)
    e_gold = g["mean"].mean(axis=(0, 1))  # RGB image-space means

    def energy(labels):
        # labels: (spp, n) int in 0..2 (sensor-channel index:
        # 0=blue, 1=green, 2=red; SENSOR_COLOR maps to image RGB)
        out = np.zeros(3, np.float64)
        for c in range(3):
            sel = labels == c
            e = float(rad3[:, c][sel].sum()) * 3.0 / (spp * n)
            out += e * R.SENSOR_COLOR[c]
        return out  # image RGB means

    def show(name, labels):
        e = energy(labels)
        rel = (e - e_gold) / e_gold * 100
        print(f"  {name:14s} dR {rel[0]:+6.2f}%  dG {rel[1]:+6.2f}%  "
              f"dB {rel[2]:+6.2f}%")

    U = np.uint64

    def mix_rounds(x, k):
        y = np.asarray(x, U)
        for _ in range(k):
            y = hash_u32(y)
        return y

    def murmur(x):
        h = np.asarray(x, U) & M32
        h ^= h >> U(16)
        h = (h * U(0x85EBCA6B)) & M32
        h ^= h >> U(13)
        h = (h * U(0xC2B2AE35)) & M32
        h ^= h >> U(16)
        return h

    print("chain label (production):")
    show("chain", d["ch"].astype(np.int64))
    for k in (1, 2, 3, 4):
        show(f"hashx{k}",
             (mix_rounds(st0 ^ U(0x3C6EF372), k) % U(3)).astype(np.int64))
    show("murmur", (murmur(st0 ^ U(0x3C6EF372)) % U(3)).astype(np.int64))
    show("murmur2", (murmur(murmur(st0 ^ U(0x3C6EF372)))
                     % U(3)).astype(np.int64))
    show("hash+murmur", (murmur(hash_u32(st0 ^ U(0x3C6EF372)))
                         % U(3)).astype(np.int64))
    rng = np.random.default_rng(99)
    vals = []
    for r in range(20):
        lab = np.asarray(rng.integers(0, 3, size=st0.shape), np.int64)
        e = energy(lab)
        vals.append((e - e_gold) / e_gold * 100)
    vals = np.array(vals)
    print(f"  iid null (20): dG mean {vals[:, 1].mean():+.2f}% "
          f"sd {vals[:, 1].std():.2f}%  dR {vals[:, 0].mean():+.2f}"
          f"/{vals[:, 0].std():.2f}  dB {vals[:, 2].mean():+.2f}"
          f"/{vals[:, 2].std():.2f}")


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--scene", default="MirrorBox")
    ap.add_argument("--render", action="store_true",
                    help="full-render energy A/B vs the minstd golden "
                         "and a fresh tracer render (--frames = spp)")
    ap.add_argument("--engine", default="pcg",
                    choices=("pcg", "iid", "ctr", "chdecor", "deep",
                             "salt"),
                    help="iid = numpy PCG64 arbiter; ctr = counter-"
                         "based candidate; chdecor = channel/"
                         "wavelength from an independent iid source; "
                         "deep = extra make_streams hash round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-tracer", action="store_true",
                    help="skip the jax tracer render in --render mode")
    ap.add_argument("--capture-tri", metavar="OUT",
                    help="capture per-lane tri-channel radiance to OUT")
    ap.add_argument("--score-labels", metavar="NPZ",
                    help="score channel-label mixers on a capture")
    a = ap.parse_args()

    if a.score_labels:
        score_labels(a.score_labels, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), os.pardir,
            "tests", "goldens", "ref_numpy_mirrorbox32.npz"))
        return
    if a.capture_tri:
        from tracer_tpu.utils.objloader import load_obj
        tris, tm, mats_rows = load_obj(
            os.path.join(ASSETS, a.scene + ".obj"))
        capture_tri(a.seed, a.size, a.frames, tris, tm, mats_rows,
                    (0.0, 0.8, 0.9), a.capture_tri)
        return

    if a.engine == "iid":
        use_iid_engine(a.seed * 104729 + 7)
    elif a.engine == "ctr":
        use_ctr_engine()
    elif a.engine == "chdecor":
        use_chdecor(a.seed * 2654435761 + 13)
    elif a.engine == "deep":
        use_deep_streams()
    elif a.engine == "salt":
        use_salted_wavelength()

    if a.render:
        from tracer_tpu.utils.objloader import load_obj
        tris, tm, mats_rows = load_obj(
            os.path.join(ASSETS, a.scene + ".obj"))
        origin = (0.0, 0.8, 0.9)
        e_lock = render_energy(a.seed, a.size, a.frames, tris, tm,
                               mats_rows, origin)
        g = np.load(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "goldens",
            "ref_numpy_mirrorbox32.npz"))
        e_gold = g["mean"].mean(axis=(0, 1))
        if a.no_tracer:
            e_jax = np.full(3, np.nan)
        else:
            import tracer_tpu as T
            s = T.init(a.seed, a.size, a.size, 0, tris, tm, mats_rows,
                       cam_origin=origin)
            e_jax = np.asarray(T.sample_n_frames(s, a.frames)).mean(
                axis=(0, 1))
        for cix, name in enumerate("RGB"):
            print(f"  {name}: minstd-golden {e_gold[cix]:.5f}  "
                  f"lockstep {e_lock[cix]:.5f} "
                  f"({(e_lock[cix] - e_gold[cix]) / e_gold[cix] * 100:+.2f}%)  "
                  f"tracer {e_jax[cix]:.5f} "
                  f"({(e_jax[cix] - e_gold[cix]) / e_gold[cix] * 100:+.2f}%)")
        return

    from tracer_tpu.utils.objloader import load_obj
    tris, tm, mats_rows = load_obj(
        os.path.join(ASSETS, a.scene + ".obj"))
    origin = (0.0, 0.8, 0.9)

    import jax.numpy as jnp
    import jax
    import tracer_tpu as T
    from tracer_tpu.engine import integrator

    s = T.init(0, a.size, a.size, 0, tris, tm, mats_rows,
               cam_origin=origin)
    w, h = s.sub_dims

    @jax.jit
    def jax_frame(nonce):
        fs = integrator.sample_pixels(
            jnp.uint32(0), nonce, s.scene, s.cam, s.ambience, w, h,
            s.transmitter_kind)
        return fs.channel, fs.path.distance, fs.path.radiance

    tot = {"lanes": 0, "wl_mismatch": 0, "bounce_mismatch": 0}
    for f in range(a.frames):
        ch_j, dist_j, rad_j = (np.asarray(x) for x in
                               jax_frame(jnp.uint32(f)))
        L = lockstep_frame(0, f, w, h, tris, tm, mats_rows, origin)
        n = w * h
        tot["lanes"] += n
        chm = (ch_j != L["ch"]).sum()
        tot["wl_mismatch"] += int(chm)
        print(f"frame {f}: channel mismatches {chm}/{n}")
        for k in range(R.PATH_LEN):
            a_, b_ = L["rad"][k], rad_j[k]
            both0 = (a_ == 0) & (b_ == 0)
            denom = np.maximum(np.maximum(np.abs(a_), np.abs(b_)), 1e-4)
            rel = np.abs(a_ - b_) / denom
            bad = (~both0) & (rel > 1e-2)
            da, db = L["dist"][k], dist_j[k]
            dd = (np.isfinite(da) != np.isfinite(db))
            nb = int(bad.sum())
            tot["bounce_mismatch"] += nb
            if nb or dd.sum():
                ix = np.nonzero(bad | dd)[0][:6]
                print(f"  bounce {k}: {nb} rad mismatches, "
                      f"{int(dd.sum())} dist-finiteness mismatches; "
                      f"first lanes {list(ix)}")
                for i in ix[:3]:
                    print(f"    lane {i}: np rad={a_[i]:.6g} "
                          f"jax rad={b_[i]:.6g} np dist={da[i]:.4g} "
                          f"jax dist={db[i]:.4g} wl={L['wl'][i]:.2f} "
                          f"ch={L['ch'][i]}")
    print(f"TOTAL: {tot}")


if __name__ == "__main__":
    main()
