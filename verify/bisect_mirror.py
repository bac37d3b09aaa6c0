"""Bisect harness for the mirrorbox energy discrepancy: tracer_tpu
was +5.3% on the green channel vs the independent
numpy transliteration, with a 0.2% same-estimator control — a systematic
divergence on metal paths (material.fut:346-355, integrator.fut:62-69)
whose guilty side was unknown.

Independent attacks, cheapest first (measured results in the docstring
of each cmd_* and in docs/PARITY.md "mirrorbox investigation"):

  terms    deterministic grid A/B of every metal-lobe formula on
           IDENTICAL (wo, wi) inputs. MEASURED: clean (max 0.57% rel on
           near-delta tiny values, 0 finite mismatches).
  rr       the oracle's extra `~isfinite(p_term)` RR kill vs the
           reference's IEEE `q < p_terminate`. MEASURED: 0 of 4.66M
           lane-bounces affected on MirrorBox.
  probe    single-material probe scenes through both estimators.
           MEASURED: diffuse/metal03/chains clean.
  reuse    the camera-jitter rng-reuse quirk (camera.fut:86-102).
           MEASURED: G -0.52% — too small.
  chdecor  minstd channel<->path-draw correlation. MEASURED: G -0.46%.
  surgery  material-isolation A/Bs. MEASURED: gap needs the near-delta
           mirror (mirror->diffuse kills it), NOT spectral (flat
           light/metal spectra keep it).
  depth    per-bounce, per-channel energy + survival profiles.
           MEASURED: survival diverges +1.0%(G)/+1.3%(B) by bounce 15
           (tracer keeps more lanes) — real but ~10x too small for the
           energy gap.
  rrsim    per-interaction sample_dir+RR survival A/B at 4M lanes.
           MEASURED: E[p_cont] matches to 4e-5; survival shifts are
           ~2 sigma, consistent with minstd sequential-draw correlation
           at the few-1e-4 level.
  halves   MirrorBox with only one MIS half active (MIS_HALF_SCALE
           hooks in both estimators) — attributes the green excess to
           the light-sample or BSDF-sample half of estimate_direct.

Run on CPU: `python verify/bisect_mirror.py <cmd>`.
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
ASSETS = os.environ.get("TRACER_ASSETS", "/root/reference/assets")


# ---------------------------------------------------------------------------
# terms: formula-level grid A/B


class _M:
    """Duck-typed material' for the numpy module functions."""

    def __init__(self, color, roughness, metalness, ref_ix, opacity):
        self.color = F(color)
        self.roughness = F(roughness)
        self.metalness = F(metalness)
        self.ref_ix = F(ref_ix)
        self.opacity = F(opacity)


def _wi_grid(n_ang=24, n_u=64):
    """Deterministic (wo, wi) pairs: wo over incidence angles x sampled
    Beckmann wh over a (u0, u1) grid, wi = reflect(wo, wh) — exactly the
    directions the metal lobe visits."""
    rng = np.random.default_rng(7)
    thetas = np.linspace(0.01, 1.55, n_ang)
    wos, whs = [], []
    for rough in (0.0, 0.1, 0.3):
        alpha = R.beckmann_alpha(F(rough))
        for th in thetas:
            wo = np.array([np.sin(th), 0.0, np.cos(th)], F)
            u0 = rng.random(n_u).astype(F) * F(0.9999)
            u1 = rng.random(n_u).astype(F) * F(0.9999)
            t2 = -alpha * alpha * np.log(1 - u0).astype(F)
            ct = (1.0 / np.sqrt(1 + t2)).astype(F)
            st = np.sqrt(np.maximum(F(0), 1 - ct * ct))
            phi = u1 * 2 * np.pi
            wh = np.stack([st * np.cos(phi), st * np.sin(phi), ct],
                          axis=-1).astype(F)
            wos.append(np.broadcast_to(wo, wh.shape).copy())
            whs.append(wh)
    wo = np.concatenate(wos)
    wh = np.concatenate(whs)
    wi = R.reflect(wo, wh)
    keep = R.same_hemisphere(wo, wi)
    return wo[keep], wi[keep]


def cmd_terms():
    import jax.numpy as jnp
    from tracer_tpu.ops import materials as JM

    wo, wi = _wi_grid()
    n = len(wo)
    print(f"{n} (wo, wi) pairs")
    for rough, metal, ref_ix, opac in [(0.0, 1.0, 50.0, 1.0),
                                       (0.1, 1.0, 8.0, 1.0),
                                       (0.3, 0.5, 1.5, 1.0),
                                       (1.0, 0.0, 1.0, 1.0)]:
        m_np = _M(0.6, rough, metal, ref_ix, opac)
        m_jx = JM.MaterialLanes(
            color=jnp.full((n,), 0.6, jnp.float32),
            roughness=jnp.full((n,), rough, jnp.float32),
            metalness=jnp.full((n,), metal, jnp.float32),
            ref_ix=jnp.full((n,), ref_ix, jnp.float32),
            opacity=jnp.full((n,), opac, jnp.float32))
        wo_j = jnp.asarray(wo.T)   # V3 = (3, N)
        wi_j = jnp.asarray(wi.T)

        pairs = {
            "refl_bsdf": (R.dielectric_reflection_bsdf(wo, wi, m_np),
                          JM.dielectric_reflection_bsdf(wo_j, wi_j, m_jx)),
            "refl_pdf": (R.dielectric_reflection_pdf(wo, wi, m_np),
                         JM.dielectric_reflection_pdf(wo_j, wi_j, m_jx)),
            "fresnel": (R.fresnel_reflectance(wo, m_np),
                        JM.fresnel_reflectance(wo_j, m_jx)),
            "uber_bsdf": (R.uber_bsdf(wo, wi, m_np),
                          JM.uber_bsdf(wo_j, wi_j, m_jx)),
            "uber_pdf": (R.uber_pdf(wo, wi, m_np),
                         JM.uber_pdf(wo_j, wi_j, m_jx)),
        }
        print(f"-- rough={rough} metal={metal} ref_ix={ref_ix}")
        for name, (a, b) in pairs.items():
            a = np.asarray(a, np.float64)
            b = np.asarray(b, np.float64)
            both_fin = np.isfinite(a) & np.isfinite(b)
            fin_mismatch = int((~both_fin & (np.isfinite(a)
                                             != np.isfinite(b))).sum())
            denom = np.maximum(np.abs(a[both_fin]), 1e-6)
            rel = np.abs(a[both_fin] - b[both_fin]) / denom
            print(f"   {name:10s} max_rel={rel.max():.3e} "
                  f"finite_mismatch={fin_mismatch}")


# ---------------------------------------------------------------------------
# rr: the ~isfinite(p_term) clause vs reference IEEE comparison semantics


def _path_trace_flagged(st, ray_o, ray_d, wavelen, tris, mats, lights,
                        ieee_rr, counters):
    """ref_estimator_numpy.path_trace with the RR-termination comparison
    switchable and instrumented.  ieee_rr=True reproduces the reference's
    exact `q < p_terminate` (NaN/-inf compare FALSE -> continue);
    ieee_rr=False is the committed oracle (extra ~isfinite kill)."""
    L = ray_o.shape[0]
    alive = np.ones(L, bool)
    total = np.zeros(L, F)
    fmax = F(np.finfo(np.float32).max)
    for bounce in range(R.PATH_LEN):
        if not alive.any():
            break
        hit, t, pos, normal, mix = R.closest_hit(ray_o, ray_d, fmax, tris)
        miss = alive & ~hit
        total = np.where(miss, total, total)
        act = alive & hit
        st_adv, _ = R.random_unit_exclusive(st)
        st = np.where(act, st_adv, st)
        m = R.MatAtWavelen(mats, mix, wavelen)
        wo = -ray_d
        st_d, direct = R.direct_radiance(st, wo, pos, normal, m, wavelen,
                                         lights, tris)
        st = np.where(act, st_d, st)
        emis = R.spectrum_lookup(wavelen, mats.emission[mix])
        rad = direct + (emis if bounce == 0 else F(0))
        total = np.where(act, total + rad, total)
        st_s, smp = R.sample_dir(st, wo, normal, m)
        st = np.where(act, st_s, st)
        pdf = np.where(smp.kind == R.PDF_DELTA, F(1),
                       np.where(smp.kind == R.PDF_NONZERO, smp.val,
                                F(0))).astype(F)
        cos_fall = np.abs(R.dot(normal, smp.wi))
        with np.errstate(invalid="ignore", divide="ignore",
                         over="ignore"):
            p_term = (1 - smp.bsdf * cos_fall / pdf).astype(F)
        st_t, q = R.random_unit_exclusive(st)
        st = np.where(act, st_t, st)
        base_term = (pdf == 0) | (q < p_term)
        extra = act & (pdf != 0) & ~np.isfinite(p_term) & ~(q < p_term)
        counters["nonfinite_continue"] += int(extra.sum())
        counters["act"] += int(act.sum())
        if ieee_rr:
            terminate = base_term
        else:
            terminate = base_term | ~np.isfinite(p_term)
        alive = act & ~terminate
        o2, d2 = R.mkray_adjust_acne(pos, normal, smp.wi)
        ray_o = np.where(alive[:, None], o2, ray_o)
        ray_d = np.where(alive[:, None], d2, ray_d)
    return st, total


def _render_flagged(seed, w, h, spp, tris, tri_mats, mat_rows, ieee_rr,
                    cam_origin=(0.0, 0.8, 0.9),  # make_golden.py mirrorbox
                    decorrelate=False):
    trs = R.Tris(tris, tri_mats)
    mats = R.Mats(mat_rows)
    lights = R.Lights(tris, tri_mats, mats)
    origin = np.asarray(cam_origin, F)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    j = jj.ravel().astype(F)
    i_flip = (F(h) - ii.ravel().astype(F) - F(1.0))
    pixel_ix = (ii.ravel() * w + jj.ravel()).astype(np.uint64)
    npix = w * h
    sum_img = np.zeros((npix, 3), np.float64)
    counters = {"nonfinite_continue": 0, "act": 0}
    for f0 in range(0, spp, 16):
        fc = min(16, spp - f0)
        st = np.concatenate([R.stream_states(seed, f0 + k, pixel_ix)
                             for k in range(fc)])
        jL = np.tile(j, fc)
        iL = np.tile(i_flip, fc)
        st, wl, ch = R.sample_camera_wavelength(st)
        o, d = R.sample_camera_ray(st, origin, w, h, jL, iL)
        if decorrelate:
            # break the reference's jitter-reuse quirk: the path reads
            # an INDEPENDENT stream instead of re-reading the camera's
            # jitter/lens draws (camera.fut:86-102 -> integrator.fut:
            # 86-101). The JAX tracer threads the advanced state, which
            # is statistically this decorrelated estimator.
            st = np.concatenate([
                R.stream_states(seed ^ 0x5DEECE66, f0 + k, pixel_ix)
                for k in range(fc)])
        st, total = _path_trace_flagged(st, o, d, wl, trs, mats, lights,
                                        ieee_rr, counters)
        vals = (F(3.0) * total)[:, None] * R.SENSOR_COLOR[ch]
        sum_img += vals.reshape(fc, npix, 3).astype(np.float64).sum(axis=0)
    return sum_img.reshape(h, w, 3) / spp, counters


def cmd_reuse(size=32, spp=512):
    """Measure the jitter-rng-reuse quirk's energy effect on MirrorBox:
    oracle-with-quirk (the committed transliteration = the reference)
    vs oracle-with-decorrelated-path-stream (= what the JAX tracer
    effectively computes). If this reproduces the +5% green test gap,
    the quirk is the root cause and the TRACER must adopt it."""
    from tracer_tpu.utils.objloader import load_obj
    tris, tm, mats = load_obj(os.path.join(ASSETS, "MirrorBox.obj"))
    img_q, _ = _render_flagged(7, size, size, spp, tris, tm, mats,
                               ieee_rr=False, decorrelate=False)
    img_d, _ = _render_flagged(7, size, size, spp, tris, tm, mats,
                               ieee_rr=False, decorrelate=True)
    for cix, name in enumerate("RGB"):
        a = img_q[..., cix].mean()   # with quirk (reference semantics)
        b = img_d[..., cix].mean()   # decorrelated (tracer semantics)
        print(f"  {name}: quirk {a:.5f}  decorrelated {b:.5f}  "
              f"decorr-vs-quirk {(b - a) / max(a, 1e-12) * 100:+.2f}%")


def cmd_rr(size=32, spp=256):
    from tracer_tpu.utils.objloader import load_obj
    tris, tm, mats = load_obj(os.path.join(ASSETS, "MirrorBox.obj"))
    img_orig, c1 = _render_flagged(7, size, size, spp, tris, tm, mats,
                                   ieee_rr=False)
    img_ieee, c2 = _render_flagged(7, size, size, spp, tris, tm, mats,
                                   ieee_rr=True)
    print(f"lane-bounces where the extra ~isfinite clause kills a lane "
          f"the reference continues: {c2['nonfinite_continue']} "
          f"of {c2['act']} active "
          f"({100.0 * c2['nonfinite_continue'] / max(c2['act'], 1):.3f}%)")
    for cix, name in enumerate("RGB"):
        a = img_orig[..., cix].mean()
        b = img_ieee[..., cix].mean()
        print(f"  {name}: committed-oracle {a:.5f}  ieee-rr {b:.5f}  "
              f"rel {(b - a) / max(a, 1e-12) * 100:+.2f}%")


# ---------------------------------------------------------------------------
# engine: oracle estimator with the tracer's PCG engine swapped in


def _pcg_patch():
    """Monkeypatch the oracle's minstd engine with a numpy port of the
    tracer's counter-PCG (ops/rng.py), leaving every estimator line
    untouched. The derived samplers resolve the engine by module-global
    name, so patching the four primitives re-bases everything."""
    U64 = np.uint64
    MULT, INC = U64(747796405), U64(2891336453)
    M32 = U64(0xFFFFFFFF)

    def permute(st):
        word = (((st >> ((st >> U64(28)) + U64(4))) ^ st)
                * U64(277803737)) & M32
        return (word >> U64(22)) ^ word

    def rand(st):
        st = (st * MULT + INC) & M32
        return st, permute(st)

    def dist_rand(st, lo, hi):
        st, v = rand(st)
        u = (v >> U64(8)).astype(np.float64) / float(1 << 24)
        return st, (F(lo) + F(hi - lo) * u.astype(F))

    def random_unit_exclusive(st):
        return dist_rand(st, 0.0, 0.9999)

    def random_select_ix(st, n):
        st, v = rand(st)
        return st, (v % U64(n)).astype(np.int64)

    def hash_u32(x):
        return permute((x.astype(U64) * MULT + INC) & M32)

    def stream_states(seed, frame, pixel_ix):
        base = hash_u32(np.asarray(U64(seed) & M32)
                        ^ hash_u32(np.asarray(U64(frame) & M32)))
        return hash_u32(pixel_ix.astype(U64) ^ base)

    saved = {k: getattr(R, k) for k in
             ("rand", "dist_rand", "random_unit_exclusive",
              "random_select_ix", "stream_states")}
    R.rand = rand
    R.dist_rand = dist_rand
    R.random_unit_exclusive = random_unit_exclusive
    R.random_select_ix = random_select_ix
    R.stream_states = stream_states
    return saved


def cmd_engine(size=32, spp=384):
    """THE global experiment: render MirrorBox with the ORACLE estimator
    but the TRACER's RNG engine (counter-PCG swapped for minstd; every
    estimator line identical). Compared against the committed minstd
    golden AND a fresh tracer render: if oracle+PCG reproduces the
    tracer's +4% green, the whole divergence is the RNG engine (the
    documented deviation) and both estimator codes are exonerated."""
    from tracer_tpu.utils.objloader import load_obj
    tris, tm, mats = load_obj(os.path.join(ASSETS, "MirrorBox.obj"))
    origin = (0.0, 0.8, 0.9)
    g = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "goldens",
        "ref_numpy_mirrorbox32.npz"))
    mean_g = g["mean"]

    saved = _pcg_patch()
    try:
        mean_p, _, _ = R.render(7, size, size, spp, tris, tm, mats,
                                cam_origin=origin)
    finally:
        for k, v in saved.items():
            setattr(R, k, v)

    import tracer_tpu as T
    s = T.init(0, size, size, 0, tris, tm, mats, cam_origin=origin)
    mean_j = np.asarray(T.sample_n_frames(s, spp))

    for cix, name in enumerate("RGB"):
        a = mean_g[..., cix].mean()        # minstd golden (seed 0, 512)
        b = mean_p[..., cix].mean()        # oracle + PCG engine
        c = mean_j[..., cix].mean()        # tracer
        print(f"  {name}: minstd-golden {a:.5f}  oracle+pcg {b:.5f} "
              f"({(b - a) / a * 100:+.2f}%)  tracer {c:.5f} "
              f"({(c - a) / a * 100:+.2f}%)")


# ---------------------------------------------------------------------------
# verdict: the decisive seed-swept, engine-controlled run of the TEST'S
# EXACT clipped-energy statistic, with a gold-standard iid arbiter


def _iid_patch(rng_seed):
    """Replace the oracle engine with TRUE iid draws from numpy PCG64
    (gold-standard, no lattice/serial structure). The oracle's state
    threading becomes a no-op; since every consumed value is iid
    uniform, masked/discarded draws are statistically irrelevant."""
    g = np.random.default_rng(rng_seed)

    def rand(st):
        v = np.asarray(g.integers(1, int(R.M31) - 1, size=st.shape),
                       np.uint64)
        return st, v

    def dist_rand(st, lo, hi):
        u = g.random(st.shape)
        return st, (F(lo) + F(hi - lo) * u.astype(F))

    def random_unit_exclusive(st):
        return dist_rand(st, 0.0, 0.9999)

    def random_select_ix(st, n):
        return st, np.asarray(g.integers(0, n, size=st.shape), np.int64)

    def stream_states(seed, frame, pixel_ix):
        return np.ones(pixel_ix.shape, np.uint64)

    saved = {k: getattr(R, k) for k in
             ("rand", "dist_rand", "random_unit_exclusive",
              "random_select_ix", "stream_states")}
    R.rand = rand
    R.dist_rand = dist_rand
    R.random_unit_exclusive = random_unit_exclusive
    R.random_select_ix = random_select_ix
    R.stream_states = stream_states
    return saved


def _clipped_diff(golden_mean, probe_mean):
    """tests/test_ref_estimator.py::_clipped_energy_diff verbatim:
    per-channel signed relative clipped-energy difference."""
    out = []
    for c in range(3):
        a = golden_mean[..., c].ravel()
        b = probe_mean[..., c].ravel()
        hi = np.quantile(np.concatenate([a, b]), 0.99)
        am, bm = a.clip(0, hi).mean(), b.clip(0, hi).mean()
        out.append((bm - am) / am)
    return out


def cmd_verdict(size=32, spp=256, seeds=(1, 2, 3, 11, 13)):
    """THE arbitration experiment for the mirrorbox +5.3% G failure.

    Renders MirrorBox probes at `spp` through the ORACLE with three
    engines — minstd (reference-bitwise), pcg (the tracer's engine),
    iid (numpy PCG64, gold standard) — at several seeds each, plus the
    TRACER at several seeds, and evaluates the committed test's exact
    per-channel clipped-energy statistic against the committed minstd
    golden (seed 7, 512 spp). Error bars come from the seed spread.

    Readout:
      - iid & pcg cluster together, away from minstd near 0
          -> the gap is a minstd-engine artifact of the REFERENCE's RNG
             (serial correlation on near-delta specular paths); both
             estimator codes are exonerated (lockstep already proved
             semantic identity).
      - iid clusters with minstd near 0, tracer/pcg away
          -> the tracer's counter-PCG stream structure is biased: a
             real tracer bug in ops/rng.py.
      - all three oracle engines near 0, tracer alone away
          -> a tracer defect OUTSIDE the draws (contradicting lockstep;
             would mean lockstep's coverage missed the guilty config).
    """
    from tracer_tpu.utils.objloader import load_obj
    tris, tm, mats = load_obj(os.path.join(ASSETS, "MirrorBox.obj"))
    origin = (0.0, 0.8, 0.9)
    g = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "goldens",
        "ref_numpy_mirrorbox32.npz"))
    mean_g = g["mean"]

    def report(tag, mean_p):
        d = _clipped_diff(mean_g, mean_p)
        print(f"  {tag:16s} dR {d[0] * 100:+6.2f}%  dG {d[1] * 100:+6.2f}%"
              f"  dB {d[2] * 100:+6.2f}%", flush=True)

    print(f"clipped-energy diff vs committed minstd golden "
          f"(seed 7, 512 spp), probes {size}x{size}x{spp}spp")
    import time
    for eng in ("minstd", "pcg", "iid"):
        for sd in seeds:
            t0 = time.time()
            if eng == "minstd":
                saved = None
            elif eng == "pcg":
                saved = _pcg_patch()
            else:
                saved = _iid_patch(sd * 7919 + 1)
            try:
                mean_p, _, _ = R.render(sd, size, size, spp, tris, tm,
                                        mats, cam_origin=origin)
            finally:
                if saved:
                    for k, v in saved.items():
                        setattr(R, k, v)
            report(f"{eng} seed={sd}", mean_p)
            print(f"    ({time.time() - t0:.0f}s)", flush=True)

    import tracer_tpu as T
    for sd in seeds[:3]:
        s = T.init(sd, size, size, 0, tris, tm, mats, cam_origin=origin)
        mean_j = np.asarray(T.sample_n_frames(s, spp))
        report(f"tracer seed={sd}", mean_j)


# ---------------------------------------------------------------------------
# halves: split the NEE MIS halves across both estimators


def cmd_halves(size=32, spp=384):
    """Renders MirrorBox with only ONE MIS half active at a time (both
    estimators patched via their MIS_HALF_SCALE hooks) — attributes the
    +4% green excess to the light-sample half or the BSDF-sample half
    of estimate_direct (direct.fut:63-103)."""
    import tracer_tpu as T
    from tracer_tpu.engine import direct as jdirect

    from tracer_tpu.utils.objloader import load_obj
    tris, tm, mats = load_obj(os.path.join(ASSETS, "MirrorBox.obj"))
    origin = (0.0, 0.8, 0.9)
    for name, scale in (("light-only", (1.0, 0.0)),
                        ("bsdf-only", (0.0, 1.0))):
        import jax

        jax.clear_caches()  # the scale is baked in at trace time
        R.MIS_HALF_SCALE = scale
        jdirect.MIS_HALF_SCALE = scale
        try:
            mean_r, _, _ = R.render(7, size, size, spp, tris, tm, mats,
                                    cam_origin=origin)
            s = T.init(0, size, size, 0, tris, tm, mats,
                       cam_origin=origin)
            mean_j = np.asarray(T.sample_n_frames(s, spp))
        finally:
            R.MIS_HALF_SCALE = (1.0, 1.0)
            jdirect.MIS_HALF_SCALE = (1.0, 1.0)
        rels = [(mean_j[..., c].mean() - mean_r[..., c].mean())
                / max(mean_r[..., c].mean(), 1e-9) * 100
                for c in range(3)]
        print(f"{name:11s} refRGB=({mean_r[..., 0].mean():.4f},"
              f"{mean_r[..., 1].mean():.4f},{mean_r[..., 2].mean():.4f}) "
              f"jax-vs-ref R{rels[0]:+.2f}% G{rels[1]:+.2f}% "
              f"B{rels[2]:+.2f}%", flush=True)


# ---------------------------------------------------------------------------
# rrsim: direct A/B of the metal sample_dir + unit-weight-RR composite


def cmd_rrsim(n=4_000_000):
    """Per-interaction survival A/B: for fixed (wo, metal material),
    both implementations run sample_dir then the RR test with their own
    rng; survival = (pdf != 0) & ~(u < 1 - bsdf*cos/pdf). The depth
    channel-split showed the tracer keeps ~+0.07%/bounce more G/B
    lanes alive; if that is a per-metal-interaction survival shift it
    reproduces here at 4M lanes (binomial SE ~0.05% abs)."""
    import jax
    import jax.numpy as jnp

    from tracer_tpu.ops import materials as JM
    from tracer_tpu.ops import rng as jprng

    for rough, ni, color, th in [(0.1, 8.0, 0.9, 0.5),
                                 (0.1, 8.0, 0.52, 0.5),
                                 (0.1, 8.0, 0.1, 0.5),
                                 (0.1, 8.0, 0.1, 1.1),
                                 (0.0, 50.0, 1.0, 0.5),
                                 (1.0, 1.0, 0.7, 0.5)]:
        metal = 1.0 if ni > 1.0 else 0.0
        # --- oracle side (minstd streams)
        st = R.stream_states(3, 0, np.arange(n, dtype=np.uint64))
        m_np = _M(color, rough, metal, ni, 1.0)
        wo1 = np.array([np.sin(th), 0.0, np.cos(th)], F)
        wo = np.broadcast_to(wo1, (n, 3)).copy()
        normal = np.broadcast_to(np.array([0.0, 0.0, 1.0], F),
                                 (n, 3)).copy()
        st, smp = R.sample_dir(st, wo, normal, m_np)
        pdf = np.where(smp.kind == R.PDF_DELTA, F(1),
                       np.where(smp.kind == R.PDF_NONZERO, smp.val,
                                F(0))).astype(F)
        cos_fall = np.abs(R.dot(normal, smp.wi))
        with np.errstate(invalid="ignore", divide="ignore",
                         over="ignore"):
            p_term = (1 - smp.bsdf * cos_fall / pdf).astype(F)
        st, q = R.random_unit_exclusive(st)
        surv_r = (pdf != 0) & ~(q < p_term)
        pc_r = np.where(pdf != 0, 1 - p_term, 0.0)

        # --- jax side (counter-PCG streams)
        state = jprng.make_streams(jnp.uint32(9), jnp.uint32(0),
                                   jnp.arange(n, dtype=jnp.uint32))
        mj = JM.MaterialLanes(
            color=jnp.full((n,), color, jnp.float32),
            roughness=jnp.full((n,), rough, jnp.float32),
            metalness=jnp.full((n,), metal, jnp.float32),
            ref_ix=jnp.full((n,), ni, jnp.float32),
            opacity=jnp.full((n,), 1.0, jnp.float32))
        wo_j = jnp.asarray(wo.T)
        nr_j = jnp.asarray(normal.T)

        @jax.jit
        def run(state):
            state, wi, bsdf, pdf_val, pdf_kind = JM.sample_dir(
                state, wo_j, nr_j, mj)
            pdf = jnp.where(pdf_kind == JM.PDF_DELTA, 1.0,
                            jnp.where(pdf_kind == JM.PDF_NONZERO,
                                      pdf_val, 0.0))
            cosf = jnp.abs(jnp.sum(nr_j * wi, axis=0))
            p_term = 1.0 - bsdf * cosf / pdf
            state, u = jprng.next_unit(state)
            surv = (pdf != 0) & ~(u < p_term)
            return surv, jnp.where(pdf != 0, 1.0 - p_term, 0.0)

        surv_j, pc_j = (np.asarray(x) for x in run(state))
        fin_r = pc_r[np.isfinite(pc_r)]
        fin_j = pc_j[np.isfinite(pc_j)]
        print(f"rough={rough} ni={ni} color={color} th={th}: "
              f"surv ref {surv_r.mean():.5f} jax {surv_j.mean():.5f} "
              f"rel {(surv_j.mean() - surv_r.mean()) / surv_r.mean() * 100:+.2f}% | "
              f"E[p_cont] ref {fin_r.mean():.5f} jax {fin_j.mean():.5f} | "
              f"p_cont>1 ref {(fin_r > 1).mean() * 100:.3f}% "
              f"jax {(fin_j > 1).mean() * 100:.3f}% | "
              f"nonfin ref {(~np.isfinite(pc_r)).mean() * 100:.4f}% "
              f"jax {(~np.isfinite(pc_j)).mean() * 100:.4f}%")


# ---------------------------------------------------------------------------
# chdecor: break the minstd channel<->path-draw correlation only


def cmd_chdecor(size=32, spp=512):
    """The reference's minstd engine makes the sensor-channel draw and
    every downstream path draw deterministic functions of the same lane
    state (an LCG is a bijection), so (channel, path events) are jointly
    lattice-distributed — correlated — while the tracer's counter-PCG
    streams are independent. This renders MirrorBox with the oracle
    twice: committed (channel from the main stream, reference-bitwise)
    vs channel+wavelength read from an INDEPENDENT stream (main stream
    still advanced twice, so all other draws are IDENTICAL). Any energy
    shift is pure channel<->path correlation — the candidate mechanism
    for the green-only +4% (channel-conditioned firefly rates)."""
    from tracer_tpu.utils.objloader import load_obj
    tris, tm, mat_rows = load_obj(os.path.join(ASSETS, "MirrorBox.obj"))
    trs = R.Tris(tris, tm)
    mats = R.Mats(mat_rows)
    lights = R.Lights(tris, tm, mats)
    w = h = size
    origin = np.asarray((0.0, 0.8, 0.9), F)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    j = jj.ravel().astype(F)
    i_flip = (F(h) - ii.ravel().astype(F) - F(1.0))
    pixel_ix = (ii.ravel() * w + jj.ravel()).astype(np.uint64)
    npix = w * h
    sums = {"committed": np.zeros((npix, 3), np.float64),
            "chdecor": np.zeros((npix, 3), np.float64)}
    for f0 in range(0, spp, 16):
        fc = min(16, spp - f0)
        st0 = np.concatenate([R.stream_states(7, f0 + k, pixel_ix)
                              for k in range(fc)])
        side = np.concatenate([R.stream_states(7 ^ 0x00C0FFEE, f0 + k,
                                               pixel_ix)
                               for k in range(fc)])
        jL = np.tile(j, fc)
        iL = np.tile(i_flip, fc)
        for mode in ("committed", "chdecor"):
            st, wl, ch = R.sample_camera_wavelength(st0)
            if mode == "chdecor":
                _, wl, ch = R.sample_camera_wavelength(side)
            o, d = R.sample_camera_ray(st, origin, w, h, jL, iL)
            st, total = R.path_trace(st, o, d, wl, trs, mats, lights)
            vals = (F(3.0) * total)[:, None] * R.SENSOR_COLOR[ch]
            sums[mode] += vals.reshape(fc, npix, 3).astype(
                np.float64).sum(axis=0)
    for cix, name in enumerate("RGB"):
        a = sums["committed"][:, cix].mean() / spp
        b = sums["chdecor"][:, cix].mean() / spp
        print(f"  {name}: committed {a:.5f}  chdecor {b:.5f}  "
              f"decor-vs-committed {(b - a) / max(a, 1e-12) * 100:+.2f}%")


# ---------------------------------------------------------------------------
# surgery: isolate the guilty material by scene modification A/Bs


def _flat_knots(v):
    return [610.0, v, 550.0, v, 460.0, v, -1.0, 0.0, -1.0, 0.0, -1.0, 0.0]


SURGERY = {
    # MirrorBox tri materials: 5 = shortBox metal (Kd .9/.6/.1 r.1 ni8),
    # 6 = tallBox diffuse white, 7 = light (Ke 30/25/22), 8 = the 12-tri
    # mirror ROOM (rough 0, ni 50). Walls 0-4 have no triangles.
    "base": lambda m: m,
    "metal5_diffuse": lambda m: _setm(m, 5, rough=1.0, metal=0.0, ni=1.0),
    "mirror_diffuse": lambda m: _setm(m, 8, rough=1.0, metal=0.0, ni=1.0,
                                      kd=_flat_knots(0.73)),
    "light_flat": lambda m: _setm(m, 7, ke=_flat_knots(25.0)),
    "metal5_flat": lambda m: _setm(m, 5, kd=_flat_knots(0.6)),
    "mirror_rough": lambda m: _setm(m, 8, rough=0.3),
}


def _setm(mats, ix, rough=None, metal=None, ni=None, kd=None, ke=None):
    m = mats.copy()
    if rough is not None:
        m[ix, 12] = rough
    if metal is not None:
        m[ix, 13] = metal
    if ni is not None:
        m[ix, 14] = ni
    if kd is not None:
        m[ix, 0:12] = kd
    if ke is not None:
        m[ix, 16:28] = ke
    return m


def cmd_surgery(size=32, spp=256, variants=None):
    import tracer_tpu as T

    from tracer_tpu.utils.objloader import load_obj
    tris, tm, mats0 = load_obj(os.path.join(ASSETS, "MirrorBox.obj"))
    origin = (0.0, 0.8, 0.9)
    for name in (variants or SURGERY):
        mats = SURGERY[name](mats0)
        mean_r, _, _ = R.render(7, size, size, spp, tris, tm, mats,
                                cam_origin=origin)
        s = T.init(0, size, size, 0, tris, tm, mats, cam_origin=origin)
        mean_j = np.asarray(T.sample_n_frames(s, spp))
        rels = [(mean_j[..., c].mean() - mean_r[..., c].mean())
                / max(mean_r[..., c].mean(), 1e-9) * 100 for c in range(3)]
        print(f"{name:16s} refRGB=({mean_r[..., 0].mean():.4f},"
              f"{mean_r[..., 1].mean():.4f},{mean_r[..., 2].mean():.4f}) "
              f"jax-vs-ref R{rels[0]:+.2f}% G{rels[1]:+.2f}% "
              f"B{rels[2]:+.2f}%", flush=True)


# ---------------------------------------------------------------------------
# depth: per-bounce energy + survival profiles on the real MirrorBox


def _oracle_depth(seed, w, h, spp, tris, tri_mats, mat_rows,
                  cam_origin=(0.0, 0.8, 0.9)):
    """Oracle render that records, per bounce: processed-hit lane count
    and per-channel energy contribution (3 * rad * sensor_color)."""
    trs = R.Tris(tris, tri_mats)
    mats = R.Mats(mat_rows)
    lights = R.Lights(tris, tri_mats, mats)
    origin = np.asarray(cam_origin, F)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    j = jj.ravel().astype(F)
    i_flip = (F(h) - ii.ravel().astype(F) - F(1.0))
    pixel_ix = (ii.ravel() * w + jj.ravel()).astype(np.uint64)
    n_eng = np.zeros((R.PATH_LEN, 3), np.float64)
    n_hit = np.zeros(R.PATH_LEN, np.int64)
    n_hit_ch = np.zeros((R.PATH_LEN, 3), np.int64)
    n_lanes = 0
    for f0 in range(0, spp, 16):
        fc = min(16, spp - f0)
        st = np.concatenate([R.stream_states(seed, f0 + k, pixel_ix)
                             for k in range(fc)])
        jL = np.tile(j, fc)
        iL = np.tile(i_flip, fc)
        st, wl, ch = R.sample_camera_wavelength(st)
        ray_o, ray_d = R.sample_camera_ray(st, origin, w, h, jL, iL)
        L = ray_o.shape[0]
        n_lanes += L
        sc = R.SENSOR_COLOR[ch]  # (L, 3)
        alive = np.ones(L, bool)
        fmax = F(np.finfo(np.float32).max)
        for bounce in range(R.PATH_LEN):
            if not alive.any():
                break
            hit, t, pos, normal, mix = R.closest_hit(ray_o, ray_d, fmax,
                                                     trs)
            act = alive & hit
            n_hit[bounce] += int(act.sum())
            for c in range(3):
                n_hit_ch[bounce, c] += int((act & (ch == c)).sum())
            st_adv, _ = R.random_unit_exclusive(st)
            st = np.where(act, st_adv, st)
            m = R.MatAtWavelen(mats, mix, wl)
            wo = -ray_d
            st_d, direct = R.direct_radiance(st, wo, pos, normal, m, wl,
                                             lights, trs)
            st = np.where(act, st_d, st)
            emis = R.spectrum_lookup(wl, mats.emission[mix])
            rad = np.where(act, direct + (emis if bounce == 0 else F(0)),
                           F(0))
            n_eng[bounce] += ((F(3.0) * rad)[:, None] * sc).sum(axis=0)
            st_s, smp = R.sample_dir(st, wo, normal, m)
            st = np.where(act, st_s, st)
            pdf = np.where(smp.kind == R.PDF_DELTA, F(1),
                           np.where(smp.kind == R.PDF_NONZERO, smp.val,
                                    F(0))).astype(F)
            cos_fall = np.abs(R.dot(normal, smp.wi))
            with np.errstate(invalid="ignore", divide="ignore",
                             over="ignore"):
                p_term = (1 - smp.bsdf * cos_fall / pdf).astype(F)
            st_t, q = R.random_unit_exclusive(st)
            st = np.where(act, st_t, st)
            terminate = (pdf == 0) | (q < p_term) | ~np.isfinite(p_term)
            alive = act & ~terminate
            o2, d2 = R.mkray_adjust_acne(pos, normal, smp.wi)
            ray_o = np.where(alive[:, None], o2, ray_o)
            ray_d = np.where(alive[:, None], d2, ray_d)
    return (n_eng / (n_lanes / 3.0), n_hit / (n_lanes / 1.0),
            n_hit_ch * 3.0 / n_lanes)


def _jax_depth(seed, size, spp, obj, cam_origin=(0.0, 0.8, 0.9)):
    import jax.numpy as jnp

    import tracer_tpu as T
    from tracer_tpu.engine import integrator

    if isinstance(obj, tuple):
        tris, tm, mats = obj
    else:
        from tracer_tpu.utils.objloader import load_obj
        tris, tm, mats = load_obj(obj)
    s = T.init(seed, size, size, 0, tris, tm, mats, cam_origin=cam_origin)
    w, h = s.sub_dims
    n_eng = np.zeros((integrator.PATH_LEN, 3), np.float64)
    n_hit = np.zeros(integrator.PATH_LEN, np.int64)
    n_lanes = 0
    import jax

    n_hit_ch = np.zeros((integrator.PATH_LEN, 3), np.int64)

    @jax.jit
    def frame(nonce):
        fs = integrator.sample_pixels(
            jnp.uint32(seed), nonce, s.scene, s.cam, s.ambience, w, h,
            s.transmitter_kind)
        sc = jnp.take(s.cam.conf.sensor_color, fs.channel, axis=0)  # (N,3)
        rad = fs.path.radiance                      # (K, N)
        eng = (3.0 * rad)[:, :, None] * sc[None]    # (K, N, 3)
        hitk = jnp.isfinite(fs.path.distance)
        hitc = jnp.stack([(hitk & (fs.channel == c)[None]).sum(axis=1)
                          for c in range(3)], axis=1)
        return eng.sum(axis=1), hitk.sum(axis=1), hitc

    for f in range(spp):
        eng, hitk, hitc = frame(jnp.uint32(f))
        n_eng += np.asarray(eng, np.float64)
        n_hit += np.asarray(hitk, np.int64)
        n_hit_ch += np.asarray(hitc, np.int64)
        n_lanes += w * h
    return (n_eng / (n_lanes / 3.0), n_hit / (n_lanes / 1.0),
            n_hit_ch * 3.0 / n_lanes)


def cmd_depth(size=32, spp=256, variant=None):
    obj = os.path.join(ASSETS, "MirrorBox.obj")
    from tracer_tpu.utils.objloader import load_obj
    tris, tm, mats = load_obj(obj)
    if variant == "allmetal":
        # every non-light surface becomes the shortBox metal: per-bounce
        # survival is then ~purely the metal RR, so a per-interaction
        # survival divergence reads off directly per channel
        for ix in (6, 8):
            mats[ix] = mats[5]
        obj = (tris, tm, mats)
    eng_r, hit_r, hch_r = _oracle_depth(7, size, size, spp, tris, tm,
                                        mats)
    eng_j, hit_j, hch_j = _jax_depth(0, size, spp, obj)
    print(f"{'bounce':>6} {'hit_ref':>9} {'hit_jax':>9} {'G_ref':>10} "
          f"{'G_jax':>10} {'dG%':>7}  per-channel survival d% (R G B)")
    for k in range(eng_r.shape[0]):
        if hit_r[k] == 0 and hit_j[k] == 0:
            break
        dg = ((eng_j[k, 1] - eng_r[k, 1])
              / max(abs(eng_r[k, 1]), 1e-9) * 100)
        # channel index c: 0 = blue sensor, 1 = green, 2 = red
        dch = [(hch_j[k, c] - hch_r[k, c])
               / max(hch_r[k, c], 1e-9) * 100 for c in (2, 1, 0)]
        print(f"{k:>6} {hit_r[k]:>9.4f} {hit_j[k]:>9.4f} "
              f"{eng_r[k, 1]:>10.5f} {eng_j[k, 1]:>10.5f} {dg:>+6.1f}%  "
              f"{dch[0]:+6.2f} {dch[1]:+6.2f} {dch[2]:+6.2f}")
    for c, name in enumerate("RGB"):
        a, b = eng_r[:, c].sum(), eng_j[:, c].sum()
        print(f"total {name}: ref {a:.5f} jax {b:.5f} "
              f"rel {(b - a) / max(a, 1e-9) * 100:+.2f}%")


# ---------------------------------------------------------------------------
# probe: single-material scenes through both full estimators


def _probe_scene(kind):
    """(tris, tri_mats, mats, cam_origin). Camera looks down -z
    (pitch = yaw = 0, the estimators' fixed probe camera)."""
    from tracer_tpu.utils.testscenes import mat_row, quad

    tris, tm = [], []

    def add(ts, m):
        tris.extend(ts)
        tm.extend([m] * len(ts))

    if kind in ("metal0", "metal03"):
        rough = 0.0 if kind == "metal0" else 0.3
        mats = np.stack([
            mat_row(kd=(0.9, 0.9, 0.9), roughness=rough, metalness=1.0,
                    ref_ix=50.0),
            mat_row(ke=(20.0, 20.0, 20.0)),
        ])
        # metal wall at z=-1 filling the view; light behind the camera
        # at z=+3 facing the wall (normal -z), visible via the reflection.
        add(quad([-4, -4, -1], [4, -4, -1], [4, 4, -1], [-4, 4, -1]), 0)
        add(quad([-1.2, 0.3, 3], [-1.2, 2.0, 3], [1.2, 2.0, 3],
                 [1.2, 0.3, 3]), 1)
        return (np.asarray(tris, F), np.asarray(tm, np.uint32), mats,
                (0.0, 0.8, 2.0))
    if kind in ("chain0", "chain03"):
        rough = 0.0 if kind == "chain0" else 0.3
        mats = np.stack([
            mat_row(kd=(0.9, 0.9, 0.9), roughness=rough, metalness=1.0,
                    ref_ix=50.0),                       # mirror wall
            mat_row(kd=(0.7, 0.7, 0.7)),                # diffuse floor
            mat_row(ke=(15.0, 15.0, 15.0)),             # ceiling light
        ])
        add(quad([-4, -1, -1], [4, -1, -1], [4, 5, -1], [-4, 5, -1]), 0)
        add(quad([-4, -1, 4], [4, -1, 4], [4, -1, -1], [-4, -1, -1]), 1)
        # ceiling light wound like cornell_like's (normal -y, downward)
        add(quad([-1, 3.5, 2.5], [-1, 3.5, 0.5], [1, 3.5, 0.5],
                 [1, 3.5, 2.5]), 2)
        return (np.asarray(tris, F), np.asarray(tm, np.uint32), mats,
                (0.0, 0.8, 2.0))
    if kind == "diffuse":
        mats = np.stack([
            mat_row(kd=(0.7, 0.7, 0.7)),
            mat_row(ke=(15.0, 15.0, 15.0)),
        ])
        add(quad([-4, -4, -1], [4, -4, -1], [4, 4, -1], [-4, 4, -1]), 0)
        add(quad([-1, 3.5, 2.5], [-1, 3.5, 0.5], [1, 3.5, 0.5],
                 [1, 3.5, 2.5]), 1)
        return (np.asarray(tris, F), np.asarray(tm, np.uint32), mats,
                (0.0, 0.8, 2.0))
    raise ValueError(kind)


def cmd_probe(size=24, ref_spp=1024, jax_spp=1024,
              kinds=("diffuse", "metal0", "metal03", "chain0", "chain03")):
    from verify.compare import zstats

    for kind in kinds:
        tris, tm, mats = _probe_scene(kind)[:3]
        origin = _probe_scene(kind)[3]
        mean_r, var_r, _ = R.render(7, size, size, ref_spp, tris, tm,
                                    mats, cam_origin=origin)

        import tracer_tpu as T
        s = T.init(0, size, size, 0, tris, tm, mats, cam_origin=origin)
        mean_j = np.asarray(T.sample_n_frames(s, jax_spp))
        st = zstats(mean_r, var_r, ref_spp, mean_j, jax_spp)
        rel = ", ".join(f"{v * 100:+.2f}%" for v in st["rel_energy"])
        print(f"{kind:8s} ref(G)={mean_r[..., 1].mean():.5f} "
              f"jax(G)={mean_j[..., 1].mean():.5f} "
              f"rel_energy=[{rel}] median|z|={st['median_abs']:.3f} "
              f"frac>5={st['frac_gt5'] * 100:.2f}%")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["terms", "rr", "probe", "depth",
                                    "reuse", "surgery", "chdecor",
                                    "rrsim", "halves", "engine",
                                    "verdict"])
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--kinds", default=None)
    a = ap.parse_args()
    if a.cmd == "terms":
        cmd_terms()
    elif a.cmd == "rr":
        cmd_rr(size=a.size or 32, spp=a.spp or 256)
    elif a.cmd == "depth":
        cmd_depth(size=a.size or 32, spp=a.spp or 256, variant=a.kinds)
    elif a.cmd == "reuse":
        cmd_reuse(size=a.size or 32, spp=a.spp or 512)
    elif a.cmd == "surgery":
        cmd_surgery(size=a.size or 32, spp=a.spp or 256,
                    variants=a.kinds.split(",") if a.kinds else None)
    elif a.cmd == "chdecor":
        cmd_chdecor(size=a.size or 32, spp=a.spp or 512)
    elif a.cmd == "rrsim":
        cmd_rrsim()
    elif a.cmd == "halves":
        cmd_halves(size=a.size or 32, spp=a.spp or 384)
    elif a.cmd == "engine":
        cmd_engine(size=a.size or 32, spp=a.spp or 384)
    elif a.cmd == "verdict":
        cmd_verdict(size=a.size or 32, spp=a.spp or 256)
    else:
        kw = {}
        if a.size:
            kw["size"] = a.size
        if a.spp:
            kw["ref_spp"] = kw["jax_spp"] = a.spp
        if a.kinds:
            kw["kinds"] = tuple(a.kinds.split(","))
        cmd_probe(**kw)
