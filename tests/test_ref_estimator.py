"""Parity against an INDEPENDENT transliteration of the reference
estimator.

Every other parity leg (dense == LBVH == brute-force == Pallas, the
committed rel-RMSE goldens) shares the JAX estimator code, so a shared
misreading of integrator.fut / direct.fut / material.fut semantics
would be invisible to all of them. verify/ref_estimator_numpy.py is a
separate, line-by-line numpy reading of the Futhark sources (bitwise
minstd_rand engine, same f32 math) that shares only the OBJ loader —
which is itself pinned Python==C++ by tests/test_loader.py.

The comparison is statistical (the RNG stream assignment is the one
documented deviation), and SELF-CALIBRATING: each committed golden
carries a second, same-estimator render at a different seed ("control
probe") with exactly the test's statistical structure — 256-spp mean
probe vs 512-spp golden, z-denominator from the golden's sample
variance only. Per-pixel MC distributions are heavy-tailed (fireflies
the golden missed inflate z one-sidedly), so the null is NOT N(0,1);
the control probe measures the real null. The tracer must not look
farther from the reference transliteration than the transliteration is
from itself.

Three scenes pin three different estimator regions:
  cornell    diffuse + NEE/MIS + RR (integrator.fut:27-76,
             direct.fut:63-122)
  mirrorbox  metal/mirror lobes, deep specular paths
             (material.fut:346-355)
  prism      refraction + the ref_ix dispersion hack + caustics
             (material.fut:38-41, :166-183)

chi2/dof is only meaningful on cornell: specular scenes have many
DETERMINISTIC pixels (a mirror path hits the same emitter whatever the
jitter), whose golden-side sample variance is exactly 0 — any nonzero
mean difference there divides by the epsilon floor and chi2 becomes a
1/eps^2 lottery (control and tracer both land at 1e16..1e19). The
distribution-bulk stats (median |z|, frac |z|>5) and clipped energy
stay well-behaved and control-calibrated on all scenes.

Measured at the committed goldens (2026-08-19, numpy seed 7 vs seed 0
control — jax seed 0 vs numpy seed 0 test):
  cornell   ctrl: chi2 1.73, median 0.698, frac>5 0.60%
            test: chi2 1.69, median 0.703, frac>5 0.56%
  mirrorbox ctrl: median 0.738, frac>5 10.7%   (32x32 probe run)
            test: median 0.726, frac>5 10.6%
  prism     ctrl: median 0.711, frac>5  3.8%
            test: median 0.708, frac>5  3.7%
An estimator bug moves these by far more: a wrong MIS weight or a lost
emission term shifts whole-pixel populations by multiples of their SE
(median/frac blow past the bands) and the clipped per-channel energy
by >5%.

Null-calibration caveat (round-4 postmortem, docs/PARITY.md "mirrorbox
investigation"): a SINGLE control probe can badly underestimate the
clipped-energy null — the committed mirrorbox control realized dG
0.196% while the measured same-estimator family sd is ~0.9% (G) and
2.5-3% (R/B) at this size/spp. The per-scene absolute floors (0.02 /
0.04) are therefore the effective bound on specular scenes; they sit
at ~4 sigma of the measured family null. The round-3 red mirrorbox
(+5.29% G) was a REAL defect this test caught correctly: the chained
channel-select draw was correlated with downstream path draws
(fixed via ops/rng.py salted_pair; post-fix seed-0 dG = -1.2%).
"""

import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
ASSETS = os.environ.get("TRACER_ASSETS", "/root/reference/assets")

JAX_SPP = 256


@pytest.mark.smoke
def test_smoke_micro_energy_parity():
    """Fast tier: a 16x16 procedural-Cornell render through BOTH
    estimators (numpy oracle live, no committed golden) must agree on
    per-channel energy within generous MC noise. Catches gross
    estimator breakage (lost emission, broken RR/NEE wiring) in
    seconds; the full statistical pin is the golden-based tests."""
    from verify.compare import render_tracer
    from verify.ref_estimator_numpy import render as ref_render
    from tracer_tpu.utils import testscenes

    tris, tm, mats = testscenes.cornell_like()
    mean_r, _, _ = ref_render(0, 16, 16, 24, tris, tm, mats,
                              cam_origin=(0.0, 0.8, 1.8))
    mean_j = render_tracer(16, 48, seed=0, obj="proc:cornell_like")
    assert np.isfinite(mean_j).all() and np.isfinite(mean_r).all()
    for c in range(3):
        a, b = mean_r[..., c].mean(), mean_j[..., c].mean()
        assert abs(b - a) / max(a, 1e-6) < 0.15, (c, a, b)

# scene -> (golden file, obj spec for render_tracer, chi2 meaningful,
#           clipped-energy floor)
SCENES = {
    "cornell": ("ref_numpy_cornell64.npz",
                os.path.join(ASSETS, "CornellBox-Original.obj"),
                True, 0.02),
    "mirrorbox": ("ref_numpy_mirrorbox32.npz",
                  os.path.join(ASSETS, "MirrorBox.obj"), False, 0.04),
    "prism": ("ref_numpy_prism32.npz", "proc:prism_scene", False, 0.04),
}


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    name = request.param
    fname, obj, chi2_ok, energy_floor = SCENES[name]
    path = os.path.join(GOLDEN_DIR, fname)
    if not os.path.exists(path):
        pytest.skip(f"independent-estimator golden {fname} not generated")
    if not obj.startswith("proc:") and not os.path.exists(obj):
        pytest.skip("reference assets not present")
    golden = np.load(path)

    from verify.compare import render_tracer, zstats
    mean, var, spp = golden["mean"], golden["var"], int(golden["spp"])
    ctrl = zstats(mean, var, spp, golden["mean_ctrl"],
                  int(golden["spp_ctrl"]))
    origin = (tuple(golden["origin"]) if "origin" in golden.files
              else (0.0, 0.8, 1.8))
    mj = render_tracer(int(golden["size"]), JAX_SPP, seed=0, obj=obj,
                       cam_origin=origin)
    test = zstats(mean, var, spp, mj, JAX_SPP)
    return dict(name=name, ctrl=ctrl, test=test, mean=mean, mj=mj,
                mean_ctrl=golden["mean_ctrl"], chi2_ok=chi2_ok,
                energy_floor=energy_floor)


def test_golden_control_is_sane(case):
    """The committed control probe must itself sit at the expected
    null — guards against a corrupted/regenerated-wrong golden."""
    ctrl = case["ctrl"]
    assert 0.55 < ctrl["median_abs"] < 0.85, ctrl
    assert ctrl["frac_gt5"] < 0.15, ctrl
    if case["chi2_ok"]:
        assert ctrl["chi2_dof"] < 3.0, ctrl
        assert ctrl["frac_gt5"] < 0.02, ctrl


def test_tracer_matches_independent_reference(case):
    """tracer_tpu must be no farther from the independent numpy
    transliteration than the transliteration is from itself."""
    ctrl, test = case["ctrl"], case["test"]
    # bulk of the distribution: median |z| at the null value
    assert 0.55 < test["median_abs"] < 0.85, (test, ctrl)
    # tails no heavier than the same-estimator control (x2 slack for
    # the control's own sampling noise) plus absolute backstops
    assert test["frac_gt5"] < max(2.0 * ctrl["frac_gt5"], 2e-3), (test,
                                                                  ctrl)
    if case["chi2_ok"]:
        assert test["chi2_dof"] < max(1.5 * ctrl["chi2_dof"], 3.0), (
            test, ctrl)


def _clipped_energy_diff(a_img, b_img, c):
    a, b = a_img[..., c].ravel(), b_img[..., c].ravel()
    hi = np.quantile(np.concatenate([a, b]), 0.99)
    am, bm = a.clip(0, hi).mean(), b.clip(0, hi).mean()
    return abs(bm - am) / am, am, bm


def test_mirrorbox_family_energy_pin():
    """Standing multi-seed pin of the round-4 channel/path
    decorrelation fix (docs/PARITY.md "mirrorbox investigation").

    The round-3 defect — the chained channel-select draw correlated
    with downstream path draws — showed up as a green-channel energy
    excess across EVERY seed (unclipped dG family at seeds 0-4:
    {+5.46, +2.86, +1.83, +2.11, +3.54}%, mean +3.16%), while a single
    seed sat inside the 4% single-probe bound for two rounds. The fix
    (bit-exact Threefry-2x32 salted draws, ops/rng.py) brought the
    family mean to +1.76%, inside the measured minstd-oracle null
    (+0.58 +- 0.9%). This test renders the SAME five-seed family and
    bounds the FAMILY mean, so a future stream/layout change that
    re-correlates channel and path draws fails here instead of waiting
    for a multi-seed audit. Seeds and spp are fixed, so the family
    mean is deterministic up to XLA fusion noise (~0.1% via flipped
    borderline Russian-roulette draws); the +2.6% bound sits between
    the fixed (+1.76) and broken (+3.16) family means with margin for
    that noise."""
    fname, obj, _, _ = SCENES["mirrorbox"]
    path = os.path.join(GOLDEN_DIR, fname)
    if not os.path.exists(path):
        pytest.skip(f"independent-estimator golden {fname} not generated")
    if not os.path.exists(obj):
        pytest.skip("reference assets not present")
    golden = np.load(path)
    from verify.compare import render_tracer
    size = int(golden["size"])
    origin = (tuple(golden["origin"]) if "origin" in golden.files
              else (0.0, 0.8, 1.8))
    ref_g = float(np.asarray(golden["mean"], np.float64)[..., 1].mean())
    dgs = []
    for seed in range(5):
        mj = render_tracer(size, JAX_SPP, seed=seed, obj=obj,
                           cam_origin=origin)
        dgs.append(100.0 * (float(mj[..., 1].mean()) - ref_g) / ref_g)
    fam = float(np.mean(dgs))
    assert -1.5 < fam < 2.6, (fam, dgs)


def test_energy_matches_independent_reference(case):
    """Per-channel image energy (firefly-clipped at the joint 99th
    percentile so one lucky path can't dominate a small render) pins
    global throughput — RR weighting, NEE normalization, the
    x n_channels visualize factor (integrator.fut:165-170). The bound
    is control-calibrated (caustic scenes are energy-noisy even
    clipped) with a per-scene absolute floor."""
    mr, mj, mc = case["mean"], case["mj"], case["mean_ctrl"]
    for c in range(3):
        d_test, am, bm = _clipped_energy_diff(mr, mj, c)
        d_ctrl, _, _ = _clipped_energy_diff(mr, mc, c)
        bound = max(2.0 * d_ctrl, case["energy_floor"])
        assert d_test < bound, (case["name"], c, am, bm, d_test, d_ctrl)
