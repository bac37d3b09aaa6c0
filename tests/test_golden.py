"""Golden statistical renders + whole-pipeline accel-backend parity.

The reference's validation strategy is swapping mk_lbvh for the
brute-force mk_fake_bvh oracle (bvh.fut:25-43, SURVEY.md section 4);
here the swap runs at the full-render level: identical sample streams
through the dense intersector vs the LBVH must produce the same
image. Golden statistics pin down the Cornell render against committed
expectations (statistical, not bitwise: the bar is
pixel-distribution equivalence, SURVEY.md section 7)."""

import numpy as np
import jax.numpy as jnp
import pytest

import tracer_tpu as T
from tracer_tpu.engine import integrator
from tracer_tpu.utils import testscenes


def state_with(accel, h=32, w=32, conf=0):
    tris, tm, mats = testscenes.cornell_like()
    return T.init(0, h, w, conf, tris, tm, mats,
                  cam_origin=(0.0, 0.8, 1.8), accel=accel)


@pytest.mark.smoke
def test_dense_vs_lbvh_full_render():
    imgs = {}
    for accel in ("dense", "lbvh"):
        s = state_with(accel)
        imgs[accel] = np.asarray(T.sample_n_frames(s, 12))
    a, b = imgs["dense"], imgs["lbvh"]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    # same streams + exact intersection in both -> identical up to fp /
    # equal-t tie-breaks on shared quad edges
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    assert rmse < 2e-2, rmse
    close = np.isclose(a, b, rtol=1e-3, atol=1e-3).mean()
    assert close > 0.97, close


def test_cornell_golden_statistics():
    """Committed expectations for the 32x32 seed-0 48-frame render.
    The render is deterministic given the seed, so the tolerance only
    covers fp reassociation across scheduling/knob changes (<< 1%) —
    2% rejects any real estimator change (a wrong MIS weight, a lost
    emission term, or broken RR moves channel means by 5-30%)."""
    s = state_with("dense")
    img = np.asarray(T.sample_n_frames(s, 48))
    mean_rgb = img.mean(axis=(0, 1))
    # golden values recorded 2026-08-21 (CPU, seed 0, threefry
    # channel/wavelength draws + matched path-head jitter reuse)
    expect = np.array([0.49800, 0.39271, 0.23576])
    np.testing.assert_allclose(mean_rgb, expect, rtol=0.02)
    assert 0.5 < img.max() < 80.0
    # spatial structure: ceiling (light) row brighter than floor rows
    assert img[:6].mean() > img[-6:].mean()


def test_lidar_golden_statistics():
    s = state_with("dense", conf=2)
    s2, pts = T.sample_points_n(s, 16)
    pts = np.asarray(pts)
    returns = pts[..., 3] > 0
    # recorded 2026-08-16: ~60-95% of pixels see a return in-window
    assert 0.4 < returns.mean() <= 1.0
    d = np.linalg.norm(pts[returns][:, :3] - np.array([0, 0.8, 1.8]),
                       axis=-1)
    assert (d > 0.4).all() and (d < 10.2).all()
    assert abs(float(np.median(d)) - 2.4) < 0.8  # box walls ~1.4-3.6 away


@pytest.mark.parametrize("conf", [0, 1, 2])
def test_all_sensor_configs_render(conf):
    s = state_with("dense", conf=conf)
    img = np.asarray(T.sample_n_frames(s, 6))
    assert np.isfinite(img).all()
    assert img.max() > 0


# ---------------------------------------------------------------------------
# Committed-golden RMSE harness (BASELINE.md configs 1-4, reduced size).
# Goldens are fixed-seed CPU renders committed by benchmarks/make_goldens.py;
# the bound is far below any estimator regression (a wrong MIS weight or a
# lost emission term shifts rel-RMSE by >0.1) but above float16 storage +
# fp-reassociation noise. The reference's analogue is its single committed
# golden image (README.org:8) plus the oracle swap (bvh.fut:25-43).

import os

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
ASSETS = os.environ.get("TRACER_ASSETS", "/root/reference/assets")


_RENDER_CACHE = {}


def _golden_case(name):
    from benchmarks.make_goldens import GOLDENS, render
    path = os.path.join(GOLDEN_DIR, name + ".npz")
    if not os.path.exists(path):
        pytest.skip(f"golden {name} not generated")
    scene = GOLDENS[name][0]
    if (not scene.startswith("proc:")
            and not os.path.exists(os.path.join(ASSETS, scene + ".obj"))):
        pytest.skip("reference assets not present")
    want = np.load(path)["img"].astype(np.float32)
    if name not in _RENDER_CACHE:
        _RENDER_CACHE[name] = render(name)
    return _RENDER_CACHE[name], want


@pytest.mark.parametrize("name", ["cornell", "cornell-lidar", "mirrorbox",
                                  "spectrum", "spectrum-high", "prism"])
def test_golden_rmse(name):
    got, want = _golden_case(name)
    assert got.shape == want.shape
    scale = np.abs(want).mean() + 1e-6
    rel_rmse = float(np.sqrt(np.mean((got - want) ** 2))) / scale
    assert rel_rmse < 0.02, (name, rel_rmse)
    # per-channel energy pinned to 1%
    got_m = got.reshape(-1, got.shape[-1]).mean(axis=0)
    want_m = want.reshape(-1, want.shape[-1]).mean(axis=0)
    np.testing.assert_allclose(got_m, want_m, rtol=0.01, atol=1e-4)


def test_prism_dispersion_structure():
    """The physical signature shared with the reference's committed
    golden (README.org:8, prism-dispersion.png): per-channel intensity
    centroids ordered R -> G -> B along the dispersion axis, because
    the refractive index falls with wavelength (material.fut:38-41).
    The reference image's floor caustic measures |R->B| = 0.046 of
    width, t_G = 0.41 (benchmarks/prism_compare.band_stats); our
    committed golden pins the same physics on the fast-converging
    estimator — the light's image seen THROUGH the prism
    (prism_compare.dispersion_stats): red lands above blue, ~1.5px
    centroid separation at 128^2. The scene behind the reference image
    was never committed, so the comparison is structural, not
    pixelwise."""
    from benchmarks.prism_compare import dispersion_stats
    got, _ = _golden_case("prism")
    st = dispersion_stats(got)
    assert st is not None, "no through-prism band energy"
    assert st["ordered"], st
    # ~1.5px at 128^2 = 0.012 of height; require at least a third of it
    assert st["rb_frac"] > 0.004, st
