"""Generate the committed golden renders for the RMSE parity harness.

The reference validates with a brute-force oracle swap plus one committed
golden image (reference src/bvh.fut:25-43, README.org:8). This repo's
quantitative analogue: fixed-seed reduced-size renders of the benchmark
scenes (BASELINE.md configs 1-4), committed as float16 arrays under
tests/goldens/ and pinned by tests/test_golden.py with an RMSE bound —
a real estimator regression (wrong MIS weight, lost emission, broken RR)
moves RMSE by far more than the bound; fp reassociation does not.

Run on CPU (the platform the test suite uses) after an intentional
estimator change, then commit the regenerated .npz files:

    python benchmarks/make_goldens.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ASSETS = os.environ.get("TRACER_ASSETS", "/root/reference/assets")
OUT = os.path.join(ROOT, "tests", "goldens")

# name -> (scene file | procedural "proc:<fn>", conf, size, frames, origin)
# Reduced-size stand-ins for BASELINE.md configs 1-4 (the full-size
# equivalents run on the GPU via benchmarks/run_all.py) plus the prism
# dispersion scenario matching the reference's committed golden
# (README.org:8; the prism scene itself is not in the reference assets,
# so it is procedural — see utils/testscenes.prism_scene).
GOLDENS = {
    "cornell": ("CornellBox-Original", 0, 64, 64, (0.0, 0.8, 1.8)),
    "cornell-lidar": ("CornellBox-Original", 2, 48, 32, (0.0, 0.8, 1.8)),
    "mirrorbox": ("MirrorBox", 0, 64, 64, (0.0, 0.8, 0.9)),
    "spectrum": ("SpectrumSphere", 0, 48, 32, (0.0, 0.8, 1.8)),
    # the orbit config's scene (BASELINE config 5, 8716 tris): pins the
    # estimator on the largest shipped asset, which the per-config
    # goldens above never touch
    "spectrum-high": ("SpectrumSphereHigh", 0, 48, 24, (0.0, 0.8, 1.8)),
    # 128^2: the through-prism dispersion band's ~1.5px R->B centroid
    # separation (prism_compare.dispersion_stats) needs the resolution
    "prism": ("proc:prism_scene", 0, 128, 64, (0.0, 0.9, 2.6)),
}


def _pin_cpu():
    """Pin JAX to the CPU. Called from main(), NOT at import time: tests
    import GOLDENS/render from this module and must not have their
    process re-platformed as a side effect. Must run before JAX starts."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")


def render(name):
    import tracer_tpu as T
    from tracer_tpu.utils.objloader import load_obj

    scene, conf, size, frames, origin = GOLDENS[name]
    if scene.startswith("proc:"):
        from tracer_tpu.utils import testscenes
        tris, tm, mats = getattr(testscenes, scene[5:])()
    else:
        tris, tm, mats = load_obj(os.path.join(ASSETS, scene + ".obj"))
    s = T.init(0, size, size, conf, tris, tm, mats, cam_origin=origin)
    if conf == 2:
        _, pts = T.sample_points_n(s, frames)
        return np.asarray(pts)
    return np.asarray(T.sample_n_frames(s, frames))


def main():
    _pin_cpu()
    os.makedirs(OUT, exist_ok=True)
    for name in GOLDENS:
        img = render(name)
        path = os.path.join(OUT, name + ".npz")
        np.savez_compressed(path, img=img.astype(np.float16))
        print(f"{name}: {img.shape} mean={img.mean():.4f} -> {path}")


if __name__ == "__main__":
    main()
