"""Regenerate the README render artifacts under docs/.

Currently only the prism dispersion image needs periodic regeneration
(its scene, utils/testscenes.prism_scene, is tuned alongside the golden
statistic); the Cornell/LiDAR images depend only on the reference
assets and the estimator, which are pinned by the golden RMSE harness.

    python benchmarks/render_doc_images.py [--spp 256] [--size 256]

Runs on whatever platform JAX resolves (JAX_PLATFORMS=cpu works for a
slow local render).
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default=os.path.join(ROOT, "docs",
                                                  "prism-dispersion.png"))
    args = ap.parse_args()

    import tracer_tpu as T
    from tracer_tpu.utils import testscenes
    from tracer_tpu.utils.image import write_png

    tris, tm, mats = testscenes.prism_scene()
    s = T.init(0, args.size, args.size, 0, tris, tm, mats,
               cam_origin=(0.0, 0.9, 2.6))
    img = np.asarray(T.sample_n_frames(s, args.spp))
    write_png(args.out, img)
    from benchmarks.prism_compare import dispersion_stats
    print(f"wrote {args.out} ({args.size}^2, {args.spp} spp)")
    print(dispersion_stats(img))


if __name__ == "__main__":
    main()
