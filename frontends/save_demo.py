#!/usr/bin/env python
"""LiDAR batch capture — the demo-save equivalent (reference
demo-save/src/main.rs).

Defaults mirror the reference exactly: 640x480, sensor config 2 (LiDAR),
100 samples per pixel, ASCII PCD output (main.rs:12-32). The --png path
exercises the progressive visual render the reference keeps commented
out (main.rs:34-49).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from tracer_tpu.utils import compile_cache


def main():
    compile_cache.enable()
    ap = argparse.ArgumentParser(description="tracer_tpu LiDAR capture")
    ap.add_argument("-o", "--obj", default=os.path.join(
        os.environ.get("TRACER_ASSETS", "/root/reference/assets"),
        "CornellBox-Original.obj"))
    ap.add_argument("-W", "--width", type=int, default=640)
    ap.add_argument("-H", "--height", type=int, default=480)
    ap.add_argument("-s", "--spp", type=int, default=100)
    ap.add_argument("-c", "--conf", type=int, default=2)
    ap.add_argument("--out", default="dump.pcd")
    ap.add_argument("--png", default=None,
                    help="also render a --png-frames progressive image")
    ap.add_argument("--png-frames", type=int, default=64)
    args = ap.parse_args()

    import tracer_tpu as T
    from tracer_tpu.utils.objloader import load_obj
    from tracer_tpu.utils import native
    from tracer_tpu.utils.image import write_png
    from tracer_tpu.utils.pcd import write_pcd

    tris, tm, mats = load_obj(args.obj, verbose=True)
    state = T.init(0, args.height, args.width, args.conf, tris, tm, mats,
                   cam_origin=(0.0, 0.8, 1.8))

    t0 = time.time()
    state, points = T.sample_points_n(state, args.spp)
    points = np.asarray(points)
    print(f"captured {points.shape[1]}x{points.shape[0]} points "
          f"@ {args.spp} spp in {time.time() - t0:.1f}s "
          f"({(points[..., 3] > 0).mean() * 100:.1f}% returns)")

    if native.available():
        native.write_pcd(args.out, points)
    else:
        write_pcd(args.out, points)
    print(f"wrote {args.out}")

    if args.png:
        img = np.asarray(T.sample_n_frames(state, args.png_frames))
        write_png(args.png, img)
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()
