#!/usr/bin/env python
"""Fused intersection kernel vs the XLA formulation, on one GPU.

    python benchmarks/intersect_ab.py [--sweep] [--e2e]

Query level: closest and any-hit on chip_smoke's kernel cases (camera
and bounce rays), median of 5 warm reps, each ended in
block_until_ready. --sweep repeats the kernel side for each launch
configuration (rays per block, triangles per chunk, warps) in SWEEP.
--e2e times one pooled render per scene with the kernel and with the
reference query (median of 3). Prints the card's name and power limit,
then one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

import chip_smoke as cs  # noqa: E402
from benchmarks._timing import (gpu_name_and_power_limit, median_time,  # noqa: E402
                                render_fn, require_gpu)
from tracer_tpu.ops import intersect  # noqa: E402
from tracer_tpu.ops.pallas import intersect_triton as kt  # noqa: E402
from tracer_tpu.utils import compile_cache  # noqa: E402

# (rays per block, triangles per chunk, warps, pipeline stages)
SWEEP = ((32, 16, 1, 2), (16, 16, 1, 2), (32, 32, 1, 2), (32, 8, 1, 2),
         (64, 16, 2, 2), (32, 16, 1, 1), (32, 16, 1, 3))
# (subdivision levels, size, spp) of the end-to-end renders
E2E = ((0, 512, 64), (4, 512, 16), (6, 256, 16))


def queries(configs):
    for levels, w, h in cs.KERNEL_CASES:
        s = cs.state(h, w, levels=levels)
        tris = s.scene.tris
        key = jax.random.PRNGKey(levels)
        tmax_any = jax.random.uniform(key, (w * h,), minval=0.05, maxval=2.5)
        o, d = cs.camera_rays(s)
        rays = {"camera": (o, d),
                "bounce": cs.bounce_rays(s.scene.accel, o, d, key)}
        for block, chunk, warps, stages in configs:
            kt.BLOCK, kt.NUM_WARPS, kt.NUM_STAGES = block, warps, stages
            dense = intersect.build_dense(tris, pad_to=chunk)
            for kind, (ro, rd) in rays.items():
                rec = cs.compare_queries(dense, ro, rd, tmax_any)
                print(json.dumps(dict(tris=int(tris.shape[0]), rays=kind,
                                      block=block, chunk=chunk, warps=warps,
                                      stages=stages, **rec)), flush=True)


def end_to_end():
    for levels, size, spp in E2E:
        s = cs.state(size, size, levels=levels)
        rec = dict(tris=int(s.scene.tris.shape[0]), size=size, spp=spp)
        for name, st in (("kernel", s), ("xla", cs.reference_state(s))):
            render = render_fn(st, spp)
            t, reps = median_time(render, np.uint32(1), reps=3)
            rays = float(render(np.uint32(1))[1])
            rec[f"{name}_s"], rec[f"{name}_reps_s"] = t, reps
            rec[f"{name}_mrays_per_s"] = rays / t / 1e6
        print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()
    compile_cache.enable()
    print(json.dumps(require_gpu()))
    print(gpu_name_and_power_limit(), flush=True)
    queries(SWEEP if args.sweep else
            ((kt.BLOCK, intersect.CHUNK, kt.NUM_WARPS, kt.NUM_STAGES),))
    if args.e2e:
        end_to_end()


if __name__ == "__main__":
    main()
