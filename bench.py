"""Headline benchmark: Mrays/s of a 512x512 Cornell-box pooled render
with next-event estimation (BASELINE.md config 2) on one GPU.

Counts the trace queries the integrator reports (closest hit plus the
two MIS shadow queries per live bounce, plus primaries) over the median
wall time of BENCH_REPS renders, each ended in block_until_ready, after
one warm-up render that compiles. Fails when JAX finds no GPU.

Prints the card's name and power limit, then one JSON line:
  {"metric": "mrays_per_sec", "value": N, "unit": "Mrays/s", ...,
   "device": {"platform", "kind", "count"}}

Env: BENCH_SIZE (512), BENCH_SPP (256), BENCH_REPS (3).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from benchmarks._timing import (gpu_name_and_power_limit, peaks,  # noqa: E402
                                render_fn, require_gpu)


def build_state(size):
    import tracer_tpu as T
    from tracer_tpu.utils.testscenes import cornell_like

    tris, tm, mats = cornell_like()
    return T.init(0, size, size, 0, tris, tm, mats,
                  cam_origin=(0.0, 0.8, 1.8))


def main():
    from tracer_tpu.utils import compile_cache
    compile_cache.enable()
    device = require_gpu()
    print(gpu_name_and_power_limit(), flush=True)

    size = int(os.environ.get("BENCH_SIZE", "512"))
    spp = int(os.environ.get("BENCH_SPP", "256"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    s = build_state(size)
    render = render_fn(s, spp)

    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(render(np.uint32(0)))
    compile_s = time.perf_counter() - t0
    times, rays, means = [], [], []
    for k in range(reps):
        t0 = time.perf_counter()
        img, n_rays = jax.block_until_ready(render(np.uint32(1 + k * spp)))
        times.append(time.perf_counter() - t0)
        rays.append(float(n_rays))
        means.append(float(np.mean(np.asarray(img))))
    mid = int(np.argsort(times)[len(times) // 2])
    mrays = rays[mid] / times[mid] / 1e6
    if not (np.isfinite(means).all() and min(means) > 0):
        raise SystemExit(f"bench: image means {means} not finite/positive")
    print(json.dumps({
        "metric": "mrays_per_sec",
        "value": mrays,
        "unit": "Mrays/s",
        "size": size, "spp": spp, "reps_s": times,
        "first_call_s": compile_s,
        "peaks": peaks(device["kind"]),
        "device": device,
    }))


if __name__ == "__main__":
    main()
