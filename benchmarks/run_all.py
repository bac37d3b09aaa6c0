#!/usr/bin/env python
"""The seven BASELINE.md benchmark configs, each in a crash-isolated
subprocess, emitting one JSON line per config (and BENCH_ALL.json).

  1 cornell-4spp    CornellBox 256x256, 4 spp (parity smoke config)
  2 cornell-256spp  CornellBox 512x512, 256 spp progressive + NEE
                    (the headline metric; same path as bench.py)
  3 mirrorbox       MirrorBox 512x512 (pure specular, deep paths,
                    occupancy stress — rendered from inside the box)
  4 spectrum        SpectrumSphere 512x512 spectral (hero-wavelength
                    dispersion, prism caustics)
  5 orbit           SpectrumSphereHigh interactive orbit: per-frame
                    LBVH rebuild + progressive loop
  6 bigscene        SpectrumSphereHigh subdivided x2 (~139k tris)
                    512x512 16 spp — the culling intersector at scale
  7 interactive     the reference viewer loop at its default operating
                    point: 800x600 CornellBox conf 0, step -> render ->
                    ARGB host fetch per frame (liblys.c:18-19, :104-123)

Each result names the device it ran on; a worker that finds no GPU
fails. Scenes load from the reference's .obj assets (TRACER_ASSETS).

Usage: python benchmarks/run_all.py [--configs 1,2,3] [--quick]
       [--out BENCH_ALL.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, {root!r})
import numpy as np
from tracer_tpu.utils import compile_cache
compile_cache.enable()
from benchmarks._timing import median_time, render_fn, require_gpu
device = require_gpu()
import jax
import tracer_tpu as T
from tracer_tpu.utils.objloader import load_obj
from tracer_tpu.ops import bvh as bvh_mod

cfg = {cfg!r}
assets = os.environ.get("TRACER_ASSETS", "/root/reference/assets")
tris, tm, mats = load_obj(os.path.join(assets, cfg["scene"] + ".obj"))
if cfg.get("subdiv"):
    # big-scene config: midpoint-subdivide the largest shipped asset
    # (8,716 -> ~139k tris at 2 levels)
    from tracer_tpu.utils import testscenes
    tris, tm = testscenes.subdivide(tris, tm, levels=cfg["subdiv"])
origin = tuple(cfg.get("origin", (0.0, 0.8, 1.8)))
h, w = cfg.get("size_h", cfg.get("size")), cfg.get("size_w", cfg.get("size"))
s = T.init(0, h, w, cfg.get("conf", 0), tris, tm, mats, cam_origin=origin)

if cfg.get("interactive"):
    # The reference's viewer loop at its default operating point:
    # step -> render -> ARGB framebuffer download per frame
    # (demo-interactive/liblys.c:18-19, :104-123).
    s = T.step(s)                       # compile step (untimed)
    fb = np.asarray(T.render(s))        # compile render + first fetch
    frames = cfg["frames"]
    t0 = time.perf_counter()
    for k in range(frames):
        s = T.step(s)
        fb = np.asarray(T.render(s))    # per-frame ARGB download
    dt = time.perf_counter() - t0
    if not (fb != 0).any():
        sys.exit("interactive framebuffer black; refusing")
    if np.array_equal(fb, np.asarray(T.render(T.step(s)))):
        sys.exit("interactive loop not advancing; refusing")
    out = dict(metric="interactive_fps", value=frames / dt,
               unit="frames/s", config=cfg["name"])
elif cfg.get("orbit"):
    import jax.numpy as jnp
    from tracer_tpu.ops import intersect
    from tracer_tpu.engine.api import _step_core
    # interactive orbit: per-frame acceleration-structure rebuild +
    # 1-spp progressive frame in ONE dispatch; the camera revolves
    # around the scene's vertical axis at its starting radius, facing
    # inward (cam_dir = (sin yaw, sin pitch, -cos yaw)), so every frame
    # sees the scene. The LBVH build is timed separately for the
    # reference's per-frame-LBVH-rebuild scenario.
    orbit_r = float(np.hypot(origin[0], origin[2]))

    @jax.jit
    def orbit_frame(st):
        accel = intersect.build_dense(
            st.scene.tris, aux=st.scene.mat_ix.astype(jnp.float32))
        yaw = jnp.mod(st.cam.yaw + 0.05, jnp.float32(2.0 * np.pi))
        cam_o = jnp.stack([-orbit_r * jnp.sin(yaw), st.cam.origin[1],
                           orbit_r * jnp.cos(yaw)])
        st = st.replace(scene=st.scene._replace(accel=accel),
                        cam=st.cam._replace(yaw=yaw, origin=cam_o))
        return _step_core(st)

    st = jax.block_until_ready(orbit_frame(s))          # compile
    frames = cfg["frames"]
    t0 = time.perf_counter()
    for k in range(frames):
        st = orbit_frame(st)
    jax.block_until_ready(st)
    dt = time.perf_counter() - t0
    a = np.asarray(st.img)
    if np.array_equal(a, np.asarray(orbit_frame(st).img)):
        sys.exit("orbit frames identical - loop not advancing; refusing")
    if not (np.isfinite(a).all() and a.max() > 0):
        sys.exit("orbit frame black/non-finite; refusing")
    lbvh_s, _ = median_time(jax.jit(bvh_mod.build), s.scene.tris)
    out = dict(metric="orbit_fps", value=frames / dt, unit="frames/s",
               config=cfg["name"], lbvh_build_ms=lbvh_s * 1e3)
else:
    spp = cfg["spp"]
    render = render_fn(s, spp)
    jax.block_until_ready(render(np.uint32(0)))          # compile
    times, rays, means = [], [], []
    for k in range(cfg.get("reps", 3)):
        t0 = time.perf_counter()
        img, n = jax.block_until_ready(render(np.uint32(1 + k * spp)))
        times.append(time.perf_counter() - t0)
        rays.append(float(n))
        means.append(float(np.mean(np.asarray(img))))
    mid = int(np.argsort(times)[len(times) // 2])
    if not (np.isfinite(means).all() and min(means) > 0):
        sys.exit("image means %r not finite/positive; refusing" % means)
    out = dict(metric="mrays_per_sec", value=rays[mid] / times[mid] / 1e6,
               unit="Mrays/s", config=cfg["name"], spp=spp,
               img_mean=means[mid], reps_s=times,
               samples_per_sec=w * h * spp / times[mid])
out["device"] = device
print("BENCH_RESULT " + json.dumps(out))
"""

CONFIGS = {
    1: dict(name="cornell-4spp", scene="CornellBox-Original", size=256,
            spp=4),
    2: dict(name="cornell-256spp", scene="CornellBox-Original", size=512,
            spp=256),
    3: dict(name="mirrorbox", scene="MirrorBox", size=512, spp=64,
            origin=(0.0, 0.8, 0.9)),
    4: dict(name="spectrum", scene="SpectrumSphere", size=512, spp=64),
    5: dict(name="orbit", scene="SpectrumSphereHigh", size=1024,
            orbit=True, frames=32),
    6: dict(name="bigscene", scene="SpectrumSphereHigh", size=512,
            spp=16, subdiv=2, reps=2),
    7: dict(name="interactive", scene="CornellBox-Original",
            size_w=800, size_h=600, interactive=True, frames=64),
}

QUICK_OVERRIDES = {1: {}, 2: dict(spp=32), 3: dict(size=256, spp=16),
                   4: dict(size=256, spp=16), 5: dict(size=256, frames=4),
                   6: dict(size=256, spp=4, reps=1),
                   7: dict(size_w=320, size_h=240, frames=8)}


def main():
    ap = argparse.ArgumentParser()
    # every BASELINE config by default so none silently goes stale in
    # the output file
    ap.add_argument("--configs", default="1,2,3,4,5,6,7")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--out", default=os.path.join(ROOT, "BENCH_ALL.json"))
    args = ap.parse_args()

    results = []
    for cid in [int(c) for c in args.configs.split(",")]:
        cfg = dict(CONFIGS[cid])
        if args.quick:
            cfg.update(QUICK_OVERRIDES.get(cid, {}))
        code = _WORKER.format(root=ROOT, cfg=cfg)
        try:
            proc = subprocess.run([sys.executable, "-c", code],
                                  capture_output=True, text=True,
                                  timeout=args.timeout)
            line = next((l for l in proc.stdout.splitlines()
                         if l.startswith("BENCH_RESULT ")), None)
            if line:
                res = json.loads(line[len("BENCH_RESULT "):])
            else:
                res = dict(config=cfg["name"], error="no result",
                           stderr=proc.stderr[-400:])
        except subprocess.TimeoutExpired:
            res = dict(config=cfg["name"], error="timeout")
        results.append(res)
        print(json.dumps(res), flush=True)

    # merge into the existing file so partial runs don't clobber other
    # configs' results
    old = []
    try:
        with open(args.out) as f:
            old = json.load(f)
    except (OSError, ValueError):
        pass
    with open(args.out, "w") as f:
        json.dump(merge_results(old, results), f, indent=2)


def merge_results(old: list, new: list) -> list:
    """Config-keyed merge of bench records. A new error record never
    clobbers a stored good measurement — the good record is kept with a
    `last_error` annotation instead."""
    merged = {}
    for r in old:
        merged[r.get("config")] = r
    for r in new:
        prev = merged.get(r.get("config"))
        if "error" in r and prev is not None and "error" not in prev:
            prev = dict(prev)
            prev["last_error"] = r["error"]
            merged[r.get("config")] = prev
        else:
            merged[r.get("config")] = r
    order = [c["name"] for c in CONFIGS.values()]
    return sorted(merged.values(),
                  key=lambda r: order.index(r["config"])
                  if r.get("config") in order else 99)


if __name__ == "__main__":
    main()
