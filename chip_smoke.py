#!/usr/bin/env python
"""Smoke run of the path tracer's main path on one GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded path only

Phases (one process; the only child is nvidia-smi):
  1 device     JAX must have selected a GPU; prints the card's name and
               power limit.
  2 kernel     the fused intersection kernel against the XLA formulation
               at Precision.HIGHEST on the same card, closest and any-hit,
               coherent camera rays and incoherent bounce rays, on
               cornell_like (22 tris, 262,144 lanes) and its 4- and
               6-level subdivisions (5,632 and 90,112 tris, 65,536 lanes).
  3 headline   512x512, 256 spp, conf 0 pooled render of cornell_like;
               then 64 spp with the kernel and with the reference query,
               same seed, compared per channel and per pixel.
  4 multichunk subdivide(cornell_like, 4) at 512x512 x 16 spp.
  5 lidar      LiDAR capture at the reference's defaults: 640x480,
               100 spp, conf 2.
  6 viewer     800x600 conf 0: step -> render -> host fetch, 16 frames.
  four         render_pooled_sharded on (4,1) and (2,2) meshes and
               sample_points_sharded, each against one card.

Every phase prints its times (first call, which compiles, apart from the
steady call) and the device's peak_bytes_in_use. Any failed check exits
non-zero. The last line of stdout is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tracer_tpu as T  # noqa: E402
from benchmarks._timing import (device_info, gpu_name_and_power_limit,  # noqa: E402
                                median_time)
from tracer_tpu.engine import integrator  # noqa: E402
from tracer_tpu.models import camera as cam_mod  # noqa: E402
from tracer_tpu.ops import intersect, shapes  # noqa: E402
from tracer_tpu.ops import linalg as la  # noqa: E402
from tracer_tpu.ops import rng as prng  # noqa: E402
from tracer_tpu.ops.pallas import intersect_triton  # noqa: E402
from tracer_tpu.utils import compile_cache, testscenes  # noqa: E402

CAM = (0.0, 0.8, 1.8)


class CheckFailed(AssertionError):
    pass


def check(ok, what: str):
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise CheckFailed(what)


def report_memory(phase: str):
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  [{phase}] peak_bytes_in_use="
          f"{stats.get('peak_bytes_in_use', 'not reported')}", flush=True)


def timed(fn, *args):
    """(result, first-call seconds, steady-call seconds): the first call
    compiles, the second runs the cached executable."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, first, time.perf_counter() - t0


def scene(levels: int = 0):
    tris, tm, mats = testscenes.cornell_like()
    if levels:
        tris, tm = testscenes.subdivide(tris, tm, levels=levels)
    return tris, tm, mats


def state(h, w, conf=0, levels=0, seed=0):
    tris, tm, mats = scene(levels)
    return T.init(seed, h, w, conf, tris, tm, mats, cam_origin=CAM)


def reference_state(s):
    """s with every query answered by the XLA formulation."""
    return s.replace(scene=s.scene._replace(
        accel=intersect.reference(s.scene.accel)))


# ---------------------------------------------------------------------------
# 1 device

def phase_device():
    info = device_info()
    print(f"device: {info}", flush=True)
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX selected {info}")
    print(gpu_name_and_power_limit(), flush=True)
    return info


# ---------------------------------------------------------------------------
# 2 kernel vs reference

def camera_rays(s):
    """Jittered primary rays of s's camera, one per pixel: (o, d) V3."""
    w, h = s.sub_dims
    lane = jnp.arange(w * h, dtype=jnp.int32)
    jx = (lane % w).astype(jnp.float32)
    iy = (h - 1 - lane // w).astype(jnp.float32)
    st = prng.make_streams(s.seed, s.nonce, lane.astype(jnp.uint32))
    st, _, _ = cam_mod.sample_wavelength(st, s.cam.conf)
    _, o, d = cam_mod.sample_ray(st, s.cam, (jnp.float32(w),
                                             jnp.float32(h)), jx, iy)
    return jnp.broadcast_to(o, d.shape), d


def bounce_rays(dense, o, d, key):
    """Incoherent rays leaving the first hits in uniformly random
    directions of the normal's hemisphere (misses keep the primary)."""
    ok, _, _, pos, nrm, _ = intersect.closest_hit(
        intersect.reference(dense), shapes.F32_HIGHEST, o, d)
    wi = jax.random.normal(key, d.shape, jnp.float32)
    wi = wi / jnp.sqrt(jnp.sum(wi * wi, axis=0, keepdims=True))
    wi = jnp.where(la.v3_dot(wi, nrm)[None] < 0, -wi, wi)
    o2, d2 = shapes.mkray_adjust_acne_v(pos, nrm, wi)
    return jnp.where(ok[None], o2, o), jnp.where(ok[None], d2, d)


def compare_queries(dense, o, d, tmax_any, interpret=False, reps=5):
    """Kernel vs XLA formulation on one ray batch; returns the record."""
    phi = intersect.ray_features_t(o, d)
    far = jnp.float32(shapes.F32_HIGHEST)
    k_closest = jax.jit(lambda dn, p: intersect_triton.closest_hit(
        dn.coeffs, dn.chunk_bounds, p, far, interpret=interpret))
    k_any = jax.jit(lambda dn, p, tm: intersect_triton.any_hit(
        dn.coeffs, dn.chunk_bounds, p, tm, interpret=interpret))
    x_closest = jax.jit(lambda dn, p: intersect._closest_xla(
        dn, p, far, intersect.DEFAULT_CHUNK))
    x_any = jax.jit(lambda dn, p, tm: intersect._any_xla(
        dn, p, tm, intersect.DEFAULT_CHUNK))
    kt, ki = map(np.asarray, k_closest(dense, phi))
    xt, xi = map(np.asarray, x_closest(dense, phi))
    kh = np.asarray(k_any(dense, phi, tmax_any))
    xh = np.asarray(x_any(dense, phi, tmax_any))
    kok, xok = np.isfinite(kt), np.isfinite(xt)
    both = kok & xok
    t_ok = np.abs(kt[both] - xt[both]) <= 1e-6 + 1e-5 * np.abs(xt[both])
    idx_dis = ki[both] != xi[both]
    rec = dict(
        lanes=int(kt.size),
        hit_dis=float(np.mean(kok != xok)),
        t_bad=int(np.sum(~t_ok)),
        idx_dis=float(np.mean(idx_dis)) if both.any() else 0.0,
        any_dis=float(np.mean(kh != xh)),
        hits=int(kok.sum()))
    if reps:
        rec.update(
            kernel_closest_ms=median_time(k_closest, dense, phi,
                                          reps=reps)[0] * 1e3,
            xla_closest_ms=median_time(x_closest, dense, phi,
                                       reps=reps)[0] * 1e3,
            kernel_any_ms=median_time(k_any, dense, phi, tmax_any,
                                      reps=reps)[0] * 1e3,
            xla_any_ms=median_time(x_any, dense, phi, tmax_any,
                                   reps=reps)[0] * 1e3)
    return rec


KERNEL_CASES = ((0, 512, 512), (4, 256, 256), (6, 256, 256))


def phase_kernel(cases=KERNEL_CASES, interpret=False, reps=5):
    """Kernel vs reference per (subdivision levels, w, h) scene case."""
    records = []
    for levels, w, h in cases:
        s = state(h, w, levels=levels)
        dense = s.scene.accel
        o, d = camera_rays(s)
        key = jax.random.PRNGKey(levels)
        tmax_any = jax.random.uniform(key, (w * h,), jnp.float32, 0.05, 2.5)
        for kind in ("camera", "bounce"):
            if kind == "bounce":
                o, d = bounce_rays(dense, o, d, key)
            rec = dict(tris=int(s.scene.tris.shape[0]), rays=kind,
                       **compare_queries(dense, o, d, tmax_any,
                                         interpret=interpret, reps=reps))
            print("  kernel " + json.dumps(rec), flush=True)
            check(rec["hit_dis"] <= 1e-5,
                  f"hit-mask disagreement {rec['hit_dis']} <= 1e-5")
            check(rec["t_bad"] == 0, "t within rtol 1e-5 / atol 1e-6 on "
                  f"lanes both hit ({rec['t_bad']} outside)")
            check(rec["idx_dis"] <= 1e-3,
                  f"index disagreement {rec['idx_dis']} <= 1e-3 (ties)")
            check(rec["any_dis"] <= 1e-5,
                  f"any-hit disagreement {rec['any_dis']} <= 1e-5")
            records.append(rec)
    return records


# ---------------------------------------------------------------------------
# 3-6 renders through the entry points

def nonblack_finite(img, what: str):
    img = np.asarray(img)
    check(np.isfinite(img).all() and img.max() > 0,
          f"{what}: finite and not black (max {img.max():.4g})")


def compare_images(got, want, what: str):
    """Kernel render vs reference render, same sample streams. Counts
    pixels rather than taking a max: one grazing hit that flips changes
    one sample's whole path."""
    got, want = np.asarray(got), np.asarray(want)
    means_g = got.reshape(-1, 3).mean(0)
    means_w = want.reshape(-1, 3).mean(0)
    rel = np.abs(means_g - means_w) / np.maximum(np.abs(means_w), 1e-12)
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    print(f"  {what}: channel means {means_g} vs {means_w}, "
          f"pixels close {close.mean():.6f}", flush=True)
    check((rel <= 2e-3).all(), f"{what}: channel means within 0.2%")
    check(close.mean() >= 0.995,
          f"{what}: >= 99.5% of pixels within rtol 1e-3 / atol 1e-4")


def phase_headline(size=512, spp=256, cmp_spp=64):
    s = state(size, size)
    img, first, run = timed(T.sample_n_frames, s, spp + 1)
    print(f"  headline {size}x{size} {spp} spp: first call {first:.3f} s, "
          f"run {run:.3f} s", flush=True)
    nonblack_finite(img, "headline image")
    got, first_k, run_k = timed(T.sample_n_frames, s, cmp_spp + 1)
    want, first_x, run_x = timed(T.sample_n_frames, reference_state(s),
                                 cmp_spp + 1)
    print(f"  {cmp_spp} spp: kernel first {first_k:.3f} s run {run_k:.3f} s;"
          f" reference first {first_x:.3f} s run {run_x:.3f} s", flush=True)
    compare_images(got, want, f"{cmp_spp} spp kernel vs reference")
    return dict(run_s=run, kernel_run_s=run_k, reference_run_s=run_x)


def phase_multichunk(size=512, spp=16, levels=4):
    s = state(size, size, levels=levels)
    img, first, run = timed(T.sample_n_frames, s, spp + 1)
    print(f"  multichunk {s.scene.tris.shape[0]} tris {size}x{size} {spp} "
          f"spp: first call {first:.3f} s, run {run:.3f} s", flush=True)
    nonblack_finite(img, "multichunk image")
    return dict(run_s=run)


def phase_lidar(w=640, h=480, spp=100):
    s = state(h, w, conf=2)
    (_, pts), first, run = timed(T.sample_points_n, s, spp)
    pts = np.asarray(pts)
    check(pts.shape == (h, w, 4), f"point cloud shape {pts.shape}")
    hit = pts[..., 3] > 0
    dist = np.linalg.norm(pts[..., :3] - np.asarray(CAM), axis=-1)[hit]
    print(f"  lidar {w}x{h} {spp} spp: first call {first:.3f} s, run "
          f"{run:.3f} s, returns {hit.mean():.4f}", flush=True)
    check(hit.mean() >= 0.9, f"returns {hit.mean():.4f} >= 90%")
    check(bool(np.all((dist >= 0.5 - 1e-4) & (dist < 10.0 + 1e-4))),
          "return distances inside [0.5, 10)")
    return dict(run_s=run, returns=float(hit.mean()))


def phase_viewer(w=800, h=600, frames=16):
    s = state(h, w)
    t0 = time.perf_counter()
    s = T.step(s)
    prev = np.asarray(T.render(s))
    first = time.perf_counter() - t0
    changed = 0
    t0 = time.perf_counter()
    for _ in range(frames):
        s = T.step(s)
        fb = np.asarray(T.render(s))
        changed += int(not np.array_equal(fb, prev))
        prev = fb
    run = time.perf_counter() - t0
    print(f"  viewer {w}x{h}: first frame {first:.3f} s, {frames} frames "
          f"{run:.3f} s ({frames / run:.2f} frames/s)", flush=True)
    check((prev & 0xFFFFFF).max() > 0, "viewer frame not black")
    check(changed == frames, f"frames advance ({changed}/{frames})")
    return dict(frames_per_s=frames / run)


# ---------------------------------------------------------------------------
# four cards

def close_fraction(got, want, rtol, atol):
    return float(np.isclose(got, want, rtol=rtol, atol=atol)
                 .all(axis=-1).mean())


def phase_four(size=512, spp=64, lidar_wh=(640, 480), lidar_spp=64):
    """Sharded render and capture vs one card, same sample streams. The
    tolerances are test_parallel's, over pixels: the sharded and
    one-card programs reassociate float sums differently, which can
    flip a borderline Russian-roulette draw and change one sample's
    whole path, so >= 99.9% of pixels must match rather than all."""
    from tracer_tpu.parallel import render as par

    s = state(size, size)
    w, h = s.sub_dims
    one = jax.jit(lambda st: integrator.render_pooled(
        st.seed, st.nonce, st.scene, st.cam, st.ambience, w, h,
        st.transmitter_kind, spp, st.render_mode)["img"])
    with jax.default_device(jax.devices()[0]):
        want = np.asarray(one(s))
    out = {}
    for mesh_shape in ((4, 1), (2, 2)):
        mesh = par.make_mesh(*mesh_shape)
        got, first, run = timed(par.render_pooled_sharded, s, mesh, spp)
        frac = close_fraction(np.asarray(got), want, 1e-4, 1e-5)
        print(f"  render {mesh_shape}: first call {first:.3f} s, run "
              f"{run:.3f} s, pixels within rtol 1e-4/atol 1e-5 {frac:.6f}",
              flush=True)
        check(frac >= 0.999, f"sharded render {mesh_shape} matches one card")
        out[f"render_{mesh_shape[0]}x{mesh_shape[1]}_s"] = run
    lw, lh = lidar_wh
    sl = state(lh, lw, conf=2)
    with jax.default_device(jax.devices()[0]):
        _, want = T.sample_points_n(sl, lidar_spp)
        want = np.asarray(want)
    mesh = par.make_mesh(2, 2)
    got, first, run = timed(par.sample_points_sharded, sl, mesh, lidar_spp)
    got = np.asarray(got)
    frac_p = close_fraction(got[..., :3], want[..., :3], 1e-4, 1e-5)
    frac_i = float(np.isclose(got[..., 3], want[..., 3], rtol=1e-4,
                              atol=1e-6).mean())
    print(f"  points (2, 2): first call {first:.3f} s, run {run:.3f} s, "
          f"positions close {frac_p:.6f}, intensities close {frac_i:.6f}",
          flush=True)
    check(min(frac_p, frac_i) >= 0.999, "sharded capture matches one card")
    out["points_2x2_s"] = run
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded path only")
    args = ap.parse_args(argv)
    compile_cache.enable()
    info = phase_device()
    if args.four:
        if info["count"] < 4:
            raise SystemExit(f"--four needs 4 GPUs, JAX sees {info['count']}")
        phases = [("four", phase_four)]
    else:
        phases = [("kernel", phase_kernel), ("headline", phase_headline),
                  ("multichunk", phase_multichunk), ("lidar", phase_lidar),
                  ("viewer", phase_viewer)]
    for name, fn in phases:
        print(f"phase {name}", flush=True)
        t0 = time.perf_counter()
        fn()
        print(f"  [{name}] wall {time.perf_counter() - t0:.3f} s", flush=True)
        report_memory(name)
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main()
