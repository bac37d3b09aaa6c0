#!/usr/bin/env python
"""Measure pooled-renderer occupancy (rays / (3*P*iters)) on CPU.

Occupancy is schedule-determined (refill policy + per-sample path
lengths), so a CPU run with the production work-item structure
(m_items = n*spp/P) measures the same tail-drain loss the accelerator pays.
Iterations that run with idle lanes still pay the full query cost, so
(1 - occupancy) bounds the end-to-end win of any tail fix.

Usage: JAX_PLATFORMS=cpu python benchmarks/occupancy_probe.py \
         [--scene SpectrumSphere] [--size 64] [--spp 64] [--pool 1024]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# a CPU tool: pin the platform before JAX starts
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="SpectrumSphere")
    ap.add_argument("--origin", default="0,0.8,1.8")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--pool", type=int, default=0,
                    help="TRACER_POOL_TARGET override (0 = policy)")
    ap.add_argument("--steal", type=int, default=-1,
                    help="TRACER_STEAL_D override (-1 = default)")
    args = ap.parse_args()

    if args.pool:
        os.environ["TRACER_POOL_TARGET"] = str(args.pool)
    if args.steal >= 0:
        os.environ["TRACER_STEAL_D"] = str(args.steal)

    import tracer_tpu as T
    from tracer_tpu.engine import integrator
    from tracer_tpu.utils.objloader import load_obj

    assets = os.environ.get("TRACER_ASSETS", "/root/reference/assets")
    tris, tm, mats = load_obj(
        os.path.join(assets, args.scene + ".obj"))
    origin = tuple(float(x) for x in args.origin.split(","))
    s = T.init(0, args.size, args.size, 0, tris, tm, mats,
               cam_origin=origin)
    w, h = s.sub_dims
    n = w * h
    pool = integrator._pool_size(n, args.spp,
                                 integrator._scene_t_pad(s.scene))
    out = integrator.render_pooled(
        0, 1, s.scene, s.cam, s.ambience, w, h, s.transmitter_kind,
        args.spp, "color")
    rays = int(out["rays_traced"])
    iters = int(out["iters"])
    occ = rays / (3.0 * pool * iters)
    m_items = n * args.spp // pool
    print(f"scene={args.scene} n={n} spp={args.spp} pool={pool} "
          f"m_items={m_items} steal={integrator._steal_offsets(pool)}")
    print(f"iters={iters} rays={rays} segments/lane-slot avail="
          f"{pool * iters}")
    print(f"occupancy={occ:.4f}  (1-occ headroom: "
          f"{100 * (1 - occ):.1f}% of query time)")


if __name__ == "__main__":
    main()
