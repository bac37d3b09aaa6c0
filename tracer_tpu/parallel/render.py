"""Multi-chip rendering: mesh + shard_map tile/sample sharding.

The reference is single-device (SURVEY.md section 2.4); the scaling
story here is the direct analogue of its embarrassingly-parallel pixel
loop: a 2-D device mesh with
  "tile"    image rows sharded across devices (each owns a stripe;
            zero cross-device traffic for the framebuffer)
  "sample"  independent 1-spp replicas of the whole frame, averaged with
            a single collective (spp-parallelism / data parallelism)
Scene, BVH and camera are replicated; the per-frame collective is one
(rows/tiles, w, 3) pmean on the sample axis.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tracer_tpu.engine import integrator
from tracer_tpu.engine.state import EngineState

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"

# Env knobs the integrator reads at TRACE time (see docs/PARITY.md).
# They must be part of every cached-executable key: lru_cache would
# otherwise freeze the first call's knob values into the executable and
# silently ignore later changes (e.g. a pool-size sweep setting
# TRACER_POOL_TARGET between calls).
# the canonical trace-knob list lives next to the knob readers
_TRACE_KNOBS = integrator.TRACE_KNOBS
_knob_key = integrator.knob_key


def make_mesh(n_tile: int, n_sample: int = 1, devices=None) -> Mesh:
    """Build a (tile, sample) mesh over the first n_tile*n_sample devices."""
    if devices is None:
        devices = jax.devices()
    n = n_tile * n_sample
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(n_tile, n_sample)
    return Mesh(dev, (TILE_AXIS, SAMPLE_AXIS))


def sharded_frame_fn(mesh: Mesh, w: int, h: int, transmitter_kind: str,
                     render_mode: str):
    """Build a function (seed, nonce, scene, cam, ambience) -> (h, w, 3)
    image, tile-sharded over rows and sample-averaged over the mesh."""
    n_tile = mesh.shape[TILE_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    if h % n_tile != 0:
        raise ValueError(f"image height {h} not divisible by tile axis "
                         f"{n_tile}")
    rows = h // n_tile

    def body(seed, nonce, scene, cam, ambience):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        row0 = ti * rows
        # distinct stream nonce per sample replica
        nonce_local = nonce * jnp.uint32(n_sample) + si.astype(jnp.uint32)
        img = integrator.render_pooled(
            seed, nonce_local, scene, cam, ambience, w, rows,
            transmitter_kind, 1, render_mode, row0=row0, full_h=h)["img"]
        # average the independent replicas
        return jax.lax.pmean(img, SAMPLE_AXIS)

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(TILE_AXIS),
        # the integrator's while_loop carries start replicated but become
        # device-varying via axis_index-derived tiles; skip the VMA check
        check_vma=False)


@lru_cache(maxsize=64)
def _pooled_exec(mesh: Mesh, w: int, h: int, rows: int, spp_local: int,
                 transmitter_kind: str, render_mode: str, knobs: tuple):
    """Cached jitted executable for render_pooled_sharded: keyed on the
    mesh + static shape/config + trace-time env knobs so repeated
    multi-chip renders reuse one traced/compiled program instead of
    retracing per call (and knob changes still take effect)."""

    def body(seed, nonce, scene, cam, ambience):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        row0 = ti * rows
        # replica si renders samples [si*spp_local, (si+1)*spp_local):
        # same streams as a single chip running spp samples in order
        nonce_local = nonce + si.astype(jnp.uint32) * jnp.uint32(spp_local)
        out = integrator.render_pooled(
            seed, nonce_local, scene, cam, ambience, w, rows,
            transmitter_kind, spp_local, render_mode,
            row0=row0, full_h=h)
        return jax.lax.pmean(out["img"], SAMPLE_AXIS)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(), P(), P(), P(), P()),
                   out_specs=P(TILE_AXIS), check_vma=False)
    return jax.jit(fn)


def render_pooled_sharded(s: EngineState, mesh: Mesh, spp: int):
    """Multi-chip pooled render: the occupancy-optimal wavefront
    (integrator.render_pooled) sharded over the mesh.

    The spp budget splits across the sample axis (spp must be divisible
    by it); image rows shard over the tile axis. One pmean merges the
    replica means. Returns the (h, w, 3) image.
    """
    w, h = s.sub_dims
    n_tile = mesh.shape[TILE_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    if h % n_tile != 0:
        raise ValueError(f"height {h} not divisible by tile axis {n_tile}")
    if spp % n_sample != 0:
        raise ValueError(f"spp {spp} not divisible by sample axis {n_sample}")
    run = _pooled_exec(mesh, w, h, h // n_tile, spp // n_sample,
                       s.transmitter_kind, s.render_mode, _knob_key())
    return run(s.seed, s.nonce, s.scene, s.cam, s.ambience)


def sample_points_sharded(s: EngineState, mesh: Mesh, spp: int):
    """Multi-chip LiDAR capture: pooled wavefront with per-pixel
    closest-return merge. Rows shard over the tile axis; the spp budget
    splits over the sample axis and replicas merge with a distance
    argmin (pmin). Returns (h, w, 4) [x, y, z, intensity]."""
    w, h = s.sub_dims
    n_tile = mesh.shape[TILE_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    if h % n_tile != 0 or spp % n_sample != 0:
        raise ValueError("h/spp not divisible by mesh axes")
    run = _points_exec(mesh, w, h, h // n_tile, spp // n_sample, spp,
                       s.transmitter_kind, s.render_mode, _knob_key())
    return run(s.seed, s.nonce, s.scene, s.cam, s.ambience)


def merge_points_newest(pos, dist, inten, si, axis=SAMPLE_AXIS):
    """Closest-return merge across sample-axis replicas: min distance
    wins, and an exact-distance tie keeps the NEWEST sample
    (lib.fut:49-51 folds `if p1.d < p2.d then p1 else p2` with p2 the
    new sample). Replica si renders samples [si*spp_local,
    (si+1)*spp_local), so the highest tied replica index supplies the
    whole point. A one-hot psum select moves exactly one replica's
    (pos, intensity) — never a coordinate-wise max of two different
    returns. Returns (pos, inten, best_d); callers mask on
    isfinite(best_d)."""
    best_d = jax.lax.pmin(dist, axis)
    mine = dist <= best_d
    win = jax.lax.pmax(jnp.where(mine, si, -1), axis)
    sel = mine & (si == win)
    pos = jax.lax.psum(jnp.where(sel, pos, 0.0), axis)
    inten = jax.lax.psum(jnp.where(sel, inten, 0.0), axis)
    return pos, inten, best_d


@lru_cache(maxsize=64)
def _points_exec(mesh: Mesh, w: int, h: int, rows: int, spp_local: int,
                 spp: int, transmitter_kind: str, render_mode: str,
                 knobs: tuple):
    """Cached jitted executable for sample_points_sharded."""
    from tracer_tpu.ops import linalg as la

    def body(seed, nonce, scene, cam, ambience):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        row0 = ti * rows
        nonce_local = nonce + si.astype(jnp.uint32) * jnp.uint32(spp_local)
        out = integrator.render_pooled(
            seed, nonce_local, scene, cam, ambience, w, rows,
            transmitter_kind, spp_local, render_mode,
            row0=row0, full_h=h, with_points=True)
        pos, dist, inten = out["points"]
        pos, inten, best_d = merge_points_newest(pos, dist, inten, si)
        has = jnp.isfinite(best_d)
        pts = jnp.concatenate(
            [la.v3_to_array(jnp.where(has, pos, -1.0)),
             jnp.where(has, inten, 0.0)[:, None]], axis=-1)
        # the per-replica intensity scale is 1/spp_local; correct to 1/spp
        pts = pts.at[:, 3].multiply(spp_local / spp)
        return pts.reshape(rows, w, 4)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(), P(), P(), P(), P()),
                   out_specs=P(TILE_AXIS), check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=64)
def _step_exec(mesh: Mesh, w: int, h: int, transmitter_kind: str,
               render_mode: str, knobs: tuple):
    """Cached jitted executable for step_sharded: repeated interactive
    multi-chip steps reuse one compiled program (no per-call retrace)."""
    frame = sharded_frame_fn(mesh, w, h, transmitter_kind, render_mode)

    @jax.jit
    def run(s: EngineState) -> EngineState:
        img_new = frame(s.seed, s.nonce, s.scene, s.cam, s.ambience)
        accum = s.mode & (s.n_frames > 0)
        if render_mode == "distance":
            merged = integrator.accumulate_distance(s.img, img_new)
        else:
            merged = integrator.accumulate_color(s.img, img_new, s.n_frames)
        img = jnp.where(accum, merged, img_new)
        n_frames = jnp.where(accum, s.n_frames + 1, jnp.uint32(1))
        return s.replace(img=img, n_frames=n_frames, nonce=s.nonce + 1)

    return run


def step_sharded(s: EngineState, mesh: Mesh) -> EngineState:
    """Full progressive step over the mesh — the multi-chip equivalent of
    api.step: one sharded 1-spp frame (x sample-axis replicas), then the
    same accumulation rule as the single-chip path."""
    w, h = s.sub_dims
    run = _step_exec(mesh, w, h, s.transmitter_kind, s.render_mode,
                     _knob_key())
    return run(s)
