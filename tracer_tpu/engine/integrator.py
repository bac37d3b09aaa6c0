"""Wavefront path integrator (replaces integrator.fut).

The reference's megakernel — one thread running the full bounce loop per
pixel (integrator.fut:27-76, :103-116) — becomes a batched wavefront: a
flat pool of N = w*h lanes advances one bounce per iteration of a single
lax.while_loop. Each iteration batches one closest-hit query, one NEE+MIS
direct-lighting estimate (two any_hit shadow queries) and one BSDF sample
across the entire pool, keeping the device busy; finished lanes are
masked and the loop exits early once every lane is dead
(SURVEY.md section 7.6).

Layout: rays are V3 = (3, N) transposed vectors and per-bounce records
are (PATH_LEN, N) — lanes always live on the minor axis, so per-bounce
writes and per-path reductions are major-axis ops.

Estimator semantics preserved exactly (SURVEY.md "estimator fidelity"):
one hero wavelength + one channel per camera sample, emission added only
at the first bounce, ambience on miss, unit-weight Russian roulette
(p_terminate = 1 - bsdf*cos/pdf so surviving samples carry weight 1,
integrator.fut:62-69), per-bounce (distance, radiance) records of length
16 for the LiDAR return pipeline.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from tracer_tpu.models import camera as cam_mod
from tracer_tpu.models import scene as scene_mod
from tracer_tpu.ops import linalg as la
from tracer_tpu.ops import materials, shapes
from tracer_tpu.ops import rng as prng
from tracer_tpu.ops import spectrum as spec
from tracer_tpu.engine import direct as direct_mod

PATH_LEN = 16  # max path length (integrator.fut:23)

# LiDAR return distance window (lib.fut:40, integrator.fut:153)
LIDAR_MIN_D = 0.5
LIDAR_MAX_D = 10.0


class PathRecords(NamedTuple):
    """Per-bounce records, transposed — `path` in integrator.fut:25."""
    distance: jax.Array   # (PATH_LEN, N) cumulative distance, +inf dark
    radiance: jax.Array   # (PATH_LEN, N)


class FrameSamples(NamedTuple):
    """Everything sample_pixels produces for one 1-spp wavefront."""
    ray_origin: jax.Array  # (3, N) primary ray
    ray_dir: jax.Array     # (3, N)
    channel: jax.Array     # (N,) int32 sensor channel of the hero sample
    path: PathRecords
    rays_traced: jax.Array  # scalar int32: total trace queries (bench)


def path_trace(state, scene: scene_mod.Scene, origin, d, wavelen,
               ambience, transmitter_kind: str,
               trans_sectors, trans_theta,
               trans_emission) -> tuple[jax.Array, PathRecords, jax.Array]:
    """Trace the whole lane pool through <= PATH_LEN bounces
    (path_trace, integrator.fut:27-76). Rays are V3 (3, N). Returns
    (rng_state, PathRecords, rays_traced)."""
    n = d.shape[-1]
    ambience = jnp.asarray(ambience, jnp.float32)
    ambient = spec.lookup_pairs(
        wavelen, [(ambience[k, 0], ambience[k, 1]) for k in range(6)])
    ambient = jnp.broadcast_to(ambient, (n,))

    init = dict(
        rng=state,
        o=jnp.broadcast_to(origin, (3, n)), d=d,
        alive=jnp.ones((n,), bool),
        cum_dist=jnp.zeros((n,), jnp.float32),
        dist=jnp.full((PATH_LEN, n), jnp.inf, jnp.float32),
        rad=jnp.zeros((PATH_LEN, n), jnp.float32),
        i=jnp.int32(0),
        rays=jnp.int32(0),
    )

    def cond(c):
        return (c["i"] < PATH_LEN) & jnp.any(c["alive"])

    def body(c):
        alive = c["alive"]
        inter = scene_mod.closest_interaction(
            scene, shapes.F32_HIGHEST, c["o"], c["d"], wavelen)
        hit = alive & inter.ok
        miss = alive & ~inter.ok

        # Hit: NEE direct light + first-bounce emission
        # (integrator.fut:46-55).
        wo = -c["d"]
        rng, direct = direct_mod.direct_radiance(
            c["rng"], scene, wo, inter, wavelen, trans_sectors,
            transmitter_kind, trans_theta, trans_emission, mask=hit)
        emitted = jnp.where(c["i"] == 0, inter.emission_at_wl, 0.0)
        radiance = direct + emitted
        cum_dist = jnp.where(hit, c["cum_dist"] + inter.t, c["cum_dist"])

        # one (1, N) row write per bounce: hit -> (cum_dist, radiance),
        # miss -> (inf, ambience) (integrator.fut:55, :76)
        row_dist = jnp.where(hit, cum_dist, jnp.inf)
        row_rad = jnp.where(hit, radiance, jnp.where(miss, ambient, 0.0))
        dist = jax.lax.dynamic_update_index_in_dim(
            c["dist"], row_dist, c["i"], 0)
        rad = jax.lax.dynamic_update_index_in_dim(
            c["rad"], row_rad, c["i"], 0)

        # BSDF bounce + unit-weight Russian roulette
        # (integrator.fut:56-75).
        rng, wi, bsdf, pdf_val, pdf_kind = materials.sample_dir(
            rng, wo, inter.normal, inter.mat)
        pdf = jnp.where(pdf_kind == materials.PDF_DELTA, 1.0,
                        jnp.where(pdf_kind == materials.PDF_NONZERO,
                                  pdf_val, 0.0))
        cos_falloff = jnp.abs(la.v3_dot(inter.normal, wi))
        p_terminate = 1.0 - bsdf * cos_falloff / pdf
        rng, u = prng.next_unit(rng)
        terminate = u < p_terminate
        alive_next = hit & (pdf != 0) & ~terminate

        o_new, d_new = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi)
        o = jnp.where(alive_next, o_new, c["o"])
        dnew = jnp.where(alive_next, d_new, c["d"])

        # 1 closest + 2 shadow queries per live lane this bounce.
        rays = c["rays"] + 3 * jnp.sum(alive).astype(jnp.int32)
        return dict(rng=rng, o=o, d=dnew, alive=alive_next,
                    cum_dist=cum_dist, dist=dist, rad=rad,
                    i=c["i"] + 1, rays=rays)

    out = jax.lax.while_loop(cond, body, init)
    return (out["rng"],
            PathRecords(distance=out["dist"], radiance=out["rad"]),
            out["rays"])


def sample_pixels(seed, nonce, scene: scene_mod.Scene, cam: cam_mod.Camera,
                  ambience, w: int, h: int, transmitter_kind: str,
                  row0=0, full_h: int | None = None) -> FrameSamples:
    """One 1-spp wavefront over a w x h grid (sample_pixels,
    integrator.fut:103-116 + sample_pixel :78-101), N = w*h lanes in
    row-major order.

    seed/nonce: scalars. Independent per-pixel streams come from hashing
    (seed, nonce, lane id) — the counter-based analogue of the
    reference's per-frame split_rng (integrator.fut:109); the caller
    advances the nonce each frame.

    row0/full_h support image-tile sharding (parallel/render.py): this
    call renders rows [row0, row0+h) of a full_h-tall image, with lane
    ids offset so every global pixel keeps its own stream.
    """
    if full_h is None:
        full_h = h
    n = w * h
    lane = jnp.arange(n, dtype=jnp.int32)
    jx = (lane % w).astype(jnp.float32)
    iy_row = (lane // w).astype(jnp.float32) + jnp.asarray(row0, jnp.float32)
    # the reference flips i: y = h - i - 1 (integrator.fut:89)
    iy = full_h - iy_row - 1.0

    lane_ids = (lane.astype(jnp.uint32)
                + jnp.asarray(row0, jnp.uint32) * jnp.uint32(w))
    state = prng.make_streams(seed, nonce, lane_ids)
    state, wavelen, channel = cam_mod.sample_wavelength(state, cam.conf)
    state, origin, d = cam_mod.sample_ray(
        state, cam, (jnp.float32(w), jnp.float32(full_h)), jx, iy)

    trans_sectors = cam_mod.gen_transmitter_sectors(cam, transmitter_kind, d)

    state, path, rays = path_trace(
        state, scene, origin, d, wavelen, ambience, transmitter_kind,
        trans_sectors, cam.conf.trans_theta, cam.conf.trans_emission)
    rays = rays + jnp.int32(n)  # primary rays
    return FrameSamples(ray_origin=jnp.broadcast_to(origin, (3, n)),
                        ray_dir=d, channel=channel, path=path,
                        rays_traced=rays)


# ---------------------------------------------------------------------------
# Pooled wavefront renderer — the occupancy-optimal multi-sample path.
#
# The reference (and our per-frame path above) runs spp frames of a
# <=16-bounce loop; Russian roulette kills most paths after ~2 bounces
# (~2.2 mean on Cornell, a count, not a time), so late iterations run
# mostly-dead lane pools: ~14% useful work. Here each lane immediately starts a
# fresh camera sample when its path dies, so the pool stays ~100%
# occupied and total iterations drop from spp*16 to ~spp*mean_bounces
# (+ a tail).
#
# ROTATION SCHEDULE. Binding lane k to pixel k for all spp samples makes
# the pool tail-bound on scenes with heterogeneous path lengths (e.g.
# SpectrumSphere: sky pixels terminate in 1 bounce, glass pixels run
# ~10; sky lanes finish their quota early and idle while glass lanes
# grind). Instead, lane k's s-th sample works
# pixel (k + s*R) mod n for a fixed stride R coprime with n: each lane's
# total load averages over ~spp quasi-random pixels and concentrates at
# the mean, so all lanes finish together. The per-(pixel, sample) RNG
# stream is (seed, nonce+s, pixel-id) regardless of which lane runs it —
# identical samples, in the same per-pixel order, as per-frame rendering.
#
# Accumulation under rotation cannot use a per-lane accumulator (the
# lane's pixel changes per sample), and the design avoids scatter-adds; a
# sample that ends at round s instead writes its reduced result into row
# s of fixed (spp, n) stores via a one-hot row mask (dense VPU op). At
# round s the lane->pixel map is a rotation by s*R, so the final
# per-pixel binning is spp static jnp.rolls — no gather/scatter anywhere.
#
# Q-PERIODIC ROTATION. When the pool covers the whole frame (P == n —
# the cornell/mirrorbox-class configs) the full-period rotation needs a
# per-ITEM store: the one-hot row write touches the whole (m_items, P)
# store every iteration (read+write ~670MB/iter at 256x262k, counted
# from the shapes; a dynamic_slice window write makes XLA copy the
# carried buffer instead of updating it in place). But the rotation's
# load-averaging saturates after a few pixels per lane, so lane k's
# sample s works pixel (k + (s mod Q) * stride) mod n with Q = ROT_Q:
# per-lane load still averages over Q well-separated pixels (mirrorbox,
# all-deep specular paths, tail-binds at Q=1), while results fold into
# Q ACCUMULATING store rows — ~50MB/iter of masked adds instead of
# 670MB of row writes, and binning is Q static rolls. Q=1 degenerates to direct lane==pixel accumulation.
# The full-period rotation + per-item stores remain for P < n (the
# heavy-scene occupancy configs, where the store is small and the
# P-cycling needs the full item machinery anyway). ROT_Q_DEFAULT = 16
# is not measured on the H100.
# Env knobs read at TRACE time under render_pooled. Every cached jitted
# executable of the renderer must include knob_key() in its cache key,
# or a knob change after the first call silently reuses the stale
# executable (tests/test_parallel.py::test_knob_key_covers_trace_knobs).
TRACE_KNOBS = ("TRACER_POOL_TARGET", "TRACER_ROT_Q", "TRACER_STEAL_D")


def knob_key() -> tuple:
    """Hashable key of every trace-time env knob (for jit cache keys)."""
    return tuple(os.environ.get(k, "") for k in TRACE_KNOBS)


ROT_Q_DEFAULT = 16


def _rot_q() -> int:
    """TRACER_ROT_Q, read per call like the other knobs so
    tests/monkeypatch can set it after import."""
    return int(os.environ.get("TRACER_ROT_Q", str(ROT_Q_DEFAULT)))


# RING WORK-STEALING. The rotation schedule averages per-lane load, but a
# static item->lane partition still leaves a tail: lane k's total load is
# a sum of m_items random path costs, and the loop runs until the MAX
# over P lanes finishes (the rest of the pool idles while stragglers
# grind). True rebalancing needs scatters (arbitrary item -> arbitrary
# lane); instead lanes steal only at a small static set of ring offsets
# {1, 2, 4, ... 2^(D-1)}: an idle lane with no items of its own left
# claims the next unstarted item of the lane delta positions ahead
# (mod P). Everything stays dense vector ops:
#   * claiming owner cursors / item ids at offset delta is a jnp.roll of
#     the (P,) cursor vectors — no gather;
#   * a stolen item's result must land in the OWNER's store column, which
#     is again a roll of the (value, row, ended) vectors by delta before
#     the same single masked store write — no scatter, no extra device
#     memory traffic;
#   * per-item RNG streams depend only on (sample, pixel), so a stolen
#     item computes the same sample into the same store slot: the P < n
#     path draws the exact no-stealing sample set (verified slot-by-slot:
#     chan_st — an integer pure function of (sample, pixel) — is
#     IDENTICAL across steal settings; float values carry ~1-ulp XLA
#     fusion noise between the two graphs, which can flip a borderline
#     Russian-roulette draw at large sample counts).
# One result per store column can merge per iteration, so when two lanes
# finish items of the same owner simultaneously the later ring offset
# defers (lane holds its result in `pending` and retries next iteration).
# An owner issues at most D+1 items per iteration (self + one per
# offset), so a straggler's backlog drains up to (D+1)x faster.
# TRACER_STEAL_D = D (number of power-of-2 offsets; 0 disables and emits
# the exact pre-stealing graph). STEAL_D_DEFAULT is not measured on the
# H100.
STEAL_D_DEFAULT = 4


def _steal_offsets(pool: int) -> tuple[int, ...]:
    """Ring-steal offsets {2^i} bounded by the pool size; TRACER_STEAL_D
    picks the count (read per call like the other knobs)."""
    d = int(os.environ.get("TRACER_STEAL_D", str(STEAL_D_DEFAULT)))
    return tuple(2 ** i for i in range(max(0, d)) if 2 ** i < pool)


def _rotation_stride(n: int) -> int:
    """Golden-ratio stride coprime with n: consecutive samples of a lane
    land on well-separated pixels, so per-lane load ~ the mean."""
    import math
    if n <= 2:
        return 1
    r = max(1, int(n * 0.6180339887)) | 1
    while math.gcd(r, n) != 1:
        r += 2
    return r % n


# Lane-pool sizing. Two opposing costs:
#   * occupancy: a lane that drew expensive pixels runs long while others
#     idle; with m = n*spp/P work items per lane the per-lane load
#     concentrates at the mean, so occupancy RISES as P shrinks;
#   * per-iteration floor: each pool iteration pays fixed cost (camera
#     resample, masks, store writes, kernel launches); tiny pools on
#     cheap scenes drown in it.
# Big scenes (query-dominated iterations) aim for ITEMS_TARGET_BIG
# items/lane under POOL_CAP_BIG; small scenes aim for ITEMS_SMALL
# items/lane (a lane's last item still runs its full path tail, which m
# items amortize) but never drop below POOL_MIN_SMALL. POOL_TARGET caps
# device memory either way. These constants were tuned on the earlier
# accelerator and are not measured on the H100.
POOL_TARGET = 262144
POOL_CAP_BIG = 65536
POOL_MIN = 8192
ITEMS_TARGET_BIG = 32
ITEMS_SMALL = 16
POOL_MIN_SMALL = 16384
_SMALL_SCENE_TRIS = 512


def _pool_size(n: int, spp: int, t_pad: int) -> int:
    """Pool lane count P: the largest divisor of n not exceeding the
    policy cap. P | n keeps every work-item block [m*P, (m+1)*P) inside
    one sample round, which is what makes the final binning a static
    roll. t_pad is the scene's padded triangle count (iteration-cost
    proxy)."""
    import os
    env = os.environ.get("TRACER_POOL_TARGET")
    if env:
        target = int(env)
    elif t_pad <= _SMALL_SCENE_TRIS:
        target = max(POOL_MIN_SMALL,
                     min(POOL_TARGET, (n * spp) // ITEMS_SMALL))
    else:
        target = max(POOL_MIN,
                     min(POOL_CAP_BIG, (n * spp) // ITEMS_TARGET_BIG))
    if n <= target:
        return n
    g = -(-n // target)
    while n % g != 0:
        g += 1
    return n // g


def _scene_t_pad(scene) -> int:
    """Padded triangle count of the active accel (static under jit)."""
    from tracer_tpu.ops import intersect as _i
    if isinstance(scene.accel, _i.DenseTris):
        return int(scene.accel.coeffs.shape[1])
    return int(scene.tris.shape[0])

def render_pooled(seed, nonce, scene: scene_mod.Scene, cam: cam_mod.Camera,
                  ambience, w: int, h: int, transmitter_kind: str,
                  spp: int, render_mode: str,
                  row0=0, full_h: int | None = None,
                  with_points: bool = False):
    """Render spp samples/pixel with lane refill.

    Returns a dict with:
      img          (h, w, 3) — mean frame, already x n_channels for color
                   mode; first-sample-with-return hue for distance mode
      rays_traced  scalar int32 — total trace queries (bench metric)
      points       (pos (3,N), dist (N,), inten (N,)) closest LiDAR
                   return per pixel (only if with_points)
    """
    if full_h is None:
        full_h = h
    n = w * h
    conf = cam.conf
    n_channels = conf.sensor_color.shape[0]
    color_mode = render_mode != "distance"
    pool = _pool_size(n, spp, _scene_t_pad(scene))  # P lanes; P | n
    qrot = pool == n                   # Q-PERIODIC ROTATION note above
    steal_offsets = _steal_offsets(pool)  # RING WORK-STEALING note above
    stride = _rotation_stride(n)
    m_items = (n * spp) // pool        # work items per lane
    n_q = max(1, min(_rot_q(), m_items)) if qrot else 0  # rotation period
    lane = jnp.arange(pool, dtype=jnp.int32)
    srow = (jnp.arange(n_q, dtype=jnp.int32)[:, None] if qrot
            else jnp.arange(m_items, dtype=jnp.int32)[:, None])

    ambience = jnp.asarray(ambience, jnp.float32)
    seed = jnp.asarray(seed, jnp.uint32)
    nonce = jnp.asarray(nonce, jnp.uint32)
    spp_factor = jnp.float32(1.0 / spp)

    # Work item j covers (sample s, pixel (i + s*stride) mod n) with
    # s = j // n, i = j mod n; lane k runs items k, k+P, k+2P, ... Since
    # P | n, item block m (= j // P) lies inside one sample round:
    # s_m = m*P // n and i = base_m + k with base_m = m*P mod n, so store
    # row m maps lane k -> pixel (shift_m + k) mod n for the STATIC
    # shift_m below — binning stays a roll even when P < n.
    import numpy as _np
    if qrot:
        # Q-periodic: store row q collects every sample at phase
        # s mod Q, whose lane->pixel map is a rotation by q*stride.
        bin_shifts = jnp.asarray(
            (_np.arange(n_q, dtype=_np.int64) * stride) % n, jnp.int32)
    else:
        _mp = _np.arange(m_items, dtype=_np.int64) * pool
        bin_shifts = jnp.asarray(
            (_mp % n + (_mp // n) * stride) % n, jnp.int32)

    zero_n = jnp.zeros((pool,), jnp.float32)
    init = dict(
        rng=jnp.zeros((pool,), jnp.uint32),
        done=jnp.zeros((pool,), jnp.int32),    # items completed by lane
        active=jnp.zeros((pool,), bool),       # a path is in flight
        bounce=jnp.zeros((pool,), jnp.int32),
        # per-lane item cursor, pre-advanced so the first refill lands on
        # item k: advance adds P to base (wrapping into s) and P (+stride
        # on wrap) to pix
        s=jnp.full((pool,), -1, jnp.int32),    # sample index of the item
        base=jnp.full((pool,), n - pool, jnp.int32),
        pix=(lane - jnp.int32(pool) - jnp.int32(stride)) % jnp.int32(n),
        o=jnp.zeros((3, pool), jnp.float32),
        d=jnp.zeros((3, pool), jnp.float32),
        po=jnp.zeros((3, pool), jnp.float32),  # primary ray (for points)
        pd=jnp.zeros((3, pool), jnp.float32),
        wavelen=zero_n,
        chan=jnp.zeros((pool,), jnp.int32),    # sample's sensor channel
        cum_dist=zero_n,
        sample_rad=zero_n,                     # per-sample radiance sum
        sample_min_d=jnp.full((pool,), jnp.inf),  # windowed min dist
        rays=jnp.int32(0),
        it=jnp.int32(0),
    )
    if steal_offsets:
        # RING WORK-STEALING state; absent at TRACER_STEAL_D=0 so the
        # disabled setting emits the exact pre-stealing graph (the A/B
        # control carries no extra loop state or selects)
        init["issued"] = jnp.zeros((pool,), jnp.int32)  # issued per OWNER
        init["row"] = jnp.zeros((pool,), jnp.int32)   # executing item's m
        init["doff"] = jnp.zeros((pool,), jnp.int32)  # item's owner offset
        init["pending"] = jnp.zeros((pool,), bool)    # write deferred
    # Accumulation state. qrot: n_q ACCUMULATING rows — row q holds the
    # running merge of every sample at phase s mod Q (color: channel-
    # folded sum; distance: first-in-s return; points: min-d return).
    # Otherwise per-item stores: row m holds the reduced result of the
    # lane's m-th work item, binned by static rolls after the loop.
    if qrot:
        if color_mode:
            init["acc3q"] = jnp.zeros((3, n_q, pool), jnp.float32)
        else:
            # distance viz: FIRST sample (smallest s) with a windowed
            # return wins; first_s is the cross-phase tiebreaker
            init["first_s"] = jnp.full((n_q, pool), m_items, jnp.int32)
            init["first_d"] = jnp.full((n_q, pool), jnp.inf, jnp.float32)
    else:
        if color_mode:
            init["rad_st"] = jnp.zeros((m_items, pool), jnp.float32)
            # channel ids are 0..2; int8 quarters the per-iteration
            # device-memory traffic of the store update
            init["chan_st"] = jnp.zeros((m_items, pool), jnp.int8)
        if not color_mode or with_points:
            init["mind_st"] = jnp.full((m_items, pool), jnp.inf, jnp.float32)
    if with_points:
        init["sample_pos"] = jnp.zeros((3, pool), jnp.float32)
        init["sample_int"] = zero_n
        if qrot:
            # closest return per pixel: strict min across samples;
            # acc_ps carries the winning sample index so exact-distance
            # ties across phases resolve in sample order (lib.fut:40-47
            # strict-min-in-sample-order), not phase order
            init["acc_pd"] = jnp.full((n_q, pool), jnp.inf, jnp.float32)
            init["acc_pos"] = jnp.zeros((3, n_q, pool), jnp.float32)
            init["acc_int"] = jnp.zeros((n_q, pool), jnp.float32)
            init["acc_ps"] = jnp.full((n_q, pool), m_items, jnp.int32)
        else:
            init["pos_st"] = jnp.zeros((3, m_items, pool), jnp.float32)
            init["int_st"] = jnp.zeros((m_items, pool), jnp.float32)

    # stealing can defer a write behind at most one winner per offset per
    # column; pad the safety bound accordingly
    max_iters = m_items * PATH_LEN + PATH_LEN + 4 + 4 * len(steal_offsets)

    def cond(c):
        return jnp.any(c["done"] < m_items) & (c["it"] < max_iters)

    def _advance(o_base, o_s, o_pix):
        """One item-cursor advance: +P into the frame, wrapping into the
        next sample round (and rotating by stride)."""
        base_adv = o_base + jnp.int32(pool)
        wrap = base_adv >= n
        base_adv = base_adv - jnp.where(wrap, jnp.int32(n), 0)
        s_adv = o_s + wrap.astype(jnp.int32)
        if qrot:
            # pixel (lane + (s mod Q) * stride) mod n — Q-periodic
            pix_adv = (lane + (s_adv % n_q) * jnp.int32(stride)) % jnp.int32(n)
        else:
            pix_adv = o_pix + jnp.int32(pool) + jnp.where(
                wrap, jnp.int32(stride), 0)
            pix_adv = pix_adv - jnp.where(pix_adv >= n, jnp.int32(n), 0)
            pix_adv = pix_adv - jnp.where(pix_adv >= n, jnp.int32(n), 0)
        return base_adv, s_adv, pix_adv

    def start_samples(c):
        """Refill idle lanes with a fresh camera sample (wavelength +
        channel + primary ray): first each lane claims its OWN next item,
        then item-exhausted lanes steal the next unstarted item of the
        owner at each ring offset (RING WORK-STEALING note above). Owner
        cursors/ids move to the claiming lane by rolls — no gathers."""
        if steal_offsets:
            idle = (~c["active"]) & (~c["pending"])
            o_base, o_s, o_pix = c["base"], c["s"], c["pix"]
            issued = c["issued"]
            started = jnp.zeros((pool,), bool)
            row_x, doff_x = c["row"], c["doff"]
            pix_x, s_x = o_pix, o_s       # filler for non-claiming lanes
            for dlt in (0,) + steal_offsets:
                base_adv, s_adv, pix_adv = _advance(o_base, o_s, o_pix)
                has = issued < m_items
                if dlt == 0:
                    cand_h = idle & has    # helper == owner: own item
                    cand_o = cand_h
                    row_c, pix_c, s_c = issued, pix_adv, s_adv
                else:
                    cand_h = idle & ~started & jnp.roll(has, -dlt)
                    cand_o = jnp.roll(cand_h, dlt)
                    row_c = jnp.roll(issued, -dlt)
                    pix_c = jnp.roll(pix_adv, -dlt)
                    s_c = jnp.roll(s_adv, -dlt)
                started = started | cand_h
                o_base = jnp.where(cand_o, base_adv, o_base)
                o_s = jnp.where(cand_o, s_adv, o_s)
                o_pix = jnp.where(cand_o, pix_adv, o_pix)
                issued = issued + cand_o.astype(jnp.int32)
                row_x = jnp.where(cand_h, row_c, row_x)
                pix_x = jnp.where(cand_h, pix_c, pix_x)
                s_x = jnp.where(cand_h, s_c, s_x)
                doff_x = jnp.where(cand_h, jnp.int32(dlt), doff_x)
            start = started
            cursor_out = dict(pix=o_pix, base=o_base, s=o_s,
                              issued=issued, row=row_x, doff=doff_x)
        else:
            # static partition (the exact pre-stealing graph): each lane
            # claims only its own next item; the store row is its done
            # counter
            start = (~c["active"]) & (c["done"] < m_items)
            base_adv, s_adv, pix_adv = _advance(c["base"], c["s"], c["pix"])
            o_base = jnp.where(start, base_adv, c["base"])
            s_x = jnp.where(start, s_adv, c["s"])
            pix_x = jnp.where(start, pix_adv, c["pix"])
            cursor_out = dict(pix=pix_x, base=o_base, s=s_x)

        jx = (pix_x % w).astype(jnp.float32)
        iy_row = (pix_x // w).astype(jnp.float32) + jnp.asarray(
            row0, jnp.float32)
        iy = full_h - iy_row - 1.0  # reference flips i (integrator.fut:89)
        pix_ids = (pix_x.astype(jnp.uint32)
                   + jnp.asarray(row0, jnp.uint32) * jnp.uint32(w))

        sample_idx = s_x.astype(jnp.uint32)
        # identical streams to per-frame rendering with nonce+sample_idx:
        # make_streams(seed, nonce+s, pixel) vectorized over per-lane s
        hseed = prng.hash_u32(seed ^ prng.hash_u32(nonce + sample_idx))
        fresh = prng.hash_u32(pix_ids ^ hseed)
        rng = jnp.where(start, fresh, c["rng"])

        rng2, wavelen, channel = cam_mod.sample_wavelength(rng, conf)
        rng2, o_new, d_new = cam_mod.sample_ray(
            rng2, cam, (jnp.float32(w), jnp.float32(full_h)), jx, iy)

        upd = lambda old, new: jnp.where(start, new, old)
        out = dict(c, rng=upd(c["rng"], rng2),
                   active=c["active"] | start,
                   bounce=upd(c["bounce"], 0),
                   **cursor_out,
                   o=upd(c["o"], o_new), d=upd(c["d"], d_new),
                   po=upd(c["po"], o_new), pd=upd(c["pd"], d_new),
                   wavelen=upd(c["wavelen"], wavelen),
                   chan=upd(c["chan"], channel),
                   cum_dist=upd(c["cum_dist"], 0.0),
                   sample_rad=upd(c["sample_rad"], 0.0),
                   sample_min_d=upd(c["sample_min_d"], jnp.inf))
        if with_points:
            out["sample_pos"] = upd(c["sample_pos"], 0.0)
            out["sample_int"] = upd(c["sample_int"], 0.0)
        return out

    def finish_samples(c, ended):
        """Close out lanes whose path just died: merge the sample's
        reduced result into its phase's accumulating row (qrot) or write
        it into store row `row` (its item index). A stolen item's result
        is first rolled to its OWNER's column; at most one result per
        column merges per iteration — losers wait in `pending`."""
        if steal_offsets:
            # arbitration: self-results always win their own column, then
            # ring offsets in ascending order; one write/column/iter
            pend = ended | c["pending"]
            fin = pend & (c["doff"] == 0)
            col_taken = fin
            for dlt in steal_offsets:
                want = pend & (c["doff"] == dlt) & ~jnp.roll(col_taken, -dlt)
                fin = fin | want
                col_taken = col_taken | jnp.roll(want, dlt)

            def align(vec, neutral):
                """Move finishing lanes' values to their owner's column."""
                out_v = jnp.where(fin & (c["doff"] == 0), vec, neutral)
                for dlt in steal_offsets:
                    md = jnp.roll(fin & (c["doff"] == dlt), dlt)
                    out_v = jnp.where(md, jnp.roll(vec, dlt, axis=-1), out_v)
                return out_v

            a_end = col_taken                  # column received a result
            a_row = align(c["row"], 0)
            extra = dict(pending=pend & ~fin)
        else:
            # static partition: lane == owner, every result merges now
            # and the store row is the lane's done counter (the exact
            # pre-stealing graph)
            align = lambda vec, neutral: vec
            a_end = ended
            a_row = c["done"]
            extra = {}
        a_rad = align(c["sample_rad"], 0.0)
        a_chan = align(c["chan"], 0)
        a_mind = align(c["sample_min_d"], jnp.inf)

        out = dict(c, done=c["done"] + a_end.astype(jnp.int32),
                   active=c["active"] & ~ended, **extra)
        if qrot:
            sel = (srow == (a_row % n_q)[None, :]) & a_end[None, :]
            if color_mode:
                # route radiance to the sample's channel color; the
                # channel select is a static C<=3 chain, no gather
                contrib = jnp.zeros((3, pool), jnp.float32)
                for ci in range(n_channels):
                    contrib = contrib + conf.sensor_color[ci][:, None] * \
                        jnp.where(a_chan == ci, a_rad, 0.0)
                out["acc3q"] = c["acc3q"] + jnp.where(
                    sel[None], contrib[:, None, :], 0.0)
            else:
                # first (smallest-s) sample with a windowed return wins;
                # strict min in s is completion-order independent
                got = (sel & jnp.isfinite(a_mind)[None]
                       & (a_row[None] < c["first_s"]))
                out["first_s"] = jnp.where(got, a_row[None], c["first_s"])
                out["first_d"] = jnp.where(got, a_mind[None], c["first_d"])
            if with_points:
                a_pos = align(c["sample_pos"], 0.0)
                a_int = align(c["sample_int"], 0.0)
                # min in sample order with newest-wins ties: the
                # reference folds `if p1.d < p2.d then p1 else p2` with
                # p2 the NEW sample (lib.fut:49-51), so an exact-distance
                # tie keeps the larger sample index
                better = sel & ((a_mind[None] < c["acc_pd"])
                                | (jnp.isfinite(a_mind)[None]
                                   & (a_mind[None] == c["acc_pd"])
                                   & (a_row[None] > c["acc_ps"])))
                out["acc_pd"] = jnp.where(better, a_mind[None], c["acc_pd"])
                out["acc_pos"] = jnp.where(better[None],
                                           a_pos[:, None, :], c["acc_pos"])
                out["acc_int"] = jnp.where(better, a_int[None], c["acc_int"])
                out["acc_ps"] = jnp.where(better, a_row[None], c["acc_ps"])
            return out
        sel = (srow == a_row[None, :]) & a_end[None, :]  # (m_items, P)
        if color_mode:
            out["rad_st"] = jnp.where(sel, a_rad[None, :], c["rad_st"])
            out["chan_st"] = jnp.where(sel, a_chan[None, :].astype(jnp.int8),
                                       c["chan_st"])
        if "mind_st" in c:
            out["mind_st"] = jnp.where(sel, a_mind[None, :], c["mind_st"])
        if with_points:
            a_pos = align(c["sample_pos"], 0.0)
            a_int = align(c["sample_int"], 0.0)
            out["pos_st"] = jnp.where(sel[None], a_pos[:, None, :],
                                      c["pos_st"])
            out["int_st"] = jnp.where(sel, a_int[None, :], c["int_st"])
        return out

    def body(c):
        c = start_samples(c)
        alive = c["active"]
        # the transmitter fan hangs off the PRIMARY ray (integrator.fut:96)
        trans_sectors = cam_mod.gen_transmitter_sectors(
            cam, transmitter_kind, c["pd"])

        inter = scene_mod.closest_interaction(
            scene, shapes.F32_HIGHEST, c["o"], c["d"], c["wavelen"])
        hit = alive & inter.ok
        miss = alive & ~inter.ok

        wo = -c["d"]
        rng, direct = direct_mod.direct_radiance(
            c["rng"], scene, wo, inter, c["wavelen"], trans_sectors,
            transmitter_kind, conf.trans_theta, conf.trans_emission,
            mask=hit)
        ambient = spec.lookup_pairs(
            c["wavelen"], [(ambience[k, 0], ambience[k, 1]) for k in range(6)])
        emitted = jnp.where(c["bounce"] == 0, inter.emission_at_wl, 0.0)
        radiance = jnp.where(hit, direct + emitted,
                             jnp.where(miss, ambient, 0.0))
        cum_dist = jnp.where(hit, c["cum_dist"] + inter.t, c["cum_dist"])
        rec_dist = jnp.where(hit, cum_dist, jnp.inf)  # miss records inf

        sample_rad = c["sample_rad"] + radiance
        in_window = ((radiance > 0) & (rec_dist > LIDAR_MIN_D)
                     & (rec_dist < LIDAR_MAX_D) & alive)
        closer = in_window & (rec_dist < c["sample_min_d"])
        sample_min_d = jnp.where(closer, rec_dist, c["sample_min_d"])

        upd_pts = {}
        if with_points:
            # lib.fut:40-47: intensity scaled by 1/spp before the >0 test
            # (scale-invariant for the >0 comparison, so `closer` agrees)
            upd_pts["sample_pos"] = jnp.where(
                closer, c["po"] + rec_dist * c["pd"], c["sample_pos"])
            upd_pts["sample_int"] = jnp.where(
                closer, radiance * spp_factor, c["sample_int"])

        # BSDF bounce + RR
        rng, wi, bsdf, pdf_val, pdf_kind = materials.sample_dir(
            rng, wo, inter.normal, inter.mat)
        pdf = jnp.where(pdf_kind == materials.PDF_DELTA, 1.0,
                        jnp.where(pdf_kind == materials.PDF_NONZERO,
                                  pdf_val, 0.0))
        cos_falloff = jnp.abs(la.v3_dot(inter.normal, wi))
        p_terminate = 1.0 - bsdf * cos_falloff / pdf
        rng, u = prng.next_unit(rng)
        terminate = u < p_terminate
        continues = hit & (pdf != 0) & ~terminate & (c["bounce"] + 1 < PATH_LEN)
        ended = alive & ~continues

        o_new, d_new = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi)
        c = dict(c, rng=rng,
                 o=jnp.where(continues, o_new, c["o"]),
                 d=jnp.where(continues, d_new, c["d"]),
                 bounce=c["bounce"] + 1,
                 cum_dist=cum_dist,
                 sample_rad=sample_rad,
                 sample_min_d=sample_min_d,
                 rays=c["rays"] + 3 * jnp.sum(alive).astype(jnp.int32),
                 it=c["it"] + 1, **upd_pts)
        return finish_samples(c, ended)

    out = jax.lax.while_loop(cond, body, init)

    # ------------------------------------------------------------------
    # Binning: store row m maps lane k -> pixel (bin_shifts[m] + k) mod n
    # (static shifts); a row's values occupy the padded segment's first P
    # slots, neutral elsewhere. On this (P < n) path item order is
    # monotone in sample index, so per-pixel accumulation runs in sample
    # order, matching the reference's per-frame sum order. (The qrot
    # path above reassociates: phase-major order — same sample set,
    # float-tolerance equality; distance/points semantics are preserved
    # exactly via the first_s tiebreaker and the min-d merge.)
    def pad_row(row, fill):
        if pool == n:
            return row
        return jnp.pad(row, [(0, 0)] * (row.ndim - 1) + [(0, n - pool)],
                       constant_values=fill)

    result = {}
    if qrot:
        # bin the n_q accumulating rows: row q -> roll by q*stride
        if color_mode:
            acc = jnp.zeros((3, n), jnp.float32)
            for q in range(n_q):
                acc = acc + jnp.roll(out["acc3q"][:, q], bin_shifts[q],
                                     axis=1)
            img_t = acc * (jnp.float32(n_channels) * spp_factor)
        else:
            # first return across phases = smallest sample index
            best_s = jnp.full((n,), m_items, jnp.int32)
            dmin = jnp.full((n,), jnp.inf, jnp.float32)
            for q in range(n_q):
                s_r = jnp.roll(out["first_s"][q], bin_shifts[q])
                d_r = jnp.roll(out["first_d"][q], bin_shifts[q])
                better = s_r < best_s
                best_s = jnp.where(better, s_r, best_s)
                dmin = jnp.where(better, d_r, dmin)
            has = best_s < m_items
            hue = 0.85 * (dmin - LIDAR_MIN_D) / (LIDAR_MAX_D - LIDAR_MIN_D)
            rgb = hue_to_rgb(jnp.where(has, hue, 0.0))
            img_t = jnp.where(has, rgb, 0.0)
        result["img"] = la.v3_to_array(img_t).reshape(h, w, 3)
        result["rays_traced"] = out["rays"]
        result["iters"] = out["it"]
        if with_points:
            best_d = jnp.full((n,), jnp.inf, jnp.float32)
            best_pos = jnp.full((3, n), -1.0, jnp.float32)
            best_int = jnp.zeros((n,), jnp.float32)
            best_ps = jnp.full((n,), m_items, jnp.int32)
            for q in range(n_q):
                d_r = jnp.roll(out["acc_pd"][q], bin_shifts[q])
                p_r = jnp.roll(out["acc_pos"][:, q], bin_shifts[q], axis=1)
                i_r = jnp.roll(out["acc_int"][q], bin_shifts[q])
                s_r = jnp.roll(out["acc_ps"][q], bin_shifts[q])
                # exact-distance ties resolve on the LARGER sample index
                # (newest wins: lib.fut:49-51 keeps p2, the new sample;
                # the non-tie path is the plain strict min)
                better = (d_r < best_d) | (jnp.isfinite(d_r)
                                           & (d_r == best_d)
                                           & (s_r > best_ps))
                best_d = jnp.where(better, d_r, best_d)
                best_pos = jnp.where(better, p_r, best_pos)
                best_int = jnp.where(better, i_r, best_int)
                best_ps = jnp.where(better, s_r, best_ps)
            has_p = jnp.isfinite(best_d)
            result["points"] = (
                jnp.where(has_p, best_pos, -1.0),
                jnp.where(has_p, best_d, jnp.inf),
                jnp.where(has_p, best_int, 0.0))
        return result
    if color_mode:
        sensor_color = conf.sensor_color  # (C, 3)

        def bin_color(m, acc):
            row = jax.lax.dynamic_index_in_dim(out["rad_st"], m, 0,
                                               keepdims=False)
            ch = jax.lax.dynamic_index_in_dim(out["chan_st"], m, 0,
                                              keepdims=False)
            contrib = jnp.zeros((3, pool), jnp.float32)
            for ci in range(n_channels):
                contrib = contrib + sensor_color[ci][:, None] * jnp.where(
                    ch == ci, row, 0.0)
            return acc + jnp.roll(pad_row(contrib, 0.0), bin_shifts[m],
                                  axis=1)

        acc = jax.lax.fori_loop(0, m_items, bin_color,
                                jnp.zeros((3, n), jnp.float32))
        img_t = acc * (jnp.float32(n_channels) * spp_factor)
    else:
        # distance visualization: first sample with a windowed return wins
        # (integrator.fut:188-189) — item order is sample order per pixel.
        def bin_dist(m, carry):
            has, dmin = carry
            row = jax.lax.dynamic_index_in_dim(out["mind_st"], m, 0,
                                               keepdims=False)
            rolled = jnp.roll(pad_row(row, jnp.inf), bin_shifts[m])
            got = (~has) & jnp.isfinite(rolled)
            return has | got, jnp.where(got, rolled, dmin)

        has, dmin = jax.lax.fori_loop(
            0, m_items, bin_dist,
            (jnp.zeros((n,), bool), jnp.full((n,), jnp.inf)))
        hue = 0.85 * (dmin - LIDAR_MIN_D) / (LIDAR_MAX_D - LIDAR_MIN_D)
        rgb = hue_to_rgb(jnp.where(has, hue, 0.0))
        img_t = jnp.where(has, rgb, 0.0)
    img = la.v3_to_array(img_t).reshape(h, w, 3)

    result["img"] = img
    result["rays_traced"] = out["rays"]
    result["iters"] = out["it"]  # occupancy diagnostic: ideal ~= rays/(3P)
    if with_points:
        # closest return per pixel across all samples: the reference's
        # fold keeps the NEW sample on an exact-distance tie
        # (lib.fut:49-51 `if p1.d < p2.d then p1 else p2`), and item
        # order here IS per-pixel sample order, so <= reproduces it
        def bin_points(m, carry):
            bd, bp, bi = carry
            shift = bin_shifts[m]
            d_row = jnp.roll(pad_row(jax.lax.dynamic_index_in_dim(
                out["mind_st"], m, 0, keepdims=False), jnp.inf), shift)
            i_row = jnp.roll(pad_row(jax.lax.dynamic_index_in_dim(
                out["int_st"], m, 0, keepdims=False), 0.0), shift)
            p_row = jnp.roll(pad_row(jax.lax.dynamic_index_in_dim(
                out["pos_st"], m, 1, keepdims=False), 0.0), shift, axis=1)
            better = jnp.isfinite(d_row) & (d_row <= bd)
            return (jnp.where(better, d_row, bd),
                    jnp.where(better, p_row, bp),
                    jnp.where(better, i_row, bi))

        best_d, best_pos, best_int = jax.lax.fori_loop(
            0, m_items, bin_points,
            (jnp.full((n,), jnp.inf), jnp.full((3, n), -1.0),
             jnp.zeros((n,), jnp.float32)))
        has = jnp.isfinite(best_d)
        result["points"] = (
            jnp.where(has, best_pos, -1.0),
            jnp.where(has, best_d, jnp.inf),
            jnp.where(has, best_int, 0.0))
    return result


# ---------------------------------------------------------------------------
# Visualization (integrator.fut:133-170)

def hue_to_rgb(hhue):
    """HSV->RGB at full saturation/value (integrator.fut:139-148).
    hhue (N,) -> (3, N)."""
    hp = hhue * 6.0
    x = 1.0 - jnp.abs(jnp.mod(hp, 2.0) - 1.0)
    k = jnp.floor(hp).astype(jnp.int32)
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    rgb = jnp.select(
        [k == 0, k == 1, k == 2, k == 3, k == 4],
        [la.v3(one, x, zero),
         la.v3(x, one, zero),
         la.v3(zero, one, x),
         la.v3(zero, x, one),
         la.v3(x, zero, one)],
        la.v3(one, zero, x))
    return rgb


def visualize_color(samples: FrameSamples, channel_colors, w: int, h: int):
    """Sum of per-bounce radiance routed to the sample's channel color,
    scaled by the channel count (integrator.fut:163-168)."""
    n_channels = channel_colors.shape[0]
    intensity = jnp.sum(samples.path.radiance, axis=0)  # (N,)
    # channel -> color via a static select chain (C <= 3), not a gather
    color = jnp.zeros((3,) + intensity.shape, jnp.float32)
    for c in range(n_channels):
        color = jnp.where(samples.channel == c,
                          channel_colors[c][:, None], color)
    img = (intensity * color) * jnp.float32(n_channels)  # (3, N)
    return la.v3_to_array(img).reshape(h, w, 3)


def visualize_distance(samples: FrameSamples, w: int, h: int):
    """Closest valid LiDAR return mapped to hue (integrator.fut:150-162)."""
    d = samples.path.distance
    valid = ((samples.path.radiance > 0)
             & (d > LIDAR_MIN_D) & (d < LIDAR_MAX_D))
    dmin = jnp.min(jnp.where(valid, d, jnp.inf), axis=0)  # (N,)
    has = jnp.isfinite(dmin)
    hue = 0.85 * (dmin - LIDAR_MIN_D) / (LIDAR_MAX_D - LIDAR_MIN_D)
    rgb = hue_to_rgb(jnp.where(has, hue, 0.0))
    img = jnp.where(has, rgb, 0.0)  # (3, N)
    return la.v3_to_array(img).reshape(h, w, 3)


def visualize(samples: FrameSamples, render_mode: str, channel_colors,
              w: int, h: int):
    if render_mode == "distance":
        return visualize_distance(samples, w, h)
    return visualize_color(samples, channel_colors, w, h)


# ---------------------------------------------------------------------------
# Frame accumulation (integrator.fut:180-192)

def accumulate_color(acc, new, n_frames):
    """EMA merge using the pre-increment frame count, matching
    sample_frame_accum exactly (integrator.fut:190-192) — including its
    quirk that the n_frames=1 merge discards the first frame."""
    nf = jnp.asarray(n_frames, jnp.float32)
    return acc * ((nf - 1.0) / nf) + new * (1.0 / nf)


def accumulate_distance(acc, new):
    """Keep the existing pixel when it already has a return
    (integrator.fut:188-189)."""
    keep = la.norm(acc) > 0
    return jnp.where(keep[..., None], acc, new)


# ---------------------------------------------------------------------------
# LiDAR point clouds (integrator.fut:118-128, lib.fut:35-63)

class CloudPoints(NamedTuple):
    pos: jax.Array        # (3, PATH_LEN, N)
    distance: jax.Array   # (PATH_LEN, N)
    intensity: jax.Array  # (PATH_LEN, N)


def to_cloud_points(samples: FrameSamples) -> CloudPoints:
    """Positions along the straight primary ray at each return's path
    distance (sample_points, integrator.fut:118-128)."""
    dists = samples.path.distance  # (L, N)
    safe_d = jnp.where(jnp.isfinite(dists), dists, 0.0)
    pos = (samples.ray_origin[:, None, :]
           + safe_d[None] * samples.ray_dir[:, None, :])
    return CloudPoints(pos=pos, distance=dists,
                       intensity=samples.path.radiance)


def closest_return(points: CloudPoints, spp_factor):
    """Scale intensity by 1/spp, filter to the LiDAR window, min-distance
    return per lane (the `closest` helper, lib.fut:40-47). Returns
    (pos (3, N), distance (N,), intensity (N,)); misses are
    pos=(-1,-1,-1), distance=inf, intensity=0."""
    inten = points.intensity * spp_factor
    valid = ((inten > 0)
             & (points.distance > LIDAR_MIN_D)
             & (points.distance < LIDAR_MAX_D))
    dist = jnp.where(valid, points.distance, jnp.inf)
    best_d = jnp.min(dist, axis=0)                    # (N,)
    has = jnp.isfinite(best_d)
    # first record achieving the min (bounce axis is static length 16:
    # unrolled select chain, no argmin-over-lanes)
    best_pos = points.pos[:, 0, :]
    best_i = inten[0]
    found = dist[0] == best_d
    for k in range(1, points.distance.shape[0]):
        m = (~found) & (dist[k] == best_d)
        best_pos = jnp.where(m, points.pos[:, k, :], best_pos)
        best_i = jnp.where(m, inten[k], best_i)
        found = found | m
    pos = jnp.where(has, best_pos, -1.0)
    inten_out = jnp.where(has, best_i, 0.0)
    return pos, jnp.where(has, best_d, jnp.inf), inten_out
