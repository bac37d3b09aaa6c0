"""Public API — the 7 entry points (replaces lib.fut).

Same surface as the reference's generated C API (SURVEY.md section 2.1):
  init              lib.fut:76-106  build scene + accel + initial state
  step              lib.fut:111-118 one progressive 1-spp frame
  render            lib.fut:187-196 upsample + pack ARGB framebuffer
  key               lib.fut:120-185 runtime UI state machine
  resize            lib.fut:108-109
  sample_points_n   lib.fut:35-63   LiDAR point-cloud batch capture
  sample_n_frames   lib.fut:67-74   offline progressive render

All device work is jitted over the EngineState pytree; jit caches key on
the state's static fields (dims, subsampling, render mode, transmitter
kind), so interactive tweaks of traced fields (camera, aperture, mode)
never recompile. Only the framebuffer / point cloud crosses back to the
host, preserving the reference's one-transfer-per-frame discipline
(SURVEY.md section 2.4).
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from tracer_tpu.engine import integrator, keys
from tracer_tpu.engine.state import EngineState
from tracer_tpu.models import camera as cam_mod
from tracer_tpu.models import scene as scene_mod
from tracer_tpu.models import sensors
from tracer_tpu.ops import linalg as la
from tracer_tpu.ops import spectrum as spec


# ---------------------------------------------------------------------------
# init (lib.fut:76-106)

def init(seed: int, h: int, w: int, cam_conf_id: int,
         tri_geoms, tri_mats, mat_data,
         cam_pitch: float = 0.0, cam_yaw: float = 0.0,
         cam_origin=(0.0, 0.0, 0.0), accel: str = "auto") -> EngineState:
    """Build the scene (triangles, materials, lights, acceleration
    structure) and the initial engine state.

    Argument layout matches the reference init ABI (lib.fut:76-85):
    tri_geoms (n,3,3) f32, tri_mats (n,) u32, mat_data (m,28) f32.
    """
    conf, render_mode, transmitter_kind = sensors.conf_for_id(cam_conf_id)
    sc = scene_mod.build_scene(tri_geoms, tri_mats, mat_data, accel=accel)
    cam = cam_mod.Camera(
        pitch=jnp.float32(cam_pitch),
        yaw=jnp.float32(cam_yaw),
        origin=jnp.asarray(cam_origin, jnp.float32),
        conf=conf)
    return EngineState(
        width=int(w), height=int(h), subsampling=1,
        render_mode=render_mode, transmitter_kind=transmitter_kind,
        cam_conf_id=int(cam_conf_id),
        seed=jnp.uint32(seed), nonce=jnp.uint32(0),
        img=jnp.zeros((h, w, 3), jnp.float32),
        n_frames=jnp.uint32(0),
        ambience=jnp.asarray(spec.no_sky(), jnp.float32),
        mode=jnp.asarray(False),
        cam=cam, scene=sc)


# ---------------------------------------------------------------------------
# step (lib.fut:111-118)

@partial(jax.jit, static_argnames=("knobs",))
def _step_core(s: EngineState, knobs=()) -> EngineState:
    # `knobs` (integrator.knob_key()) keys the jit cache on the env knobs
    # that render_pooled reads at trace time, so an in-process knob
    # change retraces instead of reusing the stale executable
    w, h = s.sub_dims
    # a 1-spp frame through the pooled wavefront: for frames above the
    # pool cap the lane pool cycles over pixels (integrator.POOL_TARGET),
    # so dead lanes refill with queued pixels instead of idling through
    # the bounce tail — ~4x fewer trace queries on a 1024x1024 frame
    img_new = integrator.render_pooled(
        s.seed, s.nonce, s.scene, s.cam, s.ambience, w, h,
        s.transmitter_kind, 1, s.render_mode)["img"]
    accum = s.mode & (s.n_frames > 0)
    if s.render_mode == sensors.RENDER_DISTANCE:
        merged = integrator.accumulate_distance(s.img, img_new)
    else:
        merged = integrator.accumulate_color(s.img, img_new, s.n_frames)
    img = jnp.where(accum, merged, img_new)
    n_frames = jnp.where(accum, s.n_frames + 1, jnp.uint32(1))
    return s.replace(img=img, n_frames=n_frames, nonce=s.nonce + 1)


def step(s: EngineState) -> EngineState:
    """Advance one progressive frame (fresh or EMA-accumulated depending
    on mode/n_frames, lib.fut:111-118)."""
    if s.img.shape[:2] != (s.sub_dims[1], s.sub_dims[0]):
        s = s.replace(img=jnp.zeros(
            (s.sub_dims[1], s.sub_dims[0], 3), jnp.float32))
    return _step_core(s, knobs=integrator.knob_key())


# ---------------------------------------------------------------------------
# render (lib.fut:187-196)

@partial(jax.jit, static_argnames=("width", "height", "subsampling"))
def _render_core(img, width: int, height: int, subsampling: int):
    ri = jnp.arange(height) // subsampling
    ci = jnp.arange(width) // subsampling
    up = img[ri][:, ci]  # nearest-neighbour upsample (lib.fut:192-195)
    rgb = (jnp.clip(up, 0.0, 1.0) * 255.0).astype(jnp.uint32)
    argb = ((jnp.uint32(255) << 24) | (rgb[..., 0] << 16)
            | (rgb[..., 1] << 8) | rgb[..., 2])
    return argb


def render(s: EngineState):
    """Pack the current image into an (h, w) uint32 ARGB framebuffer with
    nearest-neighbour upsampling of the subsampled image."""
    return _render_core(s.img, s.width, s.height, s.subsampling)


# ---------------------------------------------------------------------------
# step_render — fused step + ARGB pack, one dispatch per frame

@partial(jax.jit, static_argnames=("knobs",))
def _step_render_core(s: EngineState, knobs=()):
    s = _step_core(s, knobs=knobs)
    return s, _render_core(s.img, s.width, s.height, s.subsampling)


def step_render(s: EngineState):
    """step() + render() fused into ONE executable: returns
    (new_state, (h, w) uint32 ARGB framebuffer).

    The interactive loop (liblys.c:104-123) calls step then render every
    frame; the separate render launch is pure overhead. Fusing
    them preserves both entry points' exact semantics while making the
    per-frame device traffic one dispatch + one framebuffer fetch — the
    reference's one-transfer-per-frame discipline (SURVEY.md 2.4)."""
    if s.img.shape[:2] != (s.sub_dims[1], s.sub_dims[0]):
        s = s.replace(img=jnp.zeros(
            (s.sub_dims[1], s.sub_dims[0], 3), jnp.float32))
    return _step_render_core(s, knobs=integrator.knob_key())


# ---------------------------------------------------------------------------
# resize (lib.fut:108-109)

def resize(h: int, w: int, s: EngineState) -> EngineState:
    """Swap dimensions and drop accumulation. (The image buffer is zeroed
    because array shapes are static under jit; the reference keeps the
    stale buffer but immediately re-renders, lib.fut:108-109.)"""
    s = s.replace(width=int(w), height=int(h), mode=jnp.asarray(False))
    ws, hs = s.sub_dims
    return s.replace(img=jnp.zeros((hs, ws, 3), jnp.float32))


# ---------------------------------------------------------------------------
# key (lib.fut:120-185)

def _reset(s: EngineState) -> EngineState:
    return s.replace(n_frames=jnp.uint32(0))


def _cycle_conf(s: EngineState) -> EngineState:
    """'t' cycles sensor configs 0 -> 1 -> 2 -> 0 (lib.fut:168-179)."""
    next_id = {0: 1, 1: 2}.get(s.cam_conf_id, 0)
    conf, render_mode, transmitter_kind = sensors.conf_for_id(next_id)
    s = s.replace(cam_conf_id=next_id, render_mode=render_mode,
                  transmitter_kind=transmitter_kind,
                  cam=s.cam._replace(conf=conf))
    return _reset(s)


def key(event: int, keycode: int, s: EngineState) -> EngineState:
    """Runtime UI state machine, host-side (semantics of lib.fut:120-185;
    the reference interprets keycodes on-device, ours is O(1) host work)."""
    if event != keys.KEYDOWN:
        return s

    moves = {keys.SDLK_w: (0, 0, 1), keys.SDLK_s: (0, 0, -1),
             keys.SDLK_a: (-1, 0, 0), keys.SDLK_d: (1, 0, 0),
             keys.SDLK_x: (0, 1, 0), keys.SDLK_z: (0, -1, 0)}
    turns = {keys.SDLK_UP: (-0.1, 0.0), keys.SDLK_DOWN: (0.1, 0.0),
             keys.SDLK_RIGHT: (0.0, 0.1), keys.SDLK_LEFT: (0.0, -0.1)}

    if keycode in moves:
        return _reset(s.replace(cam=cam_mod.move_camera(s.cam, moves[keycode])))
    if keycode in turns:
        dp, dy = turns[keycode]
        return _reset(s.replace(cam=cam_mod.turn_camera(s.cam, dp, dy)))
    if keycode == keys.SDLK_2:
        return _reset(s.replace(subsampling=s.subsampling + 1))
    if keycode == keys.SDLK_1:
        return _reset(s.replace(subsampling=max(1, s.subsampling - 1)))
    if keycode == keys.SDLK_SPACE:
        return _reset(s.replace(mode=~s.mode))
    if keycode == keys.SDLK_n:
        return _reset(s.replace(mode=jnp.asarray(False)))
    if keycode == keys.SDLK_m:
        return s.replace(mode=jnp.asarray(True))
    conf = s.cam.conf
    if keycode == keys.SDLK_i:  # aperture +0.08 clamp 2 (no accum reset)
        c = conf._replace(aperture=jnp.minimum(2.0, conf.aperture + 0.08))
        return s.replace(cam=s.cam._replace(conf=c))
    if keycode == keys.SDLK_k:
        c = conf._replace(aperture=jnp.maximum(0.0, conf.aperture - 0.08))
        return s.replace(cam=s.cam._replace(conf=c))
    if keycode == keys.SDLK_o:  # focal distance x1.14
        c = conf._replace(focal_dist=conf.focal_dist * 1.14)
        return s.replace(cam=s.cam._replace(conf=c))
    if keycode == keys.SDLK_l:
        c = conf._replace(focal_dist=jnp.maximum(0.1, conf.focal_dist / 1.14))
        return s.replace(cam=s.cam._replace(conf=c))
    if keycode == keys.SDLK_t:
        return _cycle_conf(s)
    if keycode == keys.SDLK_p:  # toggle sky (no accum reset, lib.fut:180-183)
        dark = s.ambience[0, 1] == 0
        sky = jnp.asarray(spec.bright_blue_sky(), jnp.float32)
        off = jnp.asarray(spec.uniform_spectrum(0.0), jnp.float32)
        return s.replace(ambience=jnp.where(dark, sky, off))
    return s


# ---------------------------------------------------------------------------
# sample_n_frames (lib.fut:67-74)

@partial(jax.jit, static_argnames=("spp", "knobs"))
def _render_pooled_core(s: EngineState, nonce, spp: int, knobs=()):
    w, h = s.sub_dims
    out = integrator.render_pooled(
        s.seed, nonce, s.scene, s.cam, s.ambience, w, h,
        s.transmitter_kind, spp, s.render_mode)
    return out["img"]


def sample_n_frames(s: EngineState, n: int):
    """Offline progressive render over n frames, returns the
    (h_sub, w_sub, 3) f32 image (lib.fut:67-74).

    Runs on the occupancy-optimal pooled wavefront: the reference's EMA
    chain reduces to the mean of frames 2..n (the n_frames=1 merge
    discards frame 1, integrator.fut:190-192), and the pool draws exactly
    the camera-sample streams those frames would use."""
    n = int(n)
    knobs = integrator.knob_key()
    if n <= 1:
        return _render_pooled_core(s, s.nonce, 1, knobs=knobs)
    return _render_pooled_core(s, s.nonce + jnp.uint32(1), n - 1,
                               knobs=knobs)


# ---------------------------------------------------------------------------
# sample_points_n (lib.fut:35-63)

@partial(jax.jit, static_argnames=("spp", "knobs"))
def _sample_points_core(s: EngineState, spp: int, knobs=()):
    w, h = s.sub_dims
    out = integrator.render_pooled(
        s.seed, s.nonce, s.scene, s.cam, s.ambience, w, h,
        s.transmitter_kind, spp, s.render_mode, with_points=True)
    pos, dist, inten = out["points"]
    points = jnp.concatenate([la.v3_to_array(pos), inten[:, None]], axis=-1)
    return s.replace(nonce=s.nonce + jnp.uint32(spp)), points.reshape(h, w, 4)


def sample_points_n(s: EngineState, samples_per_pixel: int):
    """LiDAR batch capture: spp wavefronts, closest valid return per pixel
    in the [0.5, 10) window, intensity scaled by 1/spp (lib.fut:35-63).
    Returns (new_state, (h, w, 4) f32 [x, y, z, intensity])."""
    return _sample_points_core(s, int(samples_per_pixel),
                               knobs=integrator.knob_key())
