#!/usr/bin/env python
"""Interactive viewer — the demo-interactive equivalent (reference
demo-interactive/liblys.c).

Same loop shape as the reference's SDL frontend: per frame step() ->
render() -> blit, with key events forwarded to the engine's key entry
point (keycode interpretation lives in the engine, liblys.c:104-123).
Keymap (README.org:54-67): WASD/XZ move, arrows look, SPACE/n/m
accumulation, 1/2 subsampling, i/k aperture, o/l focal distance,
t sensor config, p sky.

CLI mirrors liblys.c:252-269: -o OBJ scene, -w/-h window size, plus
--frames/--out for headless captures (SDL dummy video driver).
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
    ap = argparse.ArgumentParser(description="tracer_tpu interactive viewer")
    ap.add_argument("-o", "--obj", default=os.path.join(
        os.environ.get("TRACER_ASSETS", "/root/reference/assets"),
        "CornellBox-Original.obj"))
    ap.add_argument("-W", "--width", type=int, default=800)
    ap.add_argument("-H", "--height", type=int, default=600)
    ap.add_argument("-c", "--conf", type=int, default=0,
                    help="sensor config id (0 visual, 1 flash, 2 lidar)")
    ap.add_argument("--frames", type=int, default=0,
                    help="render N frames then exit (0 = run until quit)")
    ap.add_argument("--out", default=None, help="PNG path on exit")
    ap.add_argument("--headless", action="store_true",
                    help="no window (SDL dummy driver)")
    ap.add_argument("-d", "--device", default=None,
                    help="compute device: a jax platform name ('gpu', "
                    "'cpu') or 'platform:N' to pick device N — the -d "
                    "DEVICE option of the reference viewer "
                    "(liblys.c:166-209)")
    args = ap.parse_args()

    if args.device:
        plat, _, idx = args.device.partition(":")
        if plat:
            import jax
            jax.config.update("jax_platforms", plat.lower())
        if idx:
            import jax
            jax.config.update("jax_default_device",
                              jax.devices()[int(idx)])

    if args.headless or not os.environ.get("DISPLAY"):
        os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

    import pygame
    import tracer_tpu as T
    from tracer_tpu.engine import keys as K
    from tracer_tpu.utils.objloader import load_obj
    from tracer_tpu.utils.image import argb_to_rgb, write_png

    tris, tm, mats = load_obj(args.obj, verbose=True)

    # device banner, the liblys.c:195-207 "Using OpenCL device" analog
    import jax
    dev = jax.devices()[0]
    print(f"Using {dev.platform} device: {dev.device_kind} (id {dev.id})")
    print("Use -d to change this.")

    # default camera placement as in the reference viewer (liblys.c:133-136)
    state = T.init(0, args.height, args.width, args.conf, tris, tm, mats,
                   cam_origin=(0.0, 0.8, 1.8))

    pygame.init()
    screen = pygame.display.set_mode((args.width, args.height))
    pygame.display.set_caption("tracer_tpu")

    frame_count = 0
    fps_t0 = time.perf_counter()
    running = True
    while running:
        for ev in pygame.event.get():
            if ev.type == pygame.QUIT:
                running = False
            elif ev.type in (pygame.KEYDOWN, pygame.KEYUP):
                if ev.key == pygame.K_ESCAPE:
                    running = False
                e = K.KEYDOWN if ev.type == pygame.KEYDOWN else K.KEYUP
                state = T.key(e, ev.key, state)
            elif ev.type == pygame.VIDEORESIZE:
                state = T.resize(ev.h, ev.w, state)

        state = T.step(state)
        fb = np.asarray(T.render(state))          # (h, w) ARGB u32
        rgb = argb_to_rgb(fb)
        surf = pygame.surfarray.make_surface(rgb.swapaxes(0, 1))
        screen.blit(surf, (0, 0))
        pygame.display.flip()

        frame_count += 1
        if frame_count % 32 == 0:
            dt = time.perf_counter() - fps_t0
            fps_t0 = time.perf_counter()
            pygame.display.set_caption(
                f"tracer_tpu — {32 / dt:.1f} fps, "
                f"{int(state.n_frames)} accumulated")
        if args.frames and frame_count >= args.frames:
            running = False

    if args.out:
        write_png(args.out, argb_to_rgb(np.asarray(T.render(state))))
        print(f"wrote {args.out}")
    pygame.quit()


if __name__ == "__main__":
    main()
