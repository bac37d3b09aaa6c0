"""Engine-level behavior: furnace identity, Cornell statistics, LiDAR
returns, accumulation semantics, key state machine, ARGB packing."""

import numpy as np
import jax.numpy as jnp
import pytest

import tracer_tpu as T
from tracer_tpu.engine import integrator, keys
from tracer_tpu.ops import spectrum as spec
from tracer_tpu.utils import testscenes
from tracer_tpu.utils.image import argb_to_rgb
from tracer_tpu.utils.pcd import write_pcd


def cornell_state(h=32, w=32, conf=0):
    tris, tm, mats = testscenes.cornell_like()
    return T.init(0, h, w, conf, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8))


def empty_state(h=16, w=16):
    tris = np.zeros((0, 3, 3), np.float32)
    return T.init(0, h, w, 0, tris, np.zeros((0,), np.uint32),
                  np.zeros((0, 28), np.float32), accel="dense")


def test_white_furnace_ambience():
    """Empty scene + uniform ambience: every primary ray records the
    ambience; expected pixel value over channels is exactly (1,1,1)
    (miss path integrator.fut:76 + x3-channel scaling :163-168)."""
    s = empty_state()
    s = s.replace(ambience=jnp.asarray(spec.uniform_spectrum(1.0)))
    img = np.asarray(T.sample_n_frames(s, 600))
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), [1, 1, 1], atol=0.05)


@pytest.mark.smoke
def test_cornell_statistics():
    s = cornell_state()
    img = np.asarray(T.sample_n_frames(s, 48))
    assert np.isfinite(img).all()
    assert img.max() > 0.5          # light visible
    assert img.mean() > 0.02
    # wall tint: the red/green balance must swing red on the left edge
    # and green on the right edge (robust to the warm light color)
    left = img[:, :10]
    right = img[:, -10:]
    assert left[..., 0].mean() > 1.5 * left[..., 1].mean()
    rg_right = right[..., 1].mean() - right[..., 0].mean()
    rg_left = left[..., 1].mean() - left[..., 0].mean()
    assert rg_right > rg_left + 0.01


def test_determinism_and_stream_advance():
    s = cornell_state()
    a = np.asarray(T.step(s).img)
    b = np.asarray(T.step(s).img)
    np.testing.assert_array_equal(a, b)  # same seed+nonce -> identical
    c = np.asarray(T.step(T.step(s)).img)
    assert not np.array_equal(a, c)      # advanced nonce -> new noise


def test_accumulation_reduces_variance():
    s = cornell_state()
    one = np.asarray(T.sample_n_frames(s, 2))
    many = np.asarray(T.sample_n_frames(s, 64))
    assert many.std() < one.std()


def test_accumulation_ema_semantics():
    """step's accumulation uses the pre-increment count and so discards
    the first frame (lib.fut:111-118 + integrator.fut:190-192)."""
    s = cornell_state(8, 8)
    s = s.replace(mode=jnp.asarray(True))
    s1 = T.step(s)             # fresh, n_frames=1
    s2 = T.step(s1)            # accum with n=1: img == frame2 exactly
    assert int(s2.n_frames) == 2
    # frame 2 rendered standalone from the same nonce
    lone = T.step(s.replace(nonce=s1.nonce))
    np.testing.assert_allclose(np.asarray(s2.img), np.asarray(lone.img),
                               rtol=1e-5, atol=1e-6)


def test_pooled_matches_per_frame_mean():
    """The pooled wavefront draws the exact per-frame sample streams, so
    pooled spp=2 must equal the mean of the two 1-spp frames."""
    s = cornell_state(24, 24)
    w, h = s.sub_dims
    frames = []
    for k in range(2):
        samples = integrator.sample_pixels(
            s.seed, s.nonce + jnp.uint32(k), s.scene, s.cam, s.ambience,
            w, h, s.transmitter_kind)
        frames.append(np.asarray(integrator.visualize(
            samples, s.render_mode, s.cam.conf.sensor_color, w, h)))
    want = (frames[0] + frames[1]) / 2
    out = integrator.render_pooled(
        s.seed, s.nonce, s.scene, s.cam, s.ambience, w, h,
        s.transmitter_kind, 2, s.render_mode)
    np.testing.assert_allclose(np.asarray(out["img"]), want,
                               rtol=1e-4, atol=1e-5)


def test_pooled_lidar_matches_per_frame():
    """Pooled LiDAR capture reproduces the per-frame closest-return merge."""
    s = cornell_state(12, 12, conf=2)
    w, h = s.sub_dims
    spp = 4
    best = None
    for k in range(spp):
        samples = integrator.sample_pixels(
            s.seed, s.nonce + jnp.uint32(k), s.scene, s.cam, s.ambience,
            w, h, s.transmitter_kind)
        cloud = integrator.to_cloud_points(samples)
        pos, dist, inten = integrator.closest_return(cloud, 1.0 / spp)
        if best is None:
            best = (np.asarray(pos), np.asarray(dist), np.asarray(inten))
        else:
            keep = best[1] < np.asarray(dist)
            best = (np.where(keep, best[0], np.asarray(pos)),
                    np.where(keep, best[1], np.asarray(dist)),
                    np.where(keep, best[2], np.asarray(inten)))
    out = integrator.render_pooled(
        s.seed, s.nonce, s.scene, s.cam, s.ambience, w, h,
        s.transmitter_kind, spp, s.render_mode, with_points=True)
    pos, dist, inten = map(np.asarray, out["points"])
    np.testing.assert_allclose(dist, best[1], rtol=1e-4)
    np.testing.assert_allclose(pos, best[0], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(inten, best[2], rtol=1e-3, atol=1e-6)


def test_lidar_points_window():
    s = cornell_state(16, 16, conf=2)
    s2, pts = T.sample_points_n(s, 8)
    pts = np.asarray(pts)
    assert pts.shape == (16, 16, 4)
    inten = pts[..., 3]
    hit = inten > 0
    assert hit.any()
    # all reported returns lie inside the [0.5, 10) distance window from
    # the camera origin (lib.fut:40-47)
    dist = np.linalg.norm(pts[..., :3] - np.array([0, 0.8, 1.8]), axis=-1)
    assert (dist[hit] > 0.4).all() and (dist[hit] < 10.1).all()
    # misses encoded as (-1,-1,-1, 0)
    assert (pts[~hit][:, :3] == -1).all()
    assert int(s2.nonce) == int(s.nonce) + 8


def test_lidar_render_mode():
    s = cornell_state(16, 16, conf=2)
    s = T.step(s)
    img = np.asarray(s.img)
    assert np.isfinite(img).all()
    assert img.max() <= 1.0 + 1e-6  # hue colors are in [0,1]


def test_pcd_writer(tmp_path):
    pts = np.random.default_rng(0).normal(size=(4, 4, 4)).astype(np.float32)
    p = tmp_path / "t.pcd"
    write_pcd(str(p), pts)
    txt = p.read_text().splitlines()
    assert txt[2] == "FIELDS x y z intensity"
    assert txt[9] == "POINTS 16"
    assert len(txt) == 11 + 16


@pytest.mark.smoke
def test_render_packs_argb():
    s = cornell_state(8, 8)
    s = s.replace(img=jnp.full((8, 8, 3), 0.5, jnp.float32))
    fb = np.asarray(T.render(s))
    assert fb.dtype == np.uint32 and fb.shape == (8, 8)
    rgb = argb_to_rgb(fb)
    assert (rgb == 127).all()
    assert ((fb >> 24) == 255).all()
    # clamping
    s = s.replace(img=jnp.full((8, 8, 3), 7.0, jnp.float32))
    assert (argb_to_rgb(np.asarray(T.render(s))) == 255).all()


@pytest.mark.smoke
def test_key_state_machine():
    s = cornell_state(8, 8)
    # subsampling up/down (lib.fut:123-128)
    s2 = T.key(keys.KEYDOWN, keys.SDLK_2, s)
    assert s2.subsampling == 2 and int(s2.n_frames) == 0
    s3 = T.key(keys.KEYDOWN, keys.SDLK_1, s2)
    assert s3.subsampling == 1
    assert T.key(keys.KEYDOWN, keys.SDLK_1, s3).subsampling == 1  # floor 1
    # movement resets accumulation and moves the camera
    s4 = T.key(keys.KEYDOWN, keys.SDLK_w, s.replace(n_frames=jnp.uint32(5)))
    assert int(s4.n_frames) == 0
    assert not np.allclose(np.asarray(s4.cam.origin), np.asarray(s.cam.origin))
    # key-up events ignored
    s5 = T.key(keys.KEYUP, keys.SDLK_w, s)
    assert np.allclose(np.asarray(s5.cam.origin), np.asarray(s.cam.origin))
    # mode toggles
    assert bool(T.key(keys.KEYDOWN, keys.SDLK_SPACE, s).mode)
    assert bool(T.key(keys.KEYDOWN, keys.SDLK_m, s).mode)
    assert not bool(T.key(keys.KEYDOWN, keys.SDLK_n,
                          s.replace(mode=jnp.asarray(True))).mode)
    # aperture clamp [0, 2], no accumulation reset (lib.fut:156-161)
    s6 = s.replace(n_frames=jnp.uint32(3))
    for _ in range(30):
        s6 = T.key(keys.KEYDOWN, keys.SDLK_i, s6)
    assert float(s6.cam.conf.aperture) <= 2.0 + 1e-6
    assert int(s6.n_frames) == 3
    # focal floor 0.1
    s7 = s
    for _ in range(40):
        s7 = T.key(keys.KEYDOWN, keys.SDLK_l, s7)
    assert float(s7.cam.conf.focal_dist) >= 0.1 - 1e-6
    # sensor cycle 0 -> 1 -> 2 -> 0 (lib.fut:168-179)
    s8 = T.key(keys.KEYDOWN, keys.SDLK_t, s)
    assert s8.cam_conf_id == 1 and s8.render_mode == "color"
    s9 = T.key(keys.KEYDOWN, keys.SDLK_t, s8)
    assert s9.cam_conf_id == 2 and s9.render_mode == "distance"
    s10 = T.key(keys.KEYDOWN, keys.SDLK_t, s9)
    assert s10.cam_conf_id == 0
    # sky toggle (lib.fut:180-183)
    s11 = T.key(keys.KEYDOWN, keys.SDLK_p, s)
    assert float(s11.ambience[0, 1]) > 0
    s12 = T.key(keys.KEYDOWN, keys.SDLK_p, s11)
    assert float(s12.ambience[0, 1]) == 0
    # pitch clamp
    s13 = s
    for _ in range(40):
        s13 = T.key(keys.KEYDOWN, keys.SDLK_UP, s13)
    assert abs(float(s13.cam.pitch)) <= np.pi / 2 + 1e-6


def test_resize():
    s = cornell_state(16, 16)
    s2 = T.resize(24, 20, s)
    assert (s2.height, s2.width) == (24, 20)
    assert not bool(s2.mode)
    s3 = T.step(s2)
    assert s3.img.shape == (24, 20, 3)
    assert np.asarray(T.render(s3)).shape == (24, 20)


def test_subsampled_step_and_render():
    s = cornell_state(16, 16)
    s = T.key(keys.KEYDOWN, keys.SDLK_2, s)  # subsampling 2
    s = T.step(s)
    assert s.img.shape == (8, 8, 3)
    fb = np.asarray(T.render(s))
    assert fb.shape == (16, 16)
    # nearest-neighbour: 2x2 blocks identical
    assert (fb[::2, ::2] == fb[1::2, 1::2]).all()


def test_checkpoint_roundtrip(tmp_path):
    """The whole engine state is a pytree: flatten -> savez -> restore."""
    import jax
    s = T.step(cornell_state(8, 8))
    leaves, treedef = jax.tree.flatten(s)
    np.savez(tmp_path / "ckpt.npz", *[np.asarray(l) for l in leaves])
    loaded = np.load(tmp_path / "ckpt.npz")
    restored = jax.tree.unflatten(
        treedef, [jnp.asarray(loaded[k]) for k in loaded.files])
    s2 = T.step(s)
    s2r = T.step(restored)
    np.testing.assert_array_equal(np.asarray(s2.img), np.asarray(s2r.img))


def test_flash_transmitter_adds_light():
    """conf 1 adds a blackbody flash at the camera: with the ceiling light
    removed, a flash-lit render must be substantially brighter than an
    unlit one (gen_transmitter, camera.fut:112-122)."""
    tris, tm, mats = testscenes.cornell_like()
    mats = mats.copy()
    mats[4, 16:28] = [-1, 0] * 6  # kill the area light's emission
    dark = T.init(0, 16, 16, 0, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8))
    lit = T.init(0, 16, 16, 1, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8))
    img_dark = np.asarray(T.sample_n_frames(dark, 24))
    img_lit = np.asarray(T.sample_n_frames(lit, 24))
    assert img_dark.mean() < 1e-4          # nothing emits
    assert img_lit.mean() > 10 * max(img_dark.mean(), 1e-6)


def test_scanning_transmitter_lights_lidar():
    """conf 2's scanning cone is the only light for LiDAR returns when
    scene emission is removed; returns must still appear (active sensing)."""
    tris, tm, mats = testscenes.cornell_like()
    mats = mats.copy()
    mats[4, 16:28] = [-1, 0] * 6
    s = T.init(0, 16, 16, 2, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8))
    _, pts = T.sample_points_n(s, 8)
    pts = np.asarray(pts)
    assert (pts[..., 3] > 0).mean() > 0.3


def test_point_light_api():
    """add_point_light: a point light illuminates an otherwise dark box
    (the #pointlight branch of the light table, light.fut:10)."""
    from tracer_tpu.models import scene as SM
    from tracer_tpu.ops import spectrum as sp
    tris, tm, mats = testscenes.cornell_like()
    mats = mats.copy()
    mats[4, 16:28] = [-1, 0] * 6  # no area light
    s = T.init(0, 12, 12, 0, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8))
    dark = np.asarray(T.sample_n_frames(s, 16))
    lit_scene = SM.add_point_light(
        s.scene, (0.0, 1.5, 0.3),
        sp.map_intensities(lambda i: i * 8.0, sp.uniform_spectrum(1.0)))
    s2 = s.replace(scene=lit_scene)
    lit = np.asarray(T.sample_n_frames(s2, 16))
    assert dark.mean() < 1e-4
    assert lit.mean() > 0.01


def test_prism_scene_disperses():
    """The prism golden scene produces finite, colored output with the
    dispersion hack active (hero wavelengths refract differently)."""
    tris, tm, mats = testscenes.prism_scene()
    s = T.init(0, 24, 24, 0, tris, tm, mats, cam_origin=(0.0, 0.9, 2.6))
    img = np.asarray(T.sample_n_frames(s, 24))
    assert np.isfinite(img).all()
    assert img.max() > 0.05
    # channel separation somewhere in the image (spectral, not grayscale)
    sat = np.abs(img - img.mean(axis=-1, keepdims=True)).max()
    assert sat > 0.01


def test_pool_size_invariance(monkeypatch):
    """The work-item schedule draws identical per-pixel sample sets for
    any pool size P | n: the pool is a scheduling choice, not an
    estimator parameter (integrator._pool_size). At spp <= ROT_Q every
    Q-rotation phase row holds one sample, so the P == n path is
    BITWISE equal to the store path; at spp > ROT_Q the phase-major
    accumulation reassociates the per-pixel f32 sum, so equality is to
    float tolerance only."""
    s = cornell_state(16, 16)
    w, h = s.sub_dims

    def render(target, spp=4):
        if target:
            monkeypatch.setenv("TRACER_POOL_TARGET", str(target))
        else:
            monkeypatch.delenv("TRACER_POOL_TARGET", raising=False)
        return integrator.render_pooled(
            s.seed, s.nonce, s.scene, s.cam, s.ambience, w, h,
            s.transmitter_kind, spp, s.render_mode)

    full = np.asarray(render(None)["img"])
    for target in (64, 32):
        small = np.asarray(render(target)["img"])
        np.testing.assert_array_equal(small, full)

    # spp > ROT_Q: same samples, reassociated sum
    full20 = np.asarray(render(None, spp=20)["img"])
    small20 = np.asarray(render(64, spp=20)["img"])
    np.testing.assert_allclose(small20, full20, rtol=1e-4, atol=1e-6)

    # LiDAR mode: points and distance visualization too
    s2 = cornell_state(12, 12, conf=2)
    w2, h2 = s2.sub_dims

    def render_pts(target):
        if target:
            monkeypatch.setenv("TRACER_POOL_TARGET", str(target))
        else:
            monkeypatch.delenv("TRACER_POOL_TARGET", raising=False)
        return integrator.render_pooled(
            s2.seed, s2.nonce, s2.scene, s2.cam, s2.ambience, w2, h2,
            s2.transmitter_kind, 4, s2.render_mode, with_points=True)

    a = render_pts(None)
    b = render_pts(36)
    np.testing.assert_array_equal(np.asarray(a["img"]), np.asarray(b["img"]))
    for pa, pb in zip(a["points"], b["points"]):
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


def test_ring_stealing_equivalence(monkeypatch):
    """Ring work-stealing (TRACER_STEAL_D) is a pure scheduling change:
    per-item RNG streams depend only on (sample, pixel), so the stolen
    schedule draws the exact same sample set — rays_traced is exactly
    equal at this size (at millions of samples the two differently-fused
    graphs can flip a borderline RR draw: measured 3 items in 262k, with
    chan_st — integer, fusion-immune — slot-identical), images equal to
    float tolerance, and total iterations must not increase (that is the
    point: idle lanes drain straggler backlogs)."""
    s = cornell_state(16, 16)
    w, h = s.sub_dims

    def render(steal, target=None, spp=4, mode="color", pts=False):
        if target:
            monkeypatch.setenv("TRACER_POOL_TARGET", str(target))
        else:
            monkeypatch.delenv("TRACER_POOL_TARGET", raising=False)
        monkeypatch.setenv("TRACER_STEAL_D", str(steal))
        return integrator.render_pooled(
            s.seed, s.nonce, s.scene, s.cam, s.ambience, w, h,
            s.transmitter_kind, spp, mode, with_points=pts)

    for target in (None, 64):  # qrot (P == n) and the store path (P < n)
        a = render(0, target)
        b = render(3, target)
        np.testing.assert_allclose(np.asarray(b["img"]),
                                   np.asarray(a["img"]),
                                   rtol=1e-4, atol=1e-6)
        assert int(a["rays_traced"]) == int(b["rays_traced"])
        assert int(b["iters"]) <= int(a["iters"])

    # LiDAR distance + points modes through the same arbitration
    a = render(0, 64, mode="distance", pts=True)
    b = render(3, 64, mode="distance", pts=True)
    np.testing.assert_allclose(np.asarray(b["img"]), np.asarray(a["img"]),
                               rtol=1e-4, atol=1e-6)
    for pa, pb in zip(a["points"], b["points"]):
        pa, pb = np.asarray(pa), np.asarray(pb)
        fin = np.isfinite(pa)
        assert (fin == np.isfinite(pb)).all()
        np.testing.assert_allclose(pb[fin], pa[fin], rtol=1e-4, atol=1e-6)


def test_thin_lens_focal_plane_convergence():
    """Aperture > 0 thin-lens geometry (camera.fut:81-110): all rays for
    one pixel, wherever they leave the lens disk, must converge on the
    focal plane — the spread of focal-plane hit points at aperture 0.5
    equals the pixel-jitter footprint at aperture 0, while the ray
    origins spread across the lens. Pins the defocus estimator around
    the documented deviation (independent pixel/lens uniforms vs the
    reference's rng reuse, camera.fut:86-102): the marginal per-ray
    distribution the estimator integrates is unchanged."""
    from tracer_tpu.models import camera as cam_mod
    from tracer_tpu.ops import linalg as la
    from tracer_tpu.ops import rng as prng

    s = cornell_state(16, 16)

    def shoot(aperture, n=512):
        conf = s.cam.conf._replace(aperture=jnp.float32(aperture))
        cam = s.cam._replace(conf=conf)
        states = prng.make_streams(7, 3, jnp.arange(n, dtype=jnp.uint32))
        jx = jnp.full((n,), 5.0, jnp.float32)
        iy = jnp.full((n,), 9.0, jnp.float32)
        _, o, d = cam_mod.sample_ray(states, cam, (16.0, 16.0), jx, iy)
        cd = la.v3_from_array(cam_mod.cam_dir(cam))[:, None]   # (3,1)
        o0 = cam.origin[:, None]
        fd = conf.focal_dist
        # ray/focal-plane intersection: plane through o0 + fd*cd, normal cd
        t = (jnp.sum((o0 + fd * cd - o) * cd, 0)
             / jnp.sum(d * cd, 0))
        p = o + t * d                                          # (3,N)
        spread = float(jnp.max(jnp.std(p, axis=1)))
        o_spread = float(jnp.max(jnp.std(o, axis=1)))
        return spread, o_spread

    pin_spread, pin_o = shoot(0.0)
    blur_spread, blur_o = shoot(0.5)
    assert pin_o < 1e-6                       # pinhole: single origin
    assert blur_o > 0.05                      # lens disk really sampled
    # focal-plane footprint identical: lens offset contributes nothing
    np.testing.assert_allclose(blur_spread, pin_spread, rtol=1e-3,
                               atol=1e-5)


def test_aperture_defocus_render():
    """Rendering with aperture 0.5 (the 'i' key path, lib.fut:156-160)
    conserves energy while blurring structure: the defocused image's
    mean stays near the pinhole render's, its high-frequency content
    drops. The lens sample here reuses the jitter draws exactly like
    the reference (camera.fut:86-102 rng reuse, see camera.sample_ray);
    this test pins the distribution-level behavior of that path."""
    s = cornell_state(32, 32)
    sharp = np.asarray(T.sample_n_frames(s, 48))
    conf = s.cam.conf._replace(aperture=jnp.float32(0.5))
    s_blur = s.replace(cam=s.cam._replace(conf=conf))
    blur = np.asarray(T.sample_n_frames(s_blur, 48))
    assert np.isfinite(blur).all()
    # defocus redistributes energy, it does not create or destroy it
    # (tolerance: lens-edge rays can exit the open box face)
    np.testing.assert_allclose(blur.mean(), sharp.mean(), rtol=0.12)

    def tv(img):
        # total variation of the 2x2-box-downsampled image: keeps edges,
        # suppresses per-pixel MC noise
        d = img.reshape(16, 2, 16, 2, 3).mean(axis=(1, 3))
        return (np.abs(np.diff(d, axis=0)).mean()
                + np.abs(np.diff(d, axis=1)).mean())

    assert tv(blur) < 0.9 * tv(sharp), (tv(blur), tv(sharp))


def test_oversize_scene_fails_loudly():
    """Above the verified dense/streaming cap, accel='auto' must raise a
    clear error instead of silently routing onto the LBVH traversal."""
    from tracer_tpu.models import scene as scene_mod
    tris, tm, mats = testscenes.cornell_like()
    try:
        scene_mod.DENSE_THRESHOLD, saved = 4, scene_mod.DENSE_THRESHOLD
        with pytest.raises(ValueError, match="accel='lbvh'"):
            scene_mod.build_scene(tris, tm, mats)
        # explicit accel choices still work at any size
        scene_mod.build_scene(tris, tm, mats, accel="dense")
        scene_mod.build_scene(tris, tm, mats, accel="lbvh")
    finally:
        scene_mod.DENSE_THRESHOLD = saved


def test_lbvh_query_at_pool_width():
    """An explicit accel='lbvh' scene answers closest and shadow queries
    at a full pool width (65,536 lanes) and agrees with the dense
    intersector there."""
    from tracer_tpu.models import scene as scene_mod
    tris, tm, mats = testscenes.cornell_like()
    lb = scene_mod.build_scene(tris, tm, mats, accel="lbvh")
    dn = scene_mod.build_scene(tris, tm, mats, accel="dense")
    n = 65536
    rng = np.random.default_rng(3)
    o = jnp.asarray(rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9],
                                (n, 3)).T.astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray((d / np.linalg.norm(d, axis=1, keepdims=True)).T)
    ok_l, t_l, _, _, _ = scene_mod.closest_hit(lb, 1e30, o, d)
    ok_d, t_d, _, _, _ = scene_mod.closest_hit(dn, 1e30, o, d)
    ok_l, ok_d = np.asarray(ok_l), np.asarray(ok_d)
    assert ok_l.mean() > 0.8        # the box is open at the front
    assert (ok_l == ok_d).mean() > 0.9999
    both = ok_l & ok_d
    np.testing.assert_allclose(np.asarray(t_l)[both], np.asarray(t_d)[both],
                               rtol=1e-4, atol=1e-5)
    tmax = jnp.full((n,), 0.5, jnp.float32)
    any_l = np.asarray(scene_mod.any_hit(lb, tmax, o, d))
    any_d = np.asarray(scene_mod.any_hit(dn, tmax, o, d))
    assert (any_l == any_d).mean() > 0.9999
