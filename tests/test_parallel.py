"""Multi-device sharding on the virtual 8-device CPU mesh: tile sharding
must match one device; sample sharding must average."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tracer_tpu as T
from tracer_tpu.engine import integrator
from tracer_tpu.parallel import render as par
from tracer_tpu.utils import testscenes


def cornell_state(h=32, w=32):
    tris, tm, mats = testscenes.cornell_like()
    return T.init(0, h, w, 0, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8))


@pytest.mark.smoke
def test_tile_sharding_bit_identical(devices8):
    s = cornell_state(32, 32)
    mesh = par.make_mesh(8, 1)
    sharded = par.step_sharded(s, mesh)
    single = T.step(s)
    np.testing.assert_allclose(np.asarray(sharded.img),
                               np.asarray(single.img), rtol=1e-5, atol=1e-6)


def test_sample_sharding_averages(devices8):
    s = cornell_state(32, 32)
    mesh = par.make_mesh(4, 2)
    sharded = par.step_sharded(s, mesh)
    # single-chip frames with the two replica nonces
    w, h = s.sub_dims
    frames = []
    for si in range(2):
        samples = integrator.sample_pixels(
            s.seed, s.nonce * jnp.uint32(2) + jnp.uint32(si), s.scene,
            s.cam, s.ambience, w, h, s.transmitter_kind)
        frames.append(np.asarray(integrator.visualize(
            samples, s.render_mode, s.cam.conf.sensor_color, w, h)))
    want = (frames[0] + frames[1]) / 2
    np.testing.assert_allclose(np.asarray(sharded.img), want,
                               rtol=1e-4, atol=1e-5)


def test_pooled_sharded_matches_single(devices8):
    """Tile x sample sharded pooled render == single-chip pooled render
    over the same sample streams (pmean of per-replica means == global
    mean because every replica runs the same spp_local)."""
    s = cornell_state(32, 32)
    mesh = par.make_mesh(4, 2)
    got = np.asarray(par.render_pooled_sharded(s, mesh, spp=4))
    w, h = s.sub_dims
    out = integrator.render_pooled(
        s.seed, s.nonce, s.scene, s.cam, s.ambience, w, h,
        s.transmitter_kind, 4, s.render_mode)
    np.testing.assert_allclose(got, np.asarray(out["img"]),
                               rtol=1e-4, atol=1e-5)


def test_sharded_step_does_not_retrace(devices8):
    """Repeated step_sharded / render_pooled_sharded calls must reuse one
    cached jitted executable. The jit cache is
    allowed exactly one extra specialization — the first call takes
    single-device-sharded init arrays and returns NamedSharding-committed
    ones — but it must STOP growing from the second call on (no per-call
    retrace)."""
    s = cornell_state(32, 32).replace(mode=jnp.asarray(True))
    mesh = par.make_mesh(8, 1)
    run1 = par._step_exec(mesh, *s.sub_dims, s.transmitter_kind,
                          s.render_mode, par._knob_key())
    s1 = par.step_sharded(s, mesh)
    s2 = par.step_sharded(s1, mesh)
    size2 = run1._cache_size()
    s3 = par.step_sharded(s2, mesh)
    run2 = par._step_exec(mesh, *s.sub_dims, s.transmitter_kind,
                          s.render_mode, par._knob_key())
    assert run1 is run2
    assert size2 <= 2
    assert run1._cache_size() == size2  # stabilized: no per-call retrace
    assert int(s3.n_frames) == 3

    par.render_pooled_sharded(s, mesh, spp=2)
    par.render_pooled_sharded(s, mesh, spp=2)
    pe = par._pooled_exec(mesh, *s.sub_dims, s.sub_dims[1] // 8, 2,
                          s.transmitter_kind, s.render_mode,
                          par._knob_key())
    assert pe._cache_size() == 1


def test_knob_key_covers_trace_knobs(monkeypatch):
    """Every env knob that changes the traced graph must be part of the
    cached-executable key, or a later call with a different setting
    silently reuses the stale executable. Pin the full documented knob
    list (docs/PARITY.md config/flags row) minus the non-trace ones.
    Each knob is compared between two set values so an ambient setting
    in the invoking shell cannot make the assertion vacuous."""
    for knob in ("TRACER_POOL_TARGET", "TRACER_ROT_Q", "TRACER_STEAL_D"):
        monkeypatch.setenv(knob, "__a__")
        k1 = par._knob_key()
        monkeypatch.setenv(knob, "__b__")
        assert par._knob_key() != k1, knob


@pytest.mark.smoke
def test_graft_dryrun(devices8):
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_points_merge_tie_keeps_newest_whole_point(devices8):
    """Cross-replica exact-distance ties must keep the NEWEST replica's
    entire point (lib.fut:49-51 keeps p2, the new sample) — never a
    coordinate-wise max of two different returns."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    mesh = par.make_mesh(1, 8)
    n = 4
    # replica si: pixel 0 ties at d=1.0 on replicas 2 and 5 with
    # *different* positions; pixel 1 has a unique min on replica 3;
    # pixel 2 is a miss everywhere; pixel 3 ties on ALL replicas.
    def body(_):
        si = jax.lax.axis_index(par.SAMPLE_AXIS)
        sif = si.astype(jnp.float32)
        dist = jnp.full((n,), jnp.inf)
        dist = dist.at[0].set(jnp.where((si == 2) | (si == 5), 1.0, 2.0))
        dist = dist.at[1].set(jnp.where(si == 3, 0.5, 3.0))
        dist = dist.at[3].set(7.0)
        # position encodes the replica: replica si reports (si, -si, 10+si)
        pos = jnp.stack([jnp.full((n,), sif), jnp.full((n,), -sif),
                         jnp.full((n,), 10.0 + sif)])
        inten = jnp.full((n,), 100.0 + sif)
        p, i, d = par.merge_points_newest(pos, dist, inten, si)
        return p, i, d

    fn = shard_map(body, mesh=mesh, in_specs=(P(),), out_specs=P(),
                   check_vma=False)
    pos, inten, best_d = jax.jit(fn)(jnp.zeros(()))
    pos, inten, best_d = map(np.asarray, (pos, inten, best_d))
    # pixel 0: replicas 2 and 5 tie -> newest (5) wins, point is
    # exactly replica 5's (5, -5, 15), not a coordinate-wise max
    assert best_d[0] == 1.0
    np.testing.assert_array_equal(pos[:, 0], [5.0, -5.0, 15.0])
    assert inten[0] == 105.0
    # pixel 1: unique min on replica 3
    assert best_d[1] == 0.5
    np.testing.assert_array_equal(pos[:, 1], [3.0, -3.0, 13.0])
    # pixel 2: miss everywhere -> inf distance (callers mask on it)
    assert np.isinf(best_d[2])
    # pixel 3: all replicas tie -> newest (7) wins
    np.testing.assert_array_equal(pos[:, 3], [7.0, -7.0, 17.0])
    assert inten[3] == 107.0


def test_points_sharded_matches_single(devices8):
    tris, tm, mats = testscenes.cornell_like()
    s = T.init(0, 16, 16, 2, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8))
    mesh = par.make_mesh(4, 2)
    got = np.asarray(par.sample_points_sharded(s, mesh, spp=4))
    _, want = T.sample_points_n(s, 4)
    want = np.asarray(want)
    np.testing.assert_allclose(got[..., :3], want[..., :3],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[..., 3], want[..., 3],
                               rtol=1e-4, atol=1e-6)
