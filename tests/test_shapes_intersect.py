"""Geometry kernels: elementwise Moller test, slab AABB test, and the
dense intersector cross-checked against the broadcast oracle."""

import pytest
import numpy as np
import jax.numpy as jnp

from tracer_tpu.ops import intersect, linalg as la, shapes


def random_scene(rng_np, t=37, scale=3.0):
    tris = rng_np.uniform(-scale, scale, (t, 3, 3)).astype(np.float32)
    return jnp.asarray(tris)


def random_rays(rng_np, n=65):
    o = rng_np.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.smoke
def test_hit_triangle_basic():
    tri = jnp.asarray(np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32))
    o = jnp.asarray(np.array([[0.2, 0.2, 1.0]], np.float32))
    d = jnp.asarray(np.array([[0.0, 0.0, -1.0]], np.float32))
    ok, t, pos, normal = shapes.hit_triangle(1e30, o, d, tri)
    assert bool(ok[0])
    assert np.isclose(float(t[0]), 1.0, atol=1e-5)
    assert np.allclose(np.asarray(pos[0]), [0.2, 0.2, 0.0], atol=1e-5)
    assert np.allclose(np.abs(np.asarray(normal[0])), [0, 0, 1], atol=1e-6)
    # miss: outside barycentric range
    o2 = jnp.asarray(np.array([[2.0, 2.0, 1.0]], np.float32))
    ok2, t2, _, _ = shapes.hit_triangle(1e30, o2, d, tri)
    assert not bool(ok2[0]) and np.isinf(float(t2[0]))
    # behind the origin
    ok3, _, _, _ = shapes.hit_triangle(1e30, o, -d, tri)
    assert not bool(ok3[0])


def test_hit_aabb_basic():
    amin = jnp.asarray(np.array([[-1, -1, -1]], np.float32))
    amax = jnp.asarray(np.array([[1, 1, 1]], np.float32))
    o = jnp.asarray(np.array([[0, 0, 5]], np.float32))
    d = jnp.asarray(np.array([[0, 0, -1]], np.float32))
    assert bool(shapes.hit_aabb(1e30, o, d, amin, amax)[0])
    assert not bool(shapes.hit_aabb(1e30, o, -d, amin, amax)[0])
    assert not bool(shapes.hit_aabb(3.0, o, d, amin, amax)[0])  # tmax too near
    # ray starting inside
    o2 = jnp.zeros((1, 3), jnp.float32)
    assert bool(shapes.hit_aabb(1e30, o2, d, amin, amax)[0])


@pytest.mark.smoke
def test_dense_matches_bruteforce(rng_np):
    tris = random_scene(rng_np, t=37)
    o, d = random_rays(rng_np, n=65)
    dense = intersect.build_dense(tris)
    ok, t, idx, pos, normal, _aux = intersect.closest_hit(
        dense, 1e30, la.v3_from_array(o), la.v3_from_array(d))
    ok_b, t_b, idx_b = intersect.closest_hit_bruteforce(tris, 1e30, o, d)
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ok_b))
    hit = np.asarray(ok)
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(t_b)[hit],
                               rtol=1e-3, atol=1e-4)
    # dense stores triangles morton-sorted: map back via perm
    idx = np.asarray(dense.perm)[np.asarray(idx)]
    # indices may differ only where two triangles intersect at ~equal t
    diff = hit & (idx != np.asarray(idx_b))
    assert np.allclose(np.asarray(t)[diff], np.asarray(t_b)[diff], rtol=1e-3)


def test_dense_chunked_matches_unchunked(rng_np):
    tris = random_scene(rng_np, t=300)
    o, d = random_rays(rng_np, n=33)
    dense = intersect.build_dense(tris)
    ov, dv = la.v3_from_array(o), la.v3_from_array(d)
    ok1, t1, i1, _, _, _ = intersect.closest_hit(dense, 1e30, ov, dv, chunk=128)
    ok2, t2, i2, _, _, _ = intersect.closest_hit(dense, 1e30, ov, dv, chunk=4096)
    np.testing.assert_array_equal(np.asarray(ok1), np.asarray(ok2))
    np.testing.assert_allclose(np.asarray(t1)[np.asarray(ok1)],
                               np.asarray(t2)[np.asarray(ok2)], rtol=1e-5)


def test_any_hit_matches_closest(rng_np):
    tris = random_scene(rng_np, t=37)
    o, d = random_rays(rng_np, n=65)
    dense = intersect.build_dense(tris)
    ov, dv = la.v3_from_array(o), la.v3_from_array(d)
    for tmax in [1e30, 2.5, 0.5]:
        ok, t, _, _, _, _ = intersect.closest_hit(dense, tmax, ov, dv)
        anyh = intersect.any_hit(dense, tmax, ov, dv)
        # any_hit true iff closest hit exists (matmul t vs elementwise t can
        # flicker at the exact tmax boundary; tolerate none here)
        np.testing.assert_array_equal(np.asarray(anyh), np.asarray(ok))


def test_per_ray_tmax(rng_np):
    tris = random_scene(rng_np, t=16)
    o, d = random_rays(rng_np, n=8)
    dense = intersect.build_dense(tris)
    ov, dv = la.v3_from_array(o), la.v3_from_array(d)
    ok_far, t_far, _, _, _, _ = intersect.closest_hit(dense, 1e30, ov, dv)
    tmaxes = jnp.where(jnp.isfinite(t_far), t_far * 0.5, 1.0)
    anyh = intersect.any_hit(dense, tmaxes, ov, dv)
    # with tmax below the closest hit, any_hit can still be true only if
    # another triangle lies closer -- impossible since t_far is the min
    assert not np.any(np.asarray(anyh) & np.asarray(ok_far))


def test_degenerate_triangles_never_hit(rng_np):
    tris = np.zeros((5, 3, 3), np.float32)  # all degenerate
    o, d = random_rays(rng_np, n=16)
    dense = intersect.build_dense(jnp.asarray(tris))
    ok, _, _, _, _, _ = intersect.closest_hit(
        dense, 1e30, la.v3_from_array(o), la.v3_from_array(d))
    assert not np.any(np.asarray(ok))
