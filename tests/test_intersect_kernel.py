"""The fused GPU intersection kernel (interpret mode on the CPU) against
the broadcast oracle and the XLA formulation, and the query dispatch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tracer_tpu.ops import intersect, linalg as la
from tracer_tpu.ops.pallas import intersect_triton as kt


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _random(rng, t, n, scale=2.0):
    tris = rng.uniform(-scale, scale, (t, 3, 3)).astype(np.float32)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    return tris, o, d, 1e30


def _case(name, rng):
    """(tris (T,3,3), origins (N,3), dirs (N,3), tmax scalar or (N,))."""
    if name == "one_chunk":
        return _random(rng, 20, 70)
    if name == "many_chunks":
        return _random(rng, 8 * intersect.CHUNK, 150)
    if name == "tris_not_chunk_multiple":
        return _random(rng, 3 * intersect.CHUNK + 5, 100)
    if name == "lanes_not_block_multiple":
        return _random(rng, 50, kt.BLOCK + 3)
    if name == "per_lane_tmax":
        tris, o, d, _ = _random(rng, 90, 120)
        return tris, o, d, rng.uniform(0.0, 4.0, 120).astype(np.float32)
    if name == "degenerate":
        tris, o, d, tmax = _random(rng, 60, 80)
        tris[::3] = tris[::3, :1]          # every third triangle a point
        tris[1::3, 2] = tris[1::3, 1]      # ... or a segment
        return tris, o, d, tmax
    if name == "axis_parallel_on_planes":
        # axis-aligned walls; rays run parallel to two axes with
        # origins exactly on the chunks' x and y bound planes (exact
        # arithmetic, so every formulation sees the same edges)
        quads = []
        for k in range(3 * intersect.CHUNK // 2):
            z = -1.0 - 0.25 * k
            quads += [[[-1, -1, z], [1, -1, z], [1, 1, z]],
                      [[-1, -1, z], [1, 1, z], [-1, 1, z]]]
        tris = np.asarray(quads, np.float32)
        g = np.linspace(-1.0, 1.0, 9, dtype=np.float32)
        xs, ys = np.meshgrid(g, g)
        o = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 2.0)], 1)
        d = np.tile(np.asarray([[0, 0, -1]], np.float32), (xs.size, 1))
        return tris, o.astype(np.float32), d, 1e30
    if name == "all_miss":
        tris, o, d, tmax = _random(rng, 70, 90)
        return tris + np.float32(100.0), o, d, tmax
    if name == "anyhit_early_exit":
        # a near wall every ray hits first, then many chunks behind it:
        # any-hit exits after the first chunk for every lane
        wall = np.asarray([[[-5, -5, 0], [5, -5, 0], [5, 5, 0]],
                           [[-5, -5, 0], [5, 5, 0], [-5, 5, 0]]], np.float32)
        rest = rng.uniform(-2, 2, (6 * intersect.CHUNK, 3, 3))
        rest[..., 2] -= 5.0
        tris = np.concatenate([wall, rest.astype(np.float32)])
        n = 2 * kt.BLOCK
        o = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                            np.full((n, 1), 1.0)], 1).astype(np.float32)
        d = _unit(np.concatenate([rng.uniform(-0.2, 0.2, (n, 2)),
                                  -np.ones((n, 1))], 1)).astype(np.float32)
        return tris, o, d, 1e30
    raise ValueError(name)


CASES = ("one_chunk", "many_chunks", "tris_not_chunk_multiple",
         "lanes_not_block_multiple", "per_lane_tmax", "degenerate",
         "axis_parallel_on_planes", "all_miss", "anyhit_early_exit")


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_references(case, rng_np):
    """Kernel (interpret mode) == XLA formulation == broadcast oracle:
    same hit set, t, and (up to exact ties) triangle; same any-hit."""
    tris, o, d, tmax = _case(case, rng_np)
    dense = intersect.build_dense(jnp.asarray(tris))
    ov, dv = la.v3_from_array(jnp.asarray(o)), la.v3_from_array(
        jnp.asarray(d))
    phi = intersect.ray_features_t(ov, dv)
    tmax = jnp.asarray(tmax, jnp.float32)

    bt, bi = map(np.asarray, kt.closest_hit(
        dense.coeffs, dense.chunk_bounds, phi, tmax, interpret=True))
    xt, xi = map(np.asarray, intersect._closest_xla(
        dense, phi, tmax, intersect.DEFAULT_CHUNK))
    ok_b, t_b, i_b = map(np.asarray, intersect.closest_hit_bruteforce(
        jnp.asarray(tris), tmax[:, None] if tmax.ndim else tmax,
        jnp.asarray(o), jnp.asarray(d)))

    hit = np.isfinite(bt)
    np.testing.assert_array_equal(hit, np.isfinite(xt))
    np.testing.assert_array_equal(hit, ok_b)
    np.testing.assert_allclose(bt[hit], xt[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bt[hit], t_b[hit], rtol=1e-4, atol=1e-5)
    perm = np.asarray(dense.perm)
    same = perm[bi[hit]] == i_b[hit]
    # a different triangle only at an equal-t tie
    np.testing.assert_allclose(bt[hit][~same], t_b[hit][~same], rtol=1e-5)
    assert (bi[hit] == xi[hit]).all()

    tmax_any = (tmax if tmax.ndim else
                jnp.asarray(rng_np.uniform(0.0, 5.0, o.shape[0]),
                            jnp.float32))
    hk = np.asarray(kt.any_hit(dense.coeffs, dense.chunk_bounds, phi,
                               tmax_any, interpret=True))
    hx = np.asarray(intersect._any_xla(dense, phi, tmax_any,
                                       intersect.DEFAULT_CHUNK))
    np.testing.assert_array_equal(hk, hx)
    if case == "all_miss":
        assert not hit.any() and not hk.any()
    if case in ("anyhit_early_exit", "axis_parallel_on_planes"):
        assert hit.all()


def test_kernel_output_shapes_and_dtypes(rng_np):
    tris, o, d, _ = _random(rng_np, 40, 5)
    dense = intersect.build_dense(jnp.asarray(tris))
    phi = intersect.ray_features_t(la.v3_from_array(jnp.asarray(o)),
                                   la.v3_from_array(jnp.asarray(d)))
    bt, bi = kt.closest_hit(dense.coeffs, dense.chunk_bounds, phi, 1e30,
                            interpret=True)
    hit = kt.any_hit(dense.coeffs, dense.chunk_bounds, phi, 1e30,
                     interpret=True)
    assert (bt.shape, bt.dtype) == ((5,), jnp.float32)
    assert (bi.shape, bi.dtype) == ((5,), jnp.int32)
    assert (hit.shape, hit.dtype) == ((5,), jnp.bool_)


def test_build_dense_pads_to_chunks():
    """The table pads to whole CHUNKs with degenerate rows; each chunk
    has a box around its real triangles, and an empty chunk an inverted
    one the kernel's cull rejects."""
    tris = np.random.default_rng(1).uniform(
        -1, 1, (intersect.CHUNK + 3, 3, 3)).astype(np.float32)
    dense = intersect.build_dense(jnp.asarray(tris))
    assert dense.coeffs.shape == (4, 2 * intersect.CHUNK, 10)
    assert dense.chunk_bounds.shape == (2, 8)
    cb = np.asarray(dense.chunk_bounds)
    stored = tris[np.asarray(dense.perm)[:tris.shape[0]]]
    for c in range(2):
        part = stored[c * intersect.CHUNK:(c + 1) * intersect.CHUNK]
        np.testing.assert_allclose(cb[c, :3], part.min(axis=(0, 1)))
        np.testing.assert_allclose(cb[c, 3:6], part.max(axis=(0, 1)))
    empty = intersect.build_dense(jnp.zeros((0, 3, 3), jnp.float32))
    assert (np.asarray(empty.chunk_bounds)[:, :3] == np.inf).all()


def test_cpu_dispatch_takes_xla_whatever_the_env(monkeypatch):
    """On the CPU every query takes the XLA formulation; no environment
    variable switches it (the removed kernel knobs included)."""
    dense = intersect.build_dense(jnp.ones((4, 3, 3), jnp.float32))
    for knob in ("TRACER_NO_PALLAS", "TRACER_MXU_PRECISION",
                 "TRACER_CHUNK_T", "TRACER_PERM_RAYS"):
        monkeypatch.setenv(knob, "1")
    assert jax.default_backend() == "cpu"
    assert not intersect.use_kernel(dense)
    assert not intersect.use_kernel(intersect.reference(dense))


def test_gpu_dispatch_takes_kernel_except_reference(monkeypatch):
    monkeypatch.setattr(intersect.jax, "default_backend", lambda: "gpu")
    dense = intersect.build_dense(jnp.ones((4, 3, 3), jnp.float32))
    assert intersect.use_kernel(dense)
    assert not intersect.use_kernel(intersect.reference(dense))


def test_wrapper_routes_through_kernel(monkeypatch, rng_np):
    """With the backend reported as a GPU, closest_hit/any_hit call the
    kernel (run here in interpret mode) and return what the XLA path
    returns, re-intersection and aux column included."""
    tris, o, d, _ = _random(rng_np, 3 * intersect.CHUNK, 100)
    aux = np.arange(tris.shape[0], dtype=np.float32)
    dense = intersect.build_dense(jnp.asarray(tris), aux=aux)
    ov, dv = la.v3_from_array(jnp.asarray(o)), la.v3_from_array(
        jnp.asarray(d))
    want = intersect.closest_hit(dense, 1e30, ov, dv)
    want_any = intersect.any_hit(dense, 2.0, ov, dv)

    calls = []

    def spy(fn):
        def run(*args):
            calls.append(fn.__name__)
            return fn(*args, interpret=True)
        return run

    monkeypatch.setattr(intersect.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(kt, "closest_hit", spy(kt.closest_hit))
    monkeypatch.setattr(kt, "any_hit", spy(kt.any_hit))
    got = intersect.closest_hit(dense, 1e30, ov, dv)
    got_any = intersect.any_hit(dense, 2.0, ov, dv)
    assert calls == ["closest_hit", "any_hit"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got_any), np.asarray(want_any))
    # the reference table never reaches the kernel
    intersect.closest_hit(intersect.reference(dense), 1e30, ov, dv)
    assert calls == ["closest_hit", "any_hit"]


def test_reference_is_its_own_pytree_type():
    """reference(dense) survives flatten/unflatten and _replace as its
    own type, so a jitted renderer traces it apart from the kernel's."""
    dense = intersect.build_dense(jnp.ones((4, 3, 3), jnp.float32))
    ref = intersect.reference(dense)
    leaves, tdef = jax.tree.flatten(ref)
    assert type(jax.tree.unflatten(tdef, leaves)) is intersect.XlaDenseTris
    assert type(ref._replace(perm=ref.perm)) is intersect.XlaDenseTris
    assert tdef != jax.tree.flatten(dense)[1]


@pytest.mark.chip
def test_compiled_kernel_matches_xla_at_pool_width(gpu):
    """On the card: the compiled kernel against the XLA formulation at a
    real pool width, 90,112 triangles, camera and bounce rays."""
    import chip_smoke
    chip_smoke.phase_kernel(cases=((6, 256, 256),), reps=0)


@pytest.mark.chip
def test_compiled_kernel_any_hit_shadow_rays(gpu, rng_np):
    """On the card: shadow-style queries (per-lane tmax, many lanes with
    tmax <= 0) agree with the XLA formulation."""
    tris, o, d, _ = _random(rng_np, 4096, 65536)
    dense = intersect.build_dense(jnp.asarray(tris))
    phi = intersect.ray_features_t(la.v3_from_array(jnp.asarray(o)),
                                   la.v3_from_array(jnp.asarray(d)))
    tmax = jnp.asarray(rng_np.uniform(-2.0, 3.0, 65536), jnp.float32)
    hk = np.asarray(kt.any_hit(dense.coeffs, dense.chunk_bounds, phi, tmax))
    hx = np.asarray(intersect._any_xla(dense, phi, tmax,
                                       intersect.DEFAULT_CHUNK))
    assert np.mean(hk != hx) <= 1e-5
    assert not hk[np.asarray(tmax) <= 0].any()
