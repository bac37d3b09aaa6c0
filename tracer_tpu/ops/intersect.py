"""Dense ray-triangle intersection.

Re-design of the brute-force oracle `mk_fake_bvh` (reference
src/bvh.fut:25-43) that is also the production path: every determinant
of the Moller triangle test (reference src/shapes.fut:66-86) is linear
in the ray features

    phi(ray) = [ d, o, o x d, 1 ]            in R^10

so testing N rays against T triangles is a (4T,10) @ (10,N) product plus
an elementwise epilogue:

    a   = -(n . d)                 n  = e1 x e2
    n.s =  n . o - n . A           s  = o - A
    m.e2 = (o x d) . e2 + (A x e2) . d
    m.e1 = (o x d) . e1 + (A x e1) . d
    t = (n.s)/a,  u = (m.e2)/a,  v = -(m.e1)/a

Two implementations answer the queries:
  * on a GPU, a fused Pallas kernel (pallas/intersect_triton.py) that
    keeps scores in registers and culls triangle chunks by their AABBs;
  * elsewhere, the XLA formulation below: scores live in (T, N) with
    rays on the minor axis, triangles processed in chunks under
    `lax.scan` with a running (best_t, best_index). It is the CPU path
    and the oracle the kernel is tested against; `reference(dense)`
    selects it on every backend.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tracer_tpu.ops import shapes, tables

# Triangles per chunk: the padding granularity of the table, the unit
# of the per-chunk AABBs and of the kernel's cull (set by measurement on
# the H100; PERF.md "intersection kernel").
CHUNK = 16
# Rows per scored chunk of the XLA formulation's scan.
DEFAULT_CHUNK = 512


class DenseTris(NamedTuple):
    """Precomputed triangle coefficients for the matmul intersector.

    coeffs: (4, T_pad, 10) f32 — blocks (a, n.s, m.e2, m.e1); column
            order matches phi = [d, o, o x d, 1]
    tris:   (T_pad, 10) f32 — flattened vertices (9) + a per-triangle
            aux scalar (column 9, e.g. the material id; 0 when unused).
            Zero vertices => degenerate, always rejected by the
            |a| >= eps test. The aux column rides the one wide row
            fetch _reintersect already does instead of a second
            per-lane gather.
    perm:   (T_pad,) int32 — triangles are stored in morton order so
            consecutive CHUNK-sized groups are spatially tight; perm[i]
            is the input index of stored triangle i (identity beyond T)
    chunk_bounds: (n_chunks, 8) f32 — per-chunk AABB [min xyz, max xyz,
            0, 0]; empty/padded chunks carry an inverted (+inf/-inf) box
            so the kernel's slab cull always rejects them
    """
    coeffs: jax.Array
    tris: jax.Array
    perm: jax.Array
    chunk_bounds: jax.Array


def build_dense(tris, pad_to: int | None = None, aux=None) -> DenseTris:
    """Precompute matmul coefficients from (T, 3, 3) triangles.

    Triangles are morton-sorted first (like the LBVH leaf order,
    bvh.fut:93-97) so the fixed-size chunks the GPU kernel walks act as
    an implicit two-level hierarchy: each chunk's AABB is tight and the
    kernel skips whole chunks that no ray of a block can reach.

    aux: optional (T,) per-triangle scalar carried alongside the
    vertices (stored in tris column 9, returned per winning lane by
    closest_hit) — the scene layer passes material ids.
    """
    from tracer_tpu.ops import morton as morton_mod
    tris = jnp.asarray(tris, jnp.float32).reshape(-1, 3, 3)
    t = tris.shape[0]
    aux = (jnp.zeros((t,), jnp.float32) if aux is None
           else jnp.asarray(aux, jnp.float32).reshape(t))
    if pad_to is None:
        pad_to = CHUNK
    t_pad = max(pad_to, -(-max(t, 1) // pad_to) * pad_to)

    if t > 1:
        tri_min = jnp.min(tris, axis=-2)
        tri_max = jnp.max(tris, axis=-2)
        smin = jnp.min(tri_min, axis=0)
        dims = jnp.maximum(jnp.max(tri_max, axis=0) - smin, 1e-30)
        centers = ((tri_min + tri_max) * 0.5 - smin) / dims
        order = jnp.argsort(morton_mod.morton3d(centers)).astype(jnp.int32)
        tris = tris[order]
        aux = aux[order]
    else:
        order = jnp.arange(max(t, 1), dtype=jnp.int32)[:t]

    perm = jnp.concatenate([
        order, jnp.arange(t, t_pad, dtype=jnp.int32)])
    tris = jnp.pad(tris, ((0, t_pad - t), (0, 0), (0, 0)))
    aux = jnp.pad(aux, (0, t_pad - t))

    # per-chunk AABBs over the real triangles; padded rows excluded via
    # +inf/-inf so empty chunks never pass the slab test
    n_chunks = t_pad // pad_to
    real = (jnp.arange(t_pad) < t)[:, None]
    cmin = jnp.where(real, jnp.min(tris, axis=-2), jnp.inf)
    cmax = jnp.where(real, jnp.max(tris, axis=-2), -jnp.inf)
    bmin = jnp.min(cmin.reshape(n_chunks, pad_to, 3), axis=1)
    bmax = jnp.max(cmax.reshape(n_chunks, pad_to, 3), axis=1)
    chunk_bounds = jnp.concatenate(
        [bmin, bmax, jnp.zeros((n_chunks, 2), jnp.float32)], axis=1)

    a_v = tris[:, 0, :]
    e1 = tris[:, 1, :] - a_v
    e2 = tris[:, 2, :] - a_v
    n = jnp.cross(e1, e2)
    axe1 = jnp.cross(a_v, e1)
    axe2 = jnp.cross(a_v, e2)
    zeros = jnp.zeros((t_pad, 3), jnp.float32)
    one = jnp.zeros((t_pad, 1), jnp.float32)

    def row(d_part, o_part, oxd_part, const_part):
        return jnp.concatenate([d_part, o_part, oxd_part, const_part],
                               axis=-1)

    coeffs = jnp.stack([
        row(-n, zeros, zeros, one),                                # a
        row(zeros, n, zeros, -jnp.sum(n * a_v, -1, keepdims=True)),  # n.s
        row(axe2, zeros, e2, one * 0),                             # m.e2
        row(axe1, zeros, e1, one * 0),                             # m.e1
    ])  # (4, T_pad, 10)
    tri_rows = jnp.concatenate([tris.reshape(t_pad, 9), aux[:, None]],
                               axis=1)
    return DenseTris(coeffs=coeffs, tris=tri_rows,
                     perm=perm, chunk_bounds=chunk_bounds)


def ray_features_t(origin, d):
    """phi(ray) transposed: (10, N) = [d, o, o x d, 1] rows.

    origin/d are V3 = (3, N) (linalg.py transposed convention), so this
    is a pure major-axis concat — no relayout."""
    from tracer_tpu.ops import linalg as la
    oxd = la.v3_cross(origin, d)
    ones = jnp.ones(jnp.broadcast_shapes(origin.shape, d.shape)[1:],
                    jnp.float32)[None]
    return jnp.concatenate([d, origin, oxd, ones], axis=0)


def _chunk_scores_t(phi_t, coeffs_chunk, tmax):
    """Rays vs one chunk: coeffs_chunk (4, C, 10), phi_t (10, N).

    Returns (valid (C, N) bool, t (C, N) f32, +inf on invalid lanes).
    The product runs at Precision.HIGHEST: f32 without TF32 rounding.
    """
    c = coeffs_chunk.shape[1]
    p = jax.lax.dot_general(
        coeffs_chunk.reshape(4 * c, 10), phi_t, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)  # (4C, N)
    a, nt, nu, nv = p[:c], p[c:2 * c], p[2 * c:3 * c], p[3 * c:]
    nondeg = jnp.abs(a) >= shapes.TRI_EPS
    inv_a = jnp.where(nondeg, 1.0, 0.0) / jnp.where(nondeg, a, 1.0)
    t = nt * inv_a
    u = nu * inv_a
    v = -nv * inv_a
    valid = nondeg & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < tmax)
    return valid, jnp.where(valid, t, jnp.inf)


def _reintersect(dense: DenseTris, best_i, origin, d, tmax):
    """Exact pos/normal for the winning triangle, mirroring the
    reference's final hit_triangle on the best leaf (bvh.fut:143-145).
    One (10, N) row fetch (one-hot matmul for small tables, wide gather
    above ONEHOT_MAX_ROWS); rows 0-8 are V3 vertex blocks, row 9 the
    per-triangle aux scalar, returned last."""
    rows_t = tables.take_rows_t(dense.tris, best_i)  # (10, N)
    ok, t, pos, nrm = shapes.hit_triangle_v(tmax, origin, d,
                                            rows_t[0:3], rows_t[3:6],
                                            rows_t[6:9])
    return ok, t, pos, nrm, rows_t[9]


class XlaDenseTris(DenseTris):
    """DenseTris whose queries always take the XLA formulation — the
    reference the GPU kernel is compared with on the card. A distinct
    pytree type, so a jitted renderer traces each choice separately."""
    __slots__ = ()


def reference(dense: DenseTris) -> XlaDenseTris:
    """The same triangles, queried by the XLA formulation everywhere."""
    return XlaDenseTris(*dense)


def use_kernel(dense: DenseTris) -> bool:
    """The fused kernel answers every query on a GPU; the XLA
    formulation answers on other backends and for `reference` tables."""
    return (not isinstance(dense, XlaDenseTris)
            and jax.default_backend() == "gpu")


def _chunked(coeffs, chunk: int):
    """(4, T_pad, 10) -> (n_chunks, 4, chunk, 10), zero-padded (zero
    rows are degenerate and never hit)."""
    t_pad = coeffs.shape[1]
    n_chunks = -(-t_pad // chunk)
    coeffs = jnp.pad(coeffs, ((0, 0), (0, n_chunks * chunk - t_pad), (0, 0)))
    return coeffs.reshape(4, n_chunks, chunk, 10).transpose(1, 0, 2, 3)


def _closest_xla(dense: DenseTris, phi_t, tmax, chunk: int):
    """(best_t, best_i) by the XLA formulation: global min-t, lowest
    storage index on exact ties."""
    if dense.coeffs.shape[1] <= chunk:
        _, t = _chunk_scores_t(phi_t, dense.coeffs, tmax)
        return jnp.min(t, axis=0), jnp.argmin(t, axis=0).astype(jnp.int32)

    def body(carry, inp):
        best_t, best_i = carry
        c_idx, coeffs_chunk = inp
        _, t = _chunk_scores_t(phi_t, coeffs_chunk, tmax)
        loc_i = jnp.argmin(t, axis=0).astype(jnp.int32)
        loc_t = jnp.min(t, axis=0)
        better = loc_t < best_t
        best_t = jnp.where(better, loc_t, best_t)
        best_i = jnp.where(better, c_idx * chunk + loc_i, best_i)
        return (best_t, best_i), None

    coeffs = _chunked(dense.coeffs, chunk)
    n = phi_t.shape[1]
    init = (jnp.full((n,), jnp.inf, jnp.float32), jnp.zeros((n,), jnp.int32))
    (best_t, best_i), _ = jax.lax.scan(
        body, init,
        (jnp.arange(coeffs.shape[0], dtype=jnp.int32), coeffs))
    return best_t, best_i


def _any_xla(dense: DenseTris, phi_t, tmax, chunk: int):
    if dense.coeffs.shape[1] <= chunk:
        valid, _ = _chunk_scores_t(phi_t, dense.coeffs, tmax)
        return jnp.any(valid, axis=0)

    def body(hit, coeffs_chunk):
        valid, _ = _chunk_scores_t(phi_t, coeffs_chunk, tmax)
        return hit | jnp.any(valid, axis=0), None

    hit, _ = jax.lax.scan(body, jnp.zeros((phi_t.shape[1],), bool),
                          _chunked(dense.coeffs, chunk))
    return hit


def closest_hit(dense: DenseTris, tmax, origin, d,
                chunk: int = DEFAULT_CHUNK):
    """Closest-hit query: rays as V3 (3,N)+(3,N) vs all triangles.

    Returns (ok (N,), t (N,), tri_idx (N,) int32, pos (3,N), normal (3,N),
    aux (N,) f32 — the winner's build-time aux scalar, 0 on miss).
    Semantics match mk_fake_bvh.closest_hit (bvh.fut:31-39): global min-t.
    `chunk` is the XLA formulation's scan chunk; the kernel ignores it.
    """
    phi_t = ray_features_t(origin, d)
    tmax = jnp.asarray(tmax, jnp.float32)
    if use_kernel(dense):
        from tracer_tpu.ops.pallas import intersect_triton
        best_t, best_i = intersect_triton.closest_hit(
            dense.coeffs, dense.chunk_bounds, phi_t, tmax)
    else:
        best_t, best_i = _closest_xla(dense, phi_t, tmax, chunk)
    ok = jnp.isfinite(best_t)
    best_i = jnp.where(ok, best_i, 0)
    # rounding headroom so the exact re-test keeps a true winner that
    # sits at tmax
    ok2, t, pos, normal, aux = _reintersect(dense, best_i, origin, d,
                                            tmax * (1.0 + 1e-6))
    ok = ok & ok2
    return (ok, jnp.where(ok, t, jnp.inf),
            jnp.where(ok, best_i, -1), pos, normal,
            jnp.where(ok, aux, 0.0))


def any_hit(dense: DenseTris, tmax, origin, d,
            chunk: int = DEFAULT_CHUNK):
    """Shadow-ray query: True where any triangle is hit before tmax
    (mk_fake_bvh.any_hit, bvh.fut:41-42)."""
    phi_t = ray_features_t(origin, d)
    tmax = jnp.asarray(tmax, jnp.float32)
    if use_kernel(dense):
        from tracer_tpu.ops.pallas import intersect_triton
        return intersect_triton.any_hit(dense.coeffs, dense.chunk_bounds,
                                        phi_t, tmax)
    return _any_xla(dense, phi_t, tmax, chunk)


def closest_hit_bruteforce(tris, tmax, origin, d):
    """Pure-broadcast oracle (no matmul) used to validate the dense
    queries in tests; O(N*T) memory, test-sized inputs only."""
    ok, t, _, _ = shapes.hit_triangle(
        tmax, origin[..., None, :], d[..., None, :], tris)
    best_i = jnp.argmin(t, axis=-1).astype(jnp.int32)
    best_t = jnp.min(t, axis=-1)
    hit = jnp.isfinite(best_t)
    return hit, best_t, jnp.where(hit, best_i, -1)
