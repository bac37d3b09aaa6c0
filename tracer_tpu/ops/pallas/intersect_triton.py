"""Fused ray-triangle queries for NVIDIA GPUs (Pallas, Triton route).

One program owns a block of BLOCK rays. Its ray features and running
(best_t, best_i) stay in registers while a loop walks the scene's
morton-ordered triangle chunks (`intersect.DenseTris`):

  1. slab-test the chunk's AABB against every live lane of the block at
     the lane's current bound (min(tmax, best_t) for closest queries);
  2. skip the chunk under `lax.cond` when no lane can reach it;
  3. otherwise load the chunk's coefficient columns and form the four
     (C, BLOCK) Moller determinants with explicit f32 multiply-adds;
  4. divide, test barycentrics, reduce min/argmin over the chunk and
     merge into the running best.

The any-hit query stops as soon as every lane of the block has hit.

Nothing goes through device memory but the inputs and the (N,) results:
the XLA formulation (`intersect._chunk_scores_t`) instead writes a
(4C, N) score matrix per chunk and reads it back. The determinants are
f32 FMAs on the CUDA cores, never a tensor-core `pl.dot`: f32 operands
there default to TF32, whose ~3 decimal digits would break the hit
exactness the estimator relies on, and a K=10 contraction gives the
tensor cores nothing to gain.

The coefficient table is read as `intersect.build_dense` lays it out,
(4, T_pad, 10) with columns phi = [d, o, o x d, 1]; the kernel reads
only the structurally non-zero columns (`_TERMS`). The chunk length C
is the table's chunk granularity, `intersect.CHUNK`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tracer_tpu.ops import shapes

# Rays per program and Triton launch parameters (set by measurement on
# the H100; PERF.md "intersection kernel").
BLOCK = 32
NUM_WARPS = 1
NUM_STAGES = 2

# Non-zero coefficient columns of each determinant row of build_dense's
# table, as (phi column) lists; column 9 (the constant 1) is an add.
#   a    = -n . d                       cols 0-2
#   n.s  =  n . o - n . A               cols 3-5, const 9
#   m.e2 = (A x e2) . d + e2 . (o x d)  cols 0-2, 6-8
#   m.e1 = (A x e1) . d + e1 . (o x d)  cols 0-2, 6-8
_TERMS = ((0, 1, 2), (3, 4, 5), (0, 1, 2, 6, 7, 8), (0, 1, 2, 6, 7, 8))
_CONST = (False, True, False, False)


def _load_block(phi_ref, tmax_ref, n: int):
    """This program's lanes: phi rows (10 x (BLOCK,)), tmax, live mask.
    Lanes past n read tmax 0, so they never reach any chunk."""
    start = pl.program_id(0) * BLOCK
    lanes = start + jnp.arange(BLOCK, dtype=jnp.int32)
    live = lanes < n
    phi = [plgpu.load(phi_ref.at[j, pl.ds(start, BLOCK)], mask=live,
                      other=0.0) for j in range(10)]
    tmax = plgpu.load(tmax_ref.at[pl.ds(start, BLOCK)], mask=live,
                      other=0.0)
    return phi, tmax, live


def _slab(phi, bounds_ref, c, upper):
    """Per-lane "may hit" of chunk c's AABB within (0, upper)
    (shapes.hit_aabb semantics: exit inflated by 1 + AABB_EPS, so
    rounding never culls a chunk the exact test would hit). A ray
    parallel to an axis passes that axis: 0 * inf would give NaN for an
    origin on a bound plane. An empty chunk (inverted box) never
    passes."""
    lo = jnp.zeros_like(upper)
    hi = upper
    for k in range(3):
        dk, ok = phi[k], phi[3 + k]
        par = dk == 0.0
        inv = 1.0 / jnp.where(par, 1.0, dk)
        t0 = (bounds_ref[c, k] - ok) * inv
        t1 = (bounds_ref[c, 3 + k] - ok) * inv
        lo = jnp.maximum(lo, jnp.where(par, 0.0, jnp.minimum(t0, t1)))
        hi = jnp.minimum(hi, jnp.where(
            par, upper, jnp.maximum(t0, t1) * (1.0 + shapes.AABB_EPS)))
    return (hi > lo) & (bounds_ref[c, 0] <= bounds_ref[c, 3])


def _chunk_t(coeffs_ref, phi, tmax, c, chunk: int):
    """(C, BLOCK) hit distances of chunk c, +inf where invalid — the
    same arithmetic as intersect._chunk_scores_t."""
    rows = pl.ds(pl.multiple_of(c * chunk, chunk), chunk)
    det = []
    for k, (cols, const) in enumerate(zip(_TERMS, _CONST)):
        acc = None
        for j in cols:
            w = plgpu.load(coeffs_ref.at[k, rows, j])
            term = w[:, None] * phi[j][None, :]
            acc = term if acc is None else acc + term
        if const:
            acc = acc + plgpu.load(coeffs_ref.at[k, rows, 9])[:, None]
        det.append(acc)
    a, nt, nu, nv = det
    nondeg = jnp.abs(a) >= shapes.TRI_EPS
    inv_a = jnp.where(nondeg, 1.0, 0.0) / jnp.where(nondeg, a, 1.0)
    t = nt * inv_a
    u = nu * inv_a
    v = -nv * inv_a
    valid = (nondeg & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
             & (t < tmax[None, :]))
    return jnp.where(valid, t, jnp.inf)


def _any_lane(mask):
    """Scalar: does any lane of the (BLOCK,) mask hold?"""
    return jnp.max(mask.astype(jnp.int32)) > 0


def _closest_kernel(phi_ref, tmax_ref, coeffs_ref, bounds_ref,
                    best_t_ref, best_i_ref, *, n, n_chunks, chunk):
    phi, tmax, live = _load_block(phi_ref, tmax_ref, n)

    def visit(c, carry):
        best_t, best_i = carry
        t = _chunk_t(coeffs_ref, phi, tmax, c, chunk)
        loc_t = jnp.min(t, axis=0)
        loc_i = jnp.argmin(t, axis=0).astype(jnp.int32) + c * chunk
        better = loc_t < best_t
        return (jnp.where(better, loc_t, best_t),
                jnp.where(better, loc_i, best_i))

    def body(c, carry):
        may = live & _slab(phi, bounds_ref, c, jnp.minimum(tmax, carry[0]))
        return jax.lax.cond(_any_lane(may), functools.partial(visit, c),
                            lambda cr: cr, carry)

    best_t, best_i = jax.lax.fori_loop(
        0, n_chunks, body,
        (jnp.full((BLOCK,), jnp.inf, jnp.float32),
         jnp.zeros((BLOCK,), jnp.int32)))
    start = pl.program_id(0) * BLOCK
    plgpu.store(best_t_ref.at[pl.ds(start, BLOCK)], best_t, mask=live)
    plgpu.store(best_i_ref.at[pl.ds(start, BLOCK)], best_i, mask=live)


def _any_kernel(phi_ref, tmax_ref, coeffs_ref, bounds_ref, hit_ref, *,
                n, n_chunks, chunk):
    phi, tmax, live = _load_block(phi_ref, tmax_ref, n)
    todo0 = live & (tmax > 0.0)

    def cond(carry):
        c, hit = carry
        return (c < n_chunks) & _any_lane(todo0 & (hit == 0))

    def body(carry):
        c, hit = carry
        todo = todo0 & (hit == 0)
        may = todo & _slab(phi, bounds_ref, c, tmax)

        def visit(h):
            t = _chunk_t(coeffs_ref, phi, tmax, c, chunk)
            got = jnp.min(t, axis=0) < jnp.inf
            return jnp.maximum(h, got.astype(jnp.int32))

        return c + 1, jax.lax.cond(_any_lane(may), visit, lambda h: h, hit)

    _, hit = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros((BLOCK,), jnp.int32)))
    start = pl.program_id(0) * BLOCK
    plgpu.store(hit_ref.at[pl.ds(start, BLOCK)], hit, mask=live)


def _call(kernel, out_shape, coeffs, chunk_bounds, phi_t, tmax,
          interpret: bool):
    n = phi_t.shape[1]
    n_chunks = chunk_bounds.shape[0]
    chunk = coeffs.shape[1] // n_chunks
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))
    return pl.pallas_call(
        functools.partial(kernel, n=n, n_chunks=n_chunks, chunk=chunk),
        out_shape=out_shape,
        grid=(pl.cdiv(n, BLOCK),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(phi_t, tmax, coeffs, chunk_bounds)


def closest_hit(coeffs, chunk_bounds, phi_t, tmax, interpret: bool = False):
    """Closest hit of every ray: (best_t (N,) f32, +inf on miss;
    best_i (N,) int32 storage-order triangle index, 0 on miss). coeffs
    (4, T_pad, 10) and chunk_bounds (n_chunks, 8) as in DenseTris;
    phi_t (10, N) ray features; tmax scalar or (N,)."""
    n = phi_t.shape[1]
    return _call(_closest_kernel,
                 (jax.ShapeDtypeStruct((n,), jnp.float32),
                  jax.ShapeDtypeStruct((n,), jnp.int32)),
                 coeffs, chunk_bounds, phi_t, tmax, interpret)


def any_hit(coeffs, chunk_bounds, phi_t, tmax, interpret: bool = False):
    """(N,) bool: some triangle is hit at 0 < t < tmax."""
    n = phi_t.shape[1]
    hit = _call(_any_kernel, jax.ShapeDtypeStruct((n,), jnp.int32),
                coeffs, chunk_bounds, phi_t, tmax, interpret)
    return hit > 0
