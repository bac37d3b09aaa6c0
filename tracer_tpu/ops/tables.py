"""Row lookup from small tables without gathers.

Small tables (materials, lights, triangle records) are read by a one-hot
product instead of a gather: the design comes from an accelerator whose
gathers were slow, and whether it pays on the H100 against a plain
gather is not measured (ROADMAP A5). The product is exact in f32: each
output element is value*1 + 0*rest, and Precision.HIGHEST keeps true
f32 multiplies.

Results come back TRANSPOSED — (K, N) with the lane axis minor — so that
downstream per-component slices are free major-axis slices and knot scans
stay out of the (wasteful, slow) lane-dimension-of-size-K layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Above this row count the (M, N) one-hot matrix costs more than the
# gather: at N=262k lanes, M=512 already materializes 537MB per fetch.
ONEHOT_MAX_ROWS = 512


def one_hot_t(ix, m: int):
    """(M, N) transposed one-hot of int32 indices (N,)."""
    rows = jnp.arange(m, dtype=jnp.int32)[:, None]
    return (rows == ix[None, :]).astype(jnp.float32)


def take_rows_t(table, ix):
    """table (M, K) f32, ix (N,) int32 -> (K, N) f32, exact.

    Out-of-range indices are the caller's responsibility (clamp first).
    """
    m, k = table.shape
    if m <= ONEHOT_MAX_ROWS:
        oh = one_hot_t(ix, m)  # (M, N)
        return jax.lax.dot_general(
            table.T, oh, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)
    return table[ix].T


def take_rows(table, ix):
    """table (M, K) f32, ix (N,) int32 -> (N, K) f32."""
    return take_rows_t(table, ix).T


def take_scalar(table, ix):
    """table (M,) integer, ix (N,) int32 -> (N,) same dtype.

    A 1-element-per-lane fetch: a plain gather."""
    return table[ix]
