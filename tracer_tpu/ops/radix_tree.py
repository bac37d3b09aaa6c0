"""Parallel Karras radix-tree construction (replaces radix_tree.fut).

Karras 2012, "Maximizing Parallelism in the Construction of BVHs, Octrees,
and k-d Trees": given radix-sorted Morton codes, every internal node's
child ranges are found independently with binary searches on the
longest-common-prefix function delta.

Re-design: the reference runs data-dependent while-loops per node
(radix_tree.fut:36-55). Here every per-node search is a fixed-trip masked
loop over the 30 possible doublings/halvings, so the whole tree builds as
~90 fully-vectorized steps over the (n-1,) node axis with no
divergence. Duplicate keys are tie-broken by index (radix_tree.fut:26-28).

Child pointer encoding (differs from the reference's sum type
radix_tree.fut:8): ptr in [0, n-1) is an internal node index; ptr >= n-1
is leaf (ptr - (n-1)). This keeps comparisons against `prev` in the
stackless traversal single int32 ops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_MAX_DOUBLINGS = 32


class RadixTree(NamedTuple):
    left: jax.Array    # (n-1,) int32 encoded child ptr
    right: jax.Array   # (n-1,) int32 encoded child ptr
    parent: jax.Array  # (n-1,) int32 parent internal index, -1 for root


def leaf_ptr(i, n_internal):
    return i + n_internal


def is_leaf(ptr, n_internal):
    return ptr >= n_internal


def leaf_index(ptr, n_internal):
    return ptr - n_internal


def build(mortons) -> RadixTree:
    """Construct the internal-node hierarchy from sorted morton codes (n,).

    n must be >= 2 (a single-leaf scene needs no tree).
    """
    mortons = jnp.asarray(mortons, jnp.uint32)
    n = mortons.shape[0]
    assert n >= 2, "radix tree needs at least 2 leaves"
    n_int = n - 1

    def delta(i, j):
        """LCP length of codes i, j; -1 when j out of range (radix_tree.fut:22-29)."""
        in_range = (j >= 0) & (j < n)
        jc = jnp.clip(j, 0, n - 1)
        li = mortons[i]
        lj = mortons[jc]
        same = li == lj
        lcp = jnp.where(
            same,
            32 + jax.lax.clz(i.astype(jnp.uint32) ^ jc.astype(jnp.uint32)).astype(jnp.int32),
            jax.lax.clz(li ^ lj).astype(jnp.int32))
        return jnp.where(in_range, lcp, -1)

    i = jnp.arange(n_int, dtype=jnp.int32)

    # Direction of each node's range.
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    delta_min = delta(i, i - d)

    # Upper bound on range length: double while delta keeps exceeding
    # delta_min. Fixed-trip masked loop replaces the per-node while.
    l_max = jnp.full((n_int,), 2, jnp.int32)
    active = delta(i, i + l_max * d) > delta_min

    def lmax_body(_, carry):
        l_max, active = carry
        l_max = jnp.where(active, l_max * 2, l_max)
        active = active & (delta(i, i + l_max * d) > delta_min)
        return l_max, active

    l_max, _ = jax.lax.fori_loop(0, _MAX_DOUBLINGS, lmax_body, (l_max, active))

    # Binary search for the exact other end j = i + l*d.
    def l_body(k, l):
        t = l_max >> (k + 1)
        ok = (t >= 1) & (delta(i, i + (l + t) * d) > delta_min)
        return jnp.where(ok, l + t, l)

    l = jax.lax.fori_loop(0, 31, l_body,
                          jnp.zeros((n_int,), jnp.int32))
    j = i + l * d
    delta_node = delta(i, j)

    # Binary search for the split position (ceil-div step schedule).
    # t = ceil(l / 2^(k+1)) computed with shifts so no intermediate can
    # overflow int32 (q = 1 << 31 would go negative and pass q <= l).
    def s_body(k, s):
        q = jnp.int32(1) << k
        rem_mask = (jnp.int32(1) << (k + 1)) - 1
        t = (l >> (k + 1)) + ((l & rem_mask) != 0).astype(jnp.int32)
        ok = (q <= l) & (delta(i, i + (s + t) * d) > delta_node)
        return jnp.where(ok, s + t, s)

    s = jax.lax.fori_loop(0, 31, s_body,
                          jnp.zeros((n_int,), jnp.int32))
    gamma = i + s * d + jnp.minimum(d, 0)

    left_is_leaf = jnp.minimum(i, j) == gamma
    right_is_leaf = jnp.maximum(i, j) == gamma + 1
    left = jnp.where(left_is_leaf, leaf_ptr(gamma, n_int), gamma)
    right = jnp.where(right_is_leaf, leaf_ptr(gamma + 1, n_int), gamma + 1)

    # Parent pointers: scatter node index into both internal children;
    # leaf children are dropped (mode="drop" mirrors the reference's
    # negative-index scatter no-op, radix_tree.fut:62-68,83-85).
    # (n_int is out of bounds and gets dropped; -1 would wrap in jnp.)
    parent = jnp.full((n_int,), -1, jnp.int32)
    parent = parent.at[jnp.where(left_is_leaf, n_int, gamma)].set(
        i, mode="drop")
    parent = parent.at[jnp.where(right_is_leaf, n_int, gamma + 1)].set(
        i, mode="drop")
    return RadixTree(left=left, right=right, parent=parent)
