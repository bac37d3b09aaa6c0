"""Batched ray / triangle / AABB geometry (replaces shapes.fut).

Layout choices (array-native, not a translation):
  rays       origins (..., 3) + dirs (..., 3), always unit dirs
  triangles  (..., 3, 3): vertices a, b, c along axis -2
  aabbs      (min_corner (..., 3), max_corner (..., 3))

The reference stores AABBs as center/half_dims (shapes.fut:14); min/max
corners make the slab test and refit pure min/max element-wise ops, which is what
its own TODO at shapes.fut:10-11 suspected would be faster.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from tracer_tpu.ops import linalg as la

ACNE_EPS = 0.001       # shapes.fut:44
TRI_EPS = 0.00001      # shapes.fut:69
AABB_EPS = 0.001       # shapes.fut:116
F32_HIGHEST = jnp.float32(3.4028235e38)


def mkray(origin, d):
    """Ray with normalized direction (shapes.fut:37-38)."""
    return origin, la.normalize(d)


def mkray_adjust_acne(hit_pos, hit_normal, wi):
    """Offset the origin along the normal, flipped to wi's side
    (shapes.fut:41-46)."""
    offset = la.scale(ACNE_EPS, la.same_side(wi, hit_normal))
    return mkray(hit_pos + offset, wi)


def point_at_param(origin, d, t):
    return origin + la.scale(t, d)


def mkrect(corners):
    """Two triangles covering the quad corners[0..3] (shapes.fut:51-57)."""
    c = jnp.asarray(corners, jnp.float32)
    return jnp.stack([jnp.stack([c[0], c[1], c[2]]),
                      jnp.stack([c[2], c[3], c[0]])])


def triangle_normal(tri):
    """Unnormalized e1 x e2 would do for tests; reference normalizes
    (shapes.fut:59-62)."""
    e1 = tri[..., 1, :] - tri[..., 0, :]
    e2 = tri[..., 2, :] - tri[..., 0, :]
    return la.normalize(la.cross(e1, e2))


def triangle_area(tri):
    """direct.fut:17-20"""
    e1 = tri[..., 1, :] - tri[..., 0, :]
    e2 = tri[..., 2, :] - tri[..., 0, :]
    return la.norm(la.cross(e1, e2)) * 0.5


def hit_triangle(tmax, origin, d, tri):
    """Moller-style test, RTR 22.16 variant (shapes.fut:66-86).

    Batched elementwise: ray i against triangle i (broadcastable).
    Returns (ok (...,) bool, t (...,), pos (...,3), normal (...,3)).
    Invalid lanes carry t = +inf. Normal is the normalized geometric
    normal e1 x e2 (NOT flipped toward the ray), as in the reference.
    """
    a_v = tri[..., 0, :]
    e1 = tri[..., 1, :] - a_v
    e2 = tri[..., 2, :] - a_v
    n = la.cross(e1, e2)
    a = -la.dot(n, d)
    nondegenerate = jnp.abs(a) >= TRI_EPS
    inv_a = jnp.where(nondegenerate, 1.0 / jnp.where(nondegenerate, a, 1.0), 0.0)
    s = origin - a_v
    m = la.cross(s, d)
    t = la.dot(n, s) * inv_a
    u = la.dot(m, e2) * inv_a
    v = -la.dot(m, e1) * inv_a
    in_triangle = (u >= 0) & (v >= 0) & (u + v <= 1)
    ok = nondegenerate & in_triangle & (t < tmax) & (t > 0)
    t = jnp.where(ok, t, jnp.inf)
    pos = point_at_param(origin, d, jnp.where(ok, t, 0.0))
    normal = la.normalize(n, eps=1e-30)
    return ok, t, pos, normal


def aabb_center(aabb_min, aabb_max):
    return (aabb_min + aabb_max) * 0.5


def containing_aabb(min1, max1, min2, max2):
    """shapes.fut:96-101 in min/max-corner form."""
    return jnp.minimum(min1, min2), jnp.maximum(max1, max2)


def bounding_box_triangle(tri):
    """shapes.fut:106-110: (min (...,3), max (...,3)) of the 3 vertices."""
    return jnp.min(tri, axis=-2), jnp.max(tri, axis=-2)


def hit_aabb(tmax, origin, d, aabb_min, aabb_max):
    """Slab test (shapes.fut:114-135), batched & branch-free.

    Matches the reference: tmin starts at 0, each axis' upper bound is
    inflated by (1 + eps), rejection is tmax' <= tmin'.
    """
    inv_d = 1.0 / d
    t0 = (aabb_min - origin) * inv_d
    t1 = (aabb_max - origin) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1) * (1.0 + AABB_EPS)
    tmin = jnp.maximum(jnp.max(lo, axis=-1), 0.0)
    tmax_ = jnp.minimum(jnp.min(hi, axis=-1), tmax)
    return tmax_ > tmin


# ---------------------------------------------------------------------------
# Transposed (V3 = (3, N)) hot-path variants. Same math and epsilons as the
# (..., 3) versions above; the layout keeps lanes on the minor axis so no
# broadcast between (N,) scalars and vectors ever relayouts (see
# linalg.py V3 notes).

def mkray_v(origin, d):
    return origin, la.v3_normalize(d)


def mkray_adjust_acne_v(hit_pos, hit_normal, wi):
    """shapes.fut:41-46 in transposed layout."""
    offset = ACNE_EPS * la.v3_same_side(wi, hit_normal)
    return mkray_v(hit_pos + offset, wi)


def triangle_normal_v(ta, tb, tc):
    return la.v3_normalize(la.v3_cross(tb - ta, tc - ta), eps=1e-30)


def triangle_area_v(ta, tb, tc):
    return la.v3_norm(la.v3_cross(tb - ta, tc - ta)) * 0.5


def hit_triangle_v(tmax, origin, d, ta, tb, tc):
    """Moller test (shapes.fut:66-86), transposed layout.

    Returns (ok (N,), t (N,), pos (3,N), normal (3,N)); t=+inf on miss.
    """
    e1 = tb - ta
    e2 = tc - ta
    n = la.v3_cross(e1, e2)
    a = -la.v3_dot(n, d)
    nondeg = jnp.abs(a) >= TRI_EPS
    inv_a = jnp.where(nondeg, 1.0, 0.0) / jnp.where(nondeg, a, 1.0)
    s = origin - ta
    m = la.v3_cross(s, d)
    t = la.v3_dot(n, s) * inv_a
    u = la.v3_dot(m, e2) * inv_a
    v = -la.v3_dot(m, e1) * inv_a
    ok = (nondeg & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t < tmax) & (t > 0))
    t = jnp.where(ok, t, jnp.inf)
    pos = origin + jnp.where(ok, t, 0.0) * d
    normal = la.v3_normalize(n, eps=1e-30)
    return ok, t, pos, normal


def disk_sectors_v(p, normal, radius, n_sectors: int):
    """Disk triangle fan (shapes.fut:17-35), transposed layout.

    p, normal: (3, N). Returns a list of n_sectors (a, b, c) V3 tuples
    (a Python list — sector count is static; selection by index is a
    static where-chain, never a gather).
    """
    a = 2.0 * math.pi / n_sectors
    c = la.v3_cross(normal, jnp.broadcast_to(la.V3_UP, normal.shape))
    cq = la.v3_quadrance(c)
    degenerate = cq == 0.0
    safe = c * jax.lax.rsqrt(jnp.maximum(cq, 1e-30))
    right = jnp.where(degenerate, la.v3_const(1.0, 0.0, 0.0), safe)
    up = la.v3_normalize(la.v3_cross(right, normal), eps=1e-30)

    out = []
    for i in range(n_sectors):
        b0, b1 = a * i, a * (i + 1)

        def vec_at(b):
            return math.cos(b) * right + math.sin(b) * up

        v0, v1 = vec_at(b0), vec_at(b1)
        out.append((p, p + radius * v1, p + radius * v0))
    return out


def disk(p, normal, radius, n_sectors: int):
    """Triangle fan approximating a disk (shapes.fut:17-35).

    p, normal: (..., 3). Returns (..., n_sectors, 3, 3) triangles.
    """
    a = 2.0 * math.pi / n_sectors
    c = la.cross(normal, jnp.broadcast_to(la.WORLD_UP, normal.shape))
    c_norm = la.norm(c)
    degenerate = c_norm == 0.0
    safe = c / jnp.maximum(c_norm, 1e-30)[..., None]
    right = jnp.where(degenerate[..., None],
                      jnp.array([1.0, 0.0, 0.0], jnp.float32), safe)
    up = la.normalize(la.cross(right, normal))

    tris = []
    for i in range(n_sectors):
        b0, b1 = a * i, a * (i + 1)

        def angle_to_vec(b):
            v = la.rot_z(jnp.float32(b), jnp.array([1.0, 0.0, 0.0], jnp.float32))
            return la.scale(v[..., 0], right) + la.scale(v[..., 1], up)

        v0 = angle_to_vec(b0)
        v1 = angle_to_vec(b1)
        tri = jnp.stack([p, p + radius * v1, p + radius * v0], axis=-2)
        tris.append(tri)
    return jnp.stack(tris, axis=-3)
