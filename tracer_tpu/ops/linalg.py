"""Vector math on batched arrays (replacement for linalg.fut).

The reference uses per-value vec3 records (reference src/linalg.fut:4-8).
Under XLA the idiomatic layout is batched arrays with a trailing component
axis of size 3, so every helper here maps over arbitrary leading batch
dimensions and lowers to plain element-wise ops under XLA fusion.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

WORLD_UP = jnp.array([0.0, 1.0, 0.0], dtype=jnp.float32)  # linalg.fut:47
INV_PI = 1.0 / math.pi
ERROR_VEC = jnp.array([1000.0, 0.0, 1000.0], dtype=jnp.float32)  # linalg.fut:33
# (3, 1) transposed world-up, broadcast-ready against (3, N)
V3_UP = jnp.array([[0.0], [1.0], [0.0]], dtype=jnp.float32)


def vec3(x, y, z):
    """Build a (..., 3) vector by stacking components along a new last axis."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(z, jnp.float32)), axis=-1)


def vec3_repeat(x):
    return vec3(x, x, x)


def dot(a, b):
    """Batched dot product over the trailing component axis."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def quadrance(a):
    return dot(a, a)


def norm(a):
    return jnp.sqrt(quadrance(a))


def normalize(a, eps: float = 0.0):
    """Unit vector. With eps=0 this matches the reference exactly (0/0 -> nan
    for degenerate inputs, which callers mask out)."""
    n = norm(a)
    if eps:
        n = jnp.maximum(n, eps)
    return a / n[..., None]


def scale(s, a):
    """Scalar (...,) times vector (..., 3)."""
    return jnp.asarray(s, jnp.float32)[..., None] * a


def lerp(a, b, r):
    """f32.lerp semantics: a + r*(b-a) (reference linalg.fut:26 for vec3)."""
    return a + r * (b - a)


def vec3_lerp(a, b, r):
    return a + jnp.asarray(r, jnp.float32)[..., None] * (b - a)


def same_side(dominant, w):
    """Flip w to face the same side as dominant (linalg.fut:30-31).

    Uses sign(dot); note sign(0) = 0 zeroes the vector, matching f32.sgn.
    """
    return scale(jnp.sign(dot(dominant, w)), w)


def vmin(a, b):
    return jnp.minimum(a, b)


def vmax(a, b):
    return jnp.maximum(a, b)


def rot_z(angle, v):
    """Rotate (..., 3) vectors around the z axis (vector pkg rot_z)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return vec3(c * x - s * y, s * x + c * y, z)


# ---------------------------------------------------------------------------
# Transposed vectors: V3 = array with the COMPONENT axis first, (3, ...).
#
# This is the hot-path convention. With lanes (N,) on the minor axis,
# component slices v[0] are free major-axis slices, (N,) scalars broadcast
# against (3, N) vectors with no relayout, and transposed table fetches
# (ops/tables.py, (K, N)) yield vectors directly as row blocks. The
# (..., 3) helpers above remain for host-side / build-time code.

def v3(x, y, z):
    """Stack components (each (...,)) into a (3, ...) vector."""
    x, y, z = jnp.broadcast_arrays(jnp.asarray(x, jnp.float32),
                                   jnp.asarray(y, jnp.float32),
                                   jnp.asarray(z, jnp.float32))
    return jnp.stack([x, y, z], axis=0)


def v3_const(x, y, z):
    """A constant vector as (3, 1): broadcasts against (3, N) lanes.

    NOTE a bare (3,) array would silently mis-broadcast against (3, N)
    (numpy aligns trailing axes) — always keep one batch axis.
    """
    return jnp.asarray([[x], [y], [z]], jnp.float32)




def v3_dot(a, b):
    p = a * b
    return p[0] + p[1] + p[2]


def v3_cross(a, b):
    return jnp.stack([a[1] * b[2] - a[2] * b[1],
                      a[2] * b[0] - a[0] * b[2],
                      a[0] * b[1] - a[1] * b[0]], axis=0)


def v3_quadrance(a):
    return v3_dot(a, a)


def v3_norm(a):
    return jnp.sqrt(v3_quadrance(a))


def v3_normalize(a, eps: float = 0.0):
    q = v3_quadrance(a)
    if eps:
        q = jnp.maximum(q, eps * eps)
    return a * jax.lax.rsqrt(q)


def v3_same_side(dominant, w):
    return jnp.sign(v3_dot(dominant, w)) * w


def v3_from_array(arr):
    """(..., 3) -> (3, ...)."""
    return jnp.moveaxis(jnp.asarray(arr, jnp.float32), -1, 0)


def v3_to_array(v):
    """(3, ...) -> (..., 3)."""
    return jnp.moveaxis(v, 0, -1)


def to_rad(deg: float) -> float:
    return deg * math.pi / 180.0


def to_deg(rad: float) -> float:
    return rad * 180.0 / math.pi


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)
