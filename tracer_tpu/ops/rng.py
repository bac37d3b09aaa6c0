"""Counter-based per-lane RNG (replacement for rand.fut).

The reference threads a stateful minstd_rand LCG through every sampling
routine and splits one stream per pixel each frame (reference
src/rand.fut:5-8, src/integrator.fut:109).  A stateful splittable RNG is a
poor fit for SPMD array code, so we use the standard GPU-path-tracer design
instead: each lane (pixel/path) carries a 32-bit PCG state initialized by
hashing (seed, frame counter, lane id).  Streams are independent across
lanes and across frames, and advancing is ~5 integer ops per draw.

Contract preserved from the reference: per-pixel independent streams plus
a per-frame advance — not bitwise LCG equality (SURVEY.md section 7.1).
The unit interval is [0, 0.9999) to match random_unit_exclusive
(reference src/rand.fut:15-16).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

_MULT = jnp.uint32(747796405)
_INC = jnp.uint32(2891336453)

# Matches the reference's [0, 0.9999) unit interval (rand.fut:15-16).
UNIT_SCALE = 0.9999


def _pcg_permute(state):
    """RXS-M-XS output permutation (Jarzynski & Olano, GPU hash survey)."""
    word = ((state >> ((state >> jnp.uint32(28)) + jnp.uint32(4))) ^ state) \
        * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def hash_u32(x):
    """One full PCG step as a stateless hash u32 -> u32."""
    x = jnp.asarray(x, jnp.uint32)
    return _pcg_permute(x * _MULT + _INC)


def make_streams(seed, frame, lane_ids):
    """Initialize independent per-lane states.

    seed, frame: scalars (python int or traced); lane_ids: uint32 array.
    """
    seed = jnp.asarray(seed, jnp.uint32)
    frame = jnp.asarray(frame, jnp.uint32)
    base = hash_u32(seed ^ hash_u32(frame))
    return hash_u32(jnp.asarray(lane_ids, jnp.uint32) ^ base)


def next_u32(state):
    """Advance each lane one step; return (new_state, uniform u32)."""
    state = state * _MULT + _INC
    return state, _pcg_permute(state)


def next_unit(state):
    """Uniform f32 in [0, UNIT_SCALE) per lane — random_unit_exclusive."""
    state, bits = next_u32(state)
    u = (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        UNIT_SCALE / (1 << 24))
    return state, u


def next_uniform(state, lo=0.0, hi=1.0):
    """Uniform f32 in [lo, hi) per lane (dist.rand analogue)."""
    state, bits = next_u32(state)
    u = (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
    return state, lo + u * (hi - lo)


def in_unit_disk_xy(state):
    """Uniform point in the unit disk as two (...,) components
    (rand.fut:21-25)."""
    state, theta = next_uniform(state, 0.0, 2.0 * math.pi)
    state, u = next_unit(state)
    r = jnp.sqrt(u)
    return state, (r * jnp.cos(theta), r * jnp.sin(theta))


def in_unit_disk(state):
    """Uniform point in the unit disk as (..., 3) with z=0 (rand.fut:21-25)."""
    state, (x, y) = in_unit_disk_xy(state)
    return state, jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)


def in_unit_square(state):
    """Pair of unit uniforms (rand.fut:28-31)."""
    state, x = next_unit(state)
    state, y = next_unit(state)
    return state, (x, y)


def in_triangle(state):
    """Uniform barycentric sample (PBR Book 13.6.5; rand.fut:34-37)."""
    state, (u, v) = in_unit_square(state)
    su = jnp.sqrt(u)
    return state, (1.0 - su, v * su)


def select(state, n):
    """Uniform index in [0, n) via u32 modulo, like random_select'
    (rand.fut:39-46). n may be a traced int32 (>=1)."""
    state, bits = next_u32(state)
    idx = (bits % jnp.asarray(n, jnp.uint32)).astype(jnp.int32)
    return state, idx


# --- salted out-of-band draws -------------------------------------------
#
# The sequential chain (one LCG step + one RXS-M-XS round per draw) has
# measurable correlation between an output and the outputs that follow
# it on the same lane. For most draws that is harmless, but a draw that
# CONDITIONS the estimator — the hero-wavelength channel select, which
# partitions all downstream path energy by channel — turns that
# correlation into a channel-conditioned bias: conditioned on the
# channel value, the path draws that follow are slightly non-uniform.
# Measured on MirrorBox 32x32x256spp vs the independent numpy oracle
# (verify/lockstep.py, round-4 bisection): green-channel energy biased
# +1.8..+5.5% across seeds (all positive) with the chained channel
# draw; swapping ONLY the channel/wavelength draws to an independent
# source (all other draws bit-identical) collapsed the worst seed from
# +5.22% to +0.19%. Salted double-round hashes of the pre-advance state
# reproduce that collapse (+0.20%) with no out-of-band randomness.
#
# Contract: `salted_*` draws are pure functions of (state, salt) — they
# do NOT advance the chain; callers advance the main stream separately
# to keep every other draw's position unchanged.

_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(key0, key1, x0, x1):
    """Standard Threefry-2x32 (20 rounds; Salmon et al. 2011, the same
    core as jax.random's default PRNG) over uint32 lanes. Cheap simple
    mixers (1-4 rounds of LCG+RXS-M-XS, murmur3 finalizers) all left
    measurable residual correlation with the sequential chain on the
    score-labels comparator; 20-round threefry is independent to
    cryptographic strength. ~40 integer VPU ops — used once per camera
    sample, not per draw."""
    k0 = jnp.uint32(key0)
    k1 = jnp.uint32(key1)
    k2 = k0 ^ k1 ^ jnp.uint32(_THREEFRY_PARITY)
    ks = (k0, k1, k2)
    x0 = jnp.asarray(x0, jnp.uint32) + k0
    x1 = jnp.asarray(x1, jnp.uint32) + k1
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def salted_pair(state, salt):
    """Two u32 draws decorrelated from the sequential chain: one
    threefry2x32 block keyed by the salt over the pre-advance state.
    Pure function of (state, salt) — does NOT advance the chain; the
    caller advances the main stream separately so every other draw
    keeps its position."""
    return threefry2x32(salt, 0x9E3779B9,
                        jnp.asarray(state, jnp.uint32), 0x85EBCA6B)
