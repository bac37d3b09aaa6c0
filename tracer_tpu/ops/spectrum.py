"""Piecewise-linear spectra as (..., 6, 2) arrays (replaces spectrum.fut).

A spectrum is up to six (wavelength, intensity) knots; unused knots carry
wavelength -1 as a sentinel (reference src/spectrum.fut:3-8, :81-87).
The reference's sequential knot scan (spectrum.fut:30-49) becomes a
branch-free vectorized min/max search that fuses into surrounding VPU work.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

RED_WAVELEN = 610.0
GREEN_WAVELEN = 550.0
BLUE_WAVELEN = 460.0

N_KNOTS = 6


def lookup_pairs(v, pairs):
    """Core lookup over an explicit knot list [(w_k, x_k), ...].

    A direct vectorization of the reference's sequential knot scan
    (spectrum.fut:30-49): the 6-iteration loop unrolls to ~50 fused
    elementwise ops per lane — no gathers, no argmax, and no reductions
    over a size-6 minor axis (the naive (N, 6, 2) formulation; its cost
    on the H100 is not measured).

    Initial bounds (-1, inf) with strict comparisons reproduce the
    sentinel semantics: knots at exactly -1 never match, ties keep the
    first knot in storage order.
    """
    v = jnp.asarray(v, jnp.float32)
    w_below = jnp.full_like(v, -1.0)
    x_below = jnp.zeros_like(v)
    w_above = jnp.full_like(v, jnp.inf)
    x_above = jnp.zeros_like(v)
    for wk, xk in pairs:
        wk = jnp.asarray(wk, jnp.float32)
        xk = jnp.asarray(xk, jnp.float32)
        cb = (wk > w_below) & (wk <= v)
        w_below = jnp.where(cb, wk, w_below)
        x_below = jnp.where(cb, xk, x_below)
        ca = (wk < w_above) & (wk > v)
        w_above = jnp.where(ca, wk, w_above)
        x_above = jnp.where(ca, xk, x_above)

    has_below = w_below >= 0.0
    has_above = jnp.isfinite(w_above)
    t = (v - w_below) / (w_above - w_below)
    interp = x_below + t * (x_above - x_below)
    return jnp.where(
        has_below & has_above, interp,
        jnp.where(has_below, x_below,
                  jnp.where(has_above, x_above, jnp.float32(0.0))))


def lookup(v, s):
    """Linearly interpolate spectrum s at wavelength(s) v.

    v: (...,) f32; s: broadcastable (..., 6, 2). Semantics match
    spectrum_lookup (spectrum.fut:30-49): nearest knot below (w <= v) and
    above (w > v); 0 if no knots qualify at all, clamp to the single
    neighbour at the ends, ties keep the first knot in storage order.
    """
    s = jnp.asarray(s, jnp.float32)
    pairs = [(s[..., k, 0], s[..., k, 1]) for k in range(s.shape[-2])]
    return lookup_pairs(v, pairs)


def uniform_spectrum(intensity: float) -> np.ndarray:
    """Constant spectrum (spectrum.fut:81-87)."""
    s = np.full((N_KNOTS, 2), [-1.0, 0.0], dtype=np.float32)
    s[0] = [0.0, intensity]
    return s


def map_intensities(f, s: np.ndarray) -> np.ndarray:
    s = np.array(s, dtype=np.float32)
    s[..., 1] = f(s[..., 1])
    return s


def blackbody(T: float) -> np.ndarray:
    """Planck's-law radiance sampled at 6 wavelengths (spectrum.fut:64-72)."""
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    ls_nm = np.array([150.0, BLUE_WAVELEN, GREEN_WAVELEN, RED_WAVELEN,
                      1000.0, 2000.0], dtype=np.float64)
    l = ls_nm * 1e-9
    planck = (2 * h * c * c) / (l ** 5 * (np.exp((h * c) / (l * kb * T)) - 1))
    return np.stack([ls_nm, planck], axis=-1).astype(np.float32)


def _lookup_np(v: float, s: np.ndarray) -> float:
    w, x = s[:, 0], s[:, 1]
    below = (w <= v) & (w > -1.0)
    above = w > v
    if below.any() and above.any():
        wb = w[below].max(); xb = x[below][np.argmax(w[below])]
        wa = w[above].min(); xa = x[above][np.argmin(w[above])]
        return float(xb + (v - wb) / (wa - wb) * (xa - xb))
    if below.any():
        return float(x[below][np.argmax(w[below])])
    if above.any():
        return float(x[above][np.argmin(w[above])])
    return 0.0


def blackbody_normalized(T: float) -> np.ndarray:
    """Blackbody scaled so the Wien-peak wavelength has intensity 1
    (spectrum.fut:74-79)."""
    radiance = blackbody(T)
    wiens_displacement = 2.8977721e-3
    lambda_max_nm = (wiens_displacement / T) * 1e9
    max_radiance = _lookup_np(lambda_max_nm, radiance)
    return map_intensities(lambda i: i / max_radiance, radiance)


def bright_blue_sky() -> np.ndarray:
    """spectrum.fut:89"""
    return map_intensities(lambda i: i * 5.0, blackbody_normalized(17000.0))


def no_sky() -> np.ndarray:
    """spectrum.fut:91"""
    return uniform_spectrum(0.0)
