"""Scalar algebra: tolerance compares and the quadratic solver.

Reference: algebra.h — TOL=1e-3 (algebra.h:10), isZero (algebra.h:12-14),
solveQuadratic (algebra.h:22-65).  The C solver returns 0/1/2 roots through an
out-array; the branchless batched form returns a fixed-shape pair
(roots[..., 2], nroots[...]) where unused root slots are filled with the
valid root (nroots==1) or are unspecified (nroots==0).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

TOL = np.float32(1e-3)  # module constant: np, not jnp, so import stays backend-free


def is_zero(x):
    """|x| < 1e-3, as algebra.h:12-14."""
    return jnp.abs(x) < TOL


def _safe_div(num, den):
    """num/den with a guarded denominator; caller must mask out den==0 lanes.

    The double-where keeps reverse-mode gradients finite on masked lanes.
    """
    den_ok = jnp.where(den == 0, jnp.float32(1.0), den)
    return num / den_ok


def safe_sqrt(x):
    """sqrt(x) for x > 0, else 0 — with the double-where so reverse-mode AD
    sees a finite derivative on the clamped branch (sqrt'(0) is infinite, and
    inf * 0 from a mask is NaN without the inner where)."""
    pos = x > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, jnp.float32(1.0))),
                     jnp.float32(0.0))


def solve_quadratic(a, b, c):
    """Solve a*x^2 + b*x + c = 0 with the reference's exact branch structure
    (algebra.h:22-65), vectorized over any batch shape.

    Branches reproduced:
      * isZero(a) and isZero(b)      -> 0 roots
      * isZero(a), b significant     -> 1 root: -c/b          (linear fallback)
      * isZero(radicand)             -> 1 root: -b/(2a)       (double-root collapse,
                                        note: uses TOL=1e-3, not an exact test)
      * otherwise two roots — the C code takes sqrt(radicand) unconditionally,
        which is NaN for a negative radicand (reachable from
        calculateRefraction under total internal reflection,
        raytracer.h:735-739).  This jnp version clamps the radicand at zero
        instead (gradient-safe); callers mask TIR lanes explicitly, and the
        strict NaN semantics live in the numpy oracle only.  Root ordering
        matches the C code: roots[0] = (-b + sqrt(r))/(2a),
        roots[1] = (-b - sqrt(r))/(2a).

    Returns:
      roots: (..., 2) float32 (float64 for float64 inputs, the precision
      check of tools/card_witness.py); nroots: (...,) int32 in {0, 1, 2}.
    """
    dt = jnp.result_type(a, b, c, jnp.float32)
    a = jnp.asarray(a, dt)
    b = jnp.asarray(b, dt)
    c = jnp.asarray(c, dt)

    a_zero = is_zero(a)
    b_zero = is_zero(b)

    # Linear branch: x = -c/b (algebra.h:31-37)
    lin_root = _safe_div(-c, b)

    radicand = b * b - jnp.float32(4.0) * a * c
    rad_zero = is_zero(radicand)

    # Double root: -b / 2a (algebra.h:44-51)
    dbl_root = _safe_div(-b, jnp.float32(2.0) * a)

    root = safe_sqrt(radicand)
    denom = jnp.float32(2.0) * a
    r0 = _safe_div(-b + root, denom)
    r1 = _safe_div(-b - root, denom)

    nroots = jnp.where(
        a_zero,
        jnp.where(b_zero, 0, 1),
        jnp.where(rad_zero, 1, 2),
    ).astype(jnp.int32)

    root0 = jnp.where(a_zero, lin_root, jnp.where(rad_zero, dbl_root, r0))
    root1 = jnp.where(a_zero, lin_root, jnp.where(rad_zero, dbl_root, r1))
    roots = jnp.stack([root0, root1], axis=-1)
    return roots, nroots


def max_colour_value(img):
    """Global max over all channels, 0 -> 1 guard (algebra.h:68-91) — the
    on-device (jnp) form; raytpu.image has the host/numpy twin used by the
    PPM pipeline.  Keep their NaN/guard semantics in lockstep.

    NaN channels are skipped exactly as the C scan does (`x > max` is false
    for NaN).
    """
    m = jnp.max(jnp.where(jnp.isnan(img), -jnp.inf, img))
    m = jnp.maximum(m, jnp.float32(0.0))
    return jnp.where(m == 0, jnp.float32(1.0), m)
