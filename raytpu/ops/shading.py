"""Shading: Lambert matte with shadow rays, Fresnel, reflect, refract.

Reference semantics reproduced (batched, masked):
  * isSignificant        raytracer.h:235-241
  * hasClearLineOfSight  raytracer.h:272-309
  * calculateMatte       raytracer.h:313-367
  * polarisedReflection  raytracer.h:370-403
  * calculateRefraction  raytracer.h:642-815
  * calculateReflection  raytracer.h:817-842

One deliberate divergence (clean mode): under total internal reflection the
reference falls through its TIR branch (raytracer.h:721-730 sets the factor
to 1 but keeps going) into sqrt(1 - sinA2^2) with sinA2^2 > 1, producing NaN
that silently kills both child rays downstream via isSignificant(NaN)=false.
Here TIR lanes get reflection_factor=1 and a zero-intensity refracted ray —
physically correct total reflection, NaN-free, differentiable.  The strict
NaN behaviour is reproduced only by the numpy oracle (raytpu.oracle) used for
golden-image tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.ops.algebra import safe_sqrt, solve_quadratic
from raytpu.ops.geometry import (
    K_MAX_RENDER_DIST,
    dot3,
    normalize,
    primary_container,
    ray_sphere_t,
)

K_MIN_INTENSITY = np.float32(1e-3)   # kMinOpticalIntesity, raytracer.h:236
K_SMALL_SHIFT = np.float32(0.01)     # raytracer.h:688, :831
K_FRESNEL_EPS = np.float32(1e-6)     # raytracer.h:376


def is_significant(colour):
    """Any channel >= 0.001 (raytracer.h:235-241)."""
    return jnp.any(colour >= K_MIN_INTENSITY, axis=-1)


def polarised_reflection(n1, n2, cos_a1, cos_a2):
    """Fresnel coefficient ((n1 c1 - n2 c2)/(n1 c1 + n2 c2))^2, capped at 1,
    with denominator ~ 0 meaning full reflection (raytracer.h:370-403).

    The CPU reference widens the numerator/denominator to double
    (raytracer.h:380-384) while the GPU kernel stays in float — the two
    goldens already diverge there, so float32 is within the contract.
    """
    left = n1 * cos_a1
    right = n2 * cos_a2
    num = left - right
    den = left + right
    den2 = den * den
    den2_safe = jnp.where(den2 < K_FRESNEL_EPS, jnp.float32(1.0), den2)
    refl = jnp.minimum(num * num / den2_safe, jnp.float32(1.0))
    return jnp.where(den2 < K_FRESNEL_EPS, jnp.float32(1.0), refl)


def matte_light_sum(point, normal, spheres, lights):
    """Sum over lights of (incidence / dist^2) * light.col for unshadowed
    lights (calculateMatte, raytracer.h:313-367).

    The line-of-sight test (raytracer.h:272-309) asks whether the closest hit
    along point->light sits nearer than the light: with a unit shadow-ray
    direction that is exactly "exists a sphere with a root t in (1e-5, 1000)
    and t^2 < |light-point|^2", so no argmin is needed.

    Args:
      point, normal: (..., 3) hit positions / unit normals.
    Returns:
      (..., 3) colour sum (zero where shadowed or back-facing).
    """
    dist = lights.pos - point[..., None, :]        # (..., L, 3)
    gap = dot3(dist, dist)                         # (..., L)  distMagSquared
    ldir = normalize(dist)                         # unit, as the C shadow ray

    # Shadow test against every sphere: (..., L, N).  Visibility is a step
    # function (zero gradient almost everywhere), so it runs on
    # stop-gradient inputs and autodiff keeps no (..., L, N) residuals.
    sg = jax.lax.stop_gradient
    t, found = ray_sphere_t(sg(point)[..., None, :], sg(ldir),
                            sg(spheres.pos), sg(spheres.radius))
    blocking = found & (t < K_MAX_RENDER_DIST) & (t * t < sg(gap)[..., None])
    clear = ~jnp.any(blocking, axis=-1)            # (..., L)

    incidence = dot3(normal[..., None, :], ldir)   # (..., L)
    weight = jnp.where(clear & (incidence > 0), incidence / gap, jnp.float32(0.0))
    return jnp.sum(weight[..., None] * lights.col, axis=-2)


def reflect(direction, normal, point):
    """Mirror bounce (calculateReflection, raytracer.h:817-842): reflected
    direction normalized, origin shifted 0.01 along it."""
    perp = jnp.float32(2.0) * dot3(direction, normal)
    refl_dir = normalize(direction - perp[..., None] * normal)
    origin = point + K_SMALL_SHIFT * refl_dir
    return origin, refl_dir


def refract(point, normal, direction, medium_ior, spheres, bg):
    """Snell refraction via the reference's quadratic-solve formulation
    (calculateRefraction, raytracer.h:642-815), batched and NaN-free.

    Steps, with their reference lines:
      * cosA1 = dir.normal clamped to [-1, 1]; sinA1 from the trig identity
        (:659-684).  `direction` is used raw — refracted parents are
        unnormalized in the reference, so cosA1 can hit the clamps.
      * Probe point + 0.01*dir locates the *target* medium via
        primaryContainer; outside every sphere it is the scene background
        (:687-708).  Note the refracted ray's own origin is NOT shifted
        (:811-812 is commented out in the reference).
      * sinA2 = (n1/n2) sinA1; |sinA2| >= 1 is total internal reflection
        (:712-730) — handled cleanly here (factor 1, dead refracted ray).
      * Direction = dir + k*normal where k solves
        k^2 + 2 cosA1 k + (1 - 1/ratio^2) = 0, picking the root whose
        resulting direction best aligns with the incident one; alignment must
        beat the -0.1 floor or the direction collapses to zero (:734-771).
        The result is left unnormalized, exactly like the reference.
      * cosA2 = sqrt(1 - sinA2^2) with cosA1's sign (:776-781); Fresnel
        factor = (Rs + Rp)/2 (:786-798).

    Returns:
      (refr_origin, refr_dir, reflection_factor, target_idx) where
      target_idx is the containing sphere's index or -1 for background.
      The caller scales intensity by (1 - reflection_factor) (:807) and
      gathers the target medium from target_idx.
    """
    one = jnp.float32(1.0)
    cos_a1 = jnp.clip(dot3(direction, normal), -one, one)
    sin_a1 = safe_sqrt(one - cos_a1 * cos_a1)

    probe = point + K_SMALL_SHIFT * direction
    target_idx = primary_container(probe, spheres)
    safe_idx = jnp.maximum(target_idx, 0)
    in_sphere = target_idx >= 0
    target_ior = jnp.where(in_sphere, spheres.ior[safe_idx], bg.ior)

    ratio_den = jnp.where(target_ior == 0, one, target_ior)
    ratio = medium_ior / ratio_den
    sin_a2 = ratio * sin_a1
    tir = (sin_a2 <= -one) | (sin_a2 >= one)

    ratio2 = ratio * ratio
    ratio2 = jnp.where(ratio2 == 0, one, ratio2)
    roots, nroots = solve_quadratic(
        jnp.ones_like(cos_a1), jnp.float32(2.0) * cos_a1, one - one / ratio2)

    # Root selection: strict '>' against a running max initialised to -0.1
    # (raytracer.h:750-771), so root 1 only replaces root 0 on a strictly
    # larger alignment, and if neither beats -0.1 the direction is zero.
    cand0 = direction + roots[..., 0:1] * normal
    cand1 = direction + roots[..., 1:2] * normal
    align0 = jnp.where(nroots >= 1, dot3(direction, cand0), -jnp.inf)
    align1 = jnp.where(nroots >= 2, dot3(direction, cand1), -jnp.inf)
    floor = jnp.float32(-0.1)
    take0 = align0 > floor
    take1 = align1 > jnp.maximum(align0, floor)
    refr_dir = jnp.where(
        take1[..., None], cand1,
        jnp.where(take0[..., None], cand0, jnp.zeros_like(direction)))

    cos_a2 = safe_sqrt(one - sin_a2 * sin_a2)
    cos_a2 = jnp.where(cos_a1 < 0, -cos_a2, cos_a2)

    rs = polarised_reflection(medium_ior, target_ior, cos_a1, cos_a2)
    rp = polarised_reflection(medium_ior, target_ior, cos_a2, cos_a1)
    reflection_factor = jnp.float32(0.5) * (rs + rp)
    reflection_factor = jnp.where(tir, one, reflection_factor)

    return point, refr_dir, reflection_factor, target_idx
