"""Ray-sphere geometry: intersection, closest hit, containment.

Reference semantics reproduced exactly (in masked/batched form):
  * raySphere        raytracer.h:81-141   (quadratic hit test, eps=1e-5,
                                           smallestT init 10000)
  * calcIntersection raytracer.h:145-194  (closest hit over spheres,
                                           kMaxRenderDist=1000, strict '<'
                                           so the lowest index wins ties)
  * primaryContainer raytracer.h:245-270  (first sphere containing a point,
                                           radius inflated by 1e-6, else -1)

All ops are batched over an arbitrary leading ray shape (..., 3) against all
N spheres at once — the per-sphere C loop becomes one (..., N) tensor op
that XLA fuses into a per-ray reduction over spheres.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.ops.algebra import safe_sqrt

K_RAY_EPS = np.float32(1e-5)        # raytracer.h:86
K_SMALLEST_T_INIT = np.float32(1e4)  # raytracer.h:119
K_MAX_RENDER_DIST = np.float32(1e3)  # raytracer.h:156
K_CONTAIN_EPS = np.float32(1e-6)     # raytracer.h:252


def dot3(a, b):
    return jnp.sum(a * b, axis=-1)


def normalize(v):
    """vnorm (vec.h:41): v / |v|.  The C macro divides by zero for a null
    vector; callers here mask such lanes, and the guarded denominator keeps
    both values and gradients finite on them."""
    n2 = dot3(v, v)
    n2 = jnp.where(n2 == 0, jnp.float32(1.0), n2)
    return v * jax.lax.rsqrt(n2)[..., None]


def ray_sphere_t(origin, direction, centers, radii):
    """Batched raySphere (raytracer.h:81-141).

    Args:
      origin, direction: (..., 3) ray bundles (direction need not be unit —
        refracted rays in the reference are unnormalized).
      centers: (N, 3); radii: (N,).

    Returns:
      t:     (..., N) smallest root > 1e-5 for each (ray, sphere) pair, or
             10000 where there is none (the reference's smallestT init).
      found: (..., N) bool — radicand >= 0 and some root in (1e-5, 10000).
    """
    # Quadratic coefficients: a = d.d, b = 2 d.(o-c), c = |o-c|^2 - r^2
    # (raytracer.h:95-100).  Kept in the reference's operation order as
    # explicit elementwise f32 math: an einsum formulation could run on the
    # matrix units at reduced (bf16/TF32) precision and wreck the root
    # cancellation.
    disp = origin[..., None, :] - centers                          # (..., N, 3)
    a = dot3(direction, direction)[..., None]                      # (..., 1)
    b = jnp.float32(2.0) * dot3(direction[..., None, :], disp)     # (..., N)
    c = dot3(disp, disp) - radii * radii

    radicand = b * b - jnp.float32(4.0) * a * c
    has_real = radicand >= 0

    root = safe_sqrt(radicand)
    denom = jnp.float32(2.0) * a
    denom = jnp.where(denom == 0, jnp.float32(1.0), denom)  # a==0 => b==0, both roots 0 => invalid
    u0 = (-b + root) / denom
    u1 = (-b - root) / denom

    # Keep roots > eps, take the smaller; else the 10000 sentinel
    # (raytracer.h:119-137).
    big = K_SMALLEST_T_INIT
    t0 = jnp.where(has_real & (u0 > K_RAY_EPS), u0, big)
    t1 = jnp.where(has_real & (u1 > K_RAY_EPS), u1, big)
    t = jnp.minimum(t0, t1)
    found = t < big
    return t, found


@jax.custom_jvp
def _value_with_grad_of(value, carrier):
    """Returns `value`; differentiates as `carrier` (same shape)."""
    del carrier
    return value


@_value_with_grad_of.defjvp
def _value_with_grad_of_jvp(primals, tangents):
    return primals[0], tangents[1]


@dataclasses.dataclass
class Hit:
    """Result of a closest-hit query (cf. Intersection, intersection.h:7-18 —
    but carrying the hit sphere's *index* instead of a struct copy)."""

    found: jax.Array    # (...,) bool
    t: jax.Array        # (...,)
    point: jax.Array    # (..., 3)
    normal: jax.Array   # (..., 3) unit, outward
    sq_dist: jax.Array  # (...,) |t*d|^2 (raytracer.h:180-181)
    index: jax.Array    # (...,) int32, undefined where ~found


Hit = jax.tree_util.register_dataclass(
    Hit, data_fields=["found", "t", "point", "normal", "sq_dist", "index"],
    meta_fields=[])


def closest_hit(origin, direction, spheres) -> Hit:
    """Batched calcIntersection (raytracer.h:145-194).

    A sphere wins if its t is strictly below the running minimum initialised
    to kMaxRenderDist=1000 — i.e. t must be < 1000, and on exact ties the
    lowest sphere index wins (argmin returns the first minimum).

    The selection is a step function of the scene, so it runs on
    stop-gradient inputs.  The gradient of t is carried by the winner's t
    recomputed from its own centre and radius (`_value_with_grad_of`), so
    the value stays the selected one bit for bit and reverse-mode AD keeps
    O(rays) residuals per level instead of O(rays x spheres).
    """
    sg = jax.lax.stop_gradient
    t_all, found_all = ray_sphere_t(sg(origin), sg(direction),
                                    sg(spheres.pos), sg(spheres.radius))
    valid = found_all & (t_all < K_MAX_RENDER_DIST)
    t_masked = jnp.where(valid, t_all, K_SMALLEST_T_INIT)
    index = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
    found = jnp.any(valid, axis=-1)
    t = jnp.take_along_axis(t_masked, index[..., None], axis=-1)[..., 0]
    center = spheres.pos[index]                      # (..., 3) gather
    t_w, _ = ray_sphere_t(origin, direction, center[..., None, :],
                          spheres.radius[index][..., None])
    t = _value_with_grad_of(t, t_w[..., 0])
    t = jnp.where(found, t, K_MAX_RENDER_DIST)

    point = origin + t[..., None] * direction
    normal = normalize(point - center)
    sq_dist = t * t * dot3(direction, direction)
    return Hit(found=found, t=t, point=point, normal=normal,
               sq_dist=sq_dist, index=index)


def primary_container(point, spheres):
    """Batched primaryContainer (raytracer.h:245-270): index of the first
    sphere whose (radius + 1e-6)-ball contains the point, else -1."""
    diff = point[..., None, :] - spheres.pos         # (..., N, 3)
    d2 = jnp.sum(diff * diff, axis=-1)               # (..., N)
    r = spheres.radius + K_CONTAIN_EPS
    inside = d2 <= r * r
    first = jnp.argmax(inside, axis=-1).astype(jnp.int32)
    return jnp.where(jnp.any(inside, axis=-1), first, jnp.int32(-1))
