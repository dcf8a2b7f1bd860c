"""Differentiable, branchless building blocks of the tracer (pure jnp).

Every op is written mask-first: per-lane control flow from the reference
(C `if`s in raytracer.h) becomes `jnp.where` over batched arrays, which is the
shape that vectorizes across rays and stays differentiable.
"""

from raytpu.ops.algebra import is_zero, solve_quadratic
from raytpu.ops.geometry import ray_sphere_t, closest_hit, primary_container, Hit
from raytpu.ops.shading import (
    polarised_reflection,
    reflect,
    refract,
    matte_light_sum,
    is_significant,
)

__all__ = [
    "is_zero", "solve_quadratic",
    "ray_sphere_t", "closest_hit", "primary_container", "Hit",
    "polarised_reflection", "reflect", "refract", "matte_light_sum",
    "is_significant",
]
