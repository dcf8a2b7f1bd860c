"""Scene data model: struct-of-arrays pytrees.

The reference stores the scene as arrays-of-structs shared bit-for-bit between
host and OpenCL device (sphere.h:9-14, material.h:8-14, the live Light at
raytracer.h:20-25, uploaded at main.cpp:289-294).  For batched JAX code the
natural layout is struct-of-arrays: each field is one contiguous (N, ...)
array, so per-sphere math vectorizes over objects.  These pytrees are also the differentiable leaves for the
gradient-fit task (BASELINE.json).

Materials are folded into `Spheres` (one material per sphere, as in the
reference) rather than kept as a separate indexed table.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _dataclass(cls):
    cls = dataclasses.dataclass(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_dataclass
class Spheres:
    """SoA sphere list with per-sphere material.

    Reference: Sphere{pos,radius,material} sphere.h:9-14 and
    Material{matteColour,glossColour,opacity,refractiveIndex} material.h:8-14.
    """

    pos: jax.Array      # (N, 3)
    radius: jax.Array   # (N,)
    matte: jax.Array    # (N, 3) — already scaled by (1 - gloss_factor)
    gloss: jax.Array    # (N, 3) — already scaled by gloss_factor
    opacity: jax.Array  # (N,)
    ior: jax.Array      # (N,) refractive index

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@_dataclass
class Lights:
    """SoA point-light list. Reference: Light{pos,col} raytracer.h:20-25."""

    pos: jax.Array  # (L, 3)
    col: jax.Array  # (L, 3)

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@_dataclass
class Medium:
    """The material a ray is travelling through ("refractiveMat" in the
    reference, raytraceStack.h:20).  Only three of its fields are ever read:
    matteColour paints misses (raytracer.h:543-546), refractiveIndex feeds
    Snell's law (raytracer.h:712-714), and opacity scales the glossy
    reflection of the *hit* object (raytracer.h:572-574 — a reference quirk).

    NOTE: the reference never initialises the background medium's opacity
    (raytracer.h:694-697 and raytrace_kernel.cl's bgMaterial set only
    matte/gloss/ior) — it is read as uninitialised stack memory.  Here it is
    an explicit parameter; `default_scene` picks the value that matches the
    checked-in primary golden testPPM.ppm (tests/test_golden.py: 0.0).
    """

    matte: jax.Array    # (3,)
    ior: jax.Array      # ()
    opacity: jax.Array  # ()


@_dataclass
class Scene:
    spheres: Spheres
    lights: Lights
    bg: Medium  # background/ambient medium for rays outside every sphere


def make_material(gloss_factor, matte_col, gloss_col, opacity, ior):
    """Energy-conserving matte/gloss split, as setMatteGlossBalance
    (raytracer.h:62-71): matte = (1-g)*matte_col, gloss = g*gloss_col.

    Returns a dict of per-sphere material fields (scalars / length-3 arrays).
    """
    g = np.float32(gloss_factor)
    return dict(
        matte=(np.float32(1.0) - g) * np.asarray(matte_col, np.float32),
        gloss=g * np.asarray(gloss_col, np.float32),
        opacity=np.float32(opacity),
        ior=np.float32(ior),
    )


def build_scene(sphere_specs, light_specs, bg_matte=(0.0, 0.0, 0.0),
                bg_ior=1.0, bg_opacity=0.0) -> Scene:
    """Assemble a Scene pytree from per-object specs.

    sphere_specs: iterable of (pos(3,), radius, material-dict from make_material)
    light_specs: iterable of (pos(3,), col(3,))
    """
    poss, radii, mattes, glosses, opacities, iors = [], [], [], [], [], []
    for pos, radius, mat in sphere_specs:
        poss.append(np.asarray(pos, np.float32))
        radii.append(np.float32(radius))
        mattes.append(mat["matte"])
        glosses.append(mat["gloss"])
        opacities.append(mat["opacity"])
        iors.append(mat["ior"])
    lpos = [np.asarray(p, np.float32) for p, _ in light_specs]
    lcol = [np.asarray(c, np.float32) for _, c in light_specs]
    f32 = partial(jnp.asarray, dtype=jnp.float32)
    return Scene(
        spheres=Spheres(
            pos=f32(np.stack(poss)),
            radius=f32(np.stack(radii)),
            matte=f32(np.stack(mattes)),
            gloss=f32(np.stack(glosses)),
            opacity=f32(np.stack(opacities)),
            ior=f32(np.stack(iors)),
        ),
        lights=Lights(pos=f32(np.stack(lpos)), col=f32(np.stack(lcol))),
        bg=Medium(matte=f32(np.asarray(bg_matte)), ior=f32(bg_ior),
                  opacity=f32(bg_opacity)),
    )


def default_scene(bg_opacity: float = 0.0) -> Scene:
    """The reference's hard-coded golden scene (main.cpp:104-168).

    Three spheres, two half-white lights; colour constants main.cpp:114-123,
    materials main.cpp:126-145, spheres main.cpp:148-159, lights
    main.cpp:162-168.  The background medium is matte black with IOR 1.0
    (raytrace_kernel.cl:939-942); its opacity is undefined behaviour in the
    reference (see Medium docstring) — 0.0 (zeroed GPU private memory)
    together with the GPU's 5-slot stack reproduces the repo's primary
    golden testPPM.ppm at ~98% byte-exact (tests/test_golden.py).
    """
    green = (0.4, 0.5, 0.7)   # "greenCol", main.cpp:119-120
    red = (0.8, 1.0, 0.7)     # "redCol", main.cpp:117-118
    col1 = (0.01, 0.8, 0.01)  # main.cpp:122-123
    lower_white = (0.5, 0.5, 0.5)
    mat1 = make_material(0.2, green, red, opacity=0.8, ior=1.55)
    mat2 = make_material(0.95, green, red, opacity=0.3, ior=1.55)
    mat3 = make_material(0.0, col1, col1, opacity=0.6, ior=1.55)
    return build_scene(
        sphere_specs=[
            ((-9.0, 0.0, -13.0), 5.0, mat1),
            ((-4.0, 1.5, -5.0), 2.0, mat2),
            ((1.0, -1.0, -7.0), 3.0, mat3),
        ],
        light_specs=[
            ((-45.0, 10.0, 85.0), lower_white),
            ((20.0, 60.0, -5.0), lower_white),
        ],
        bg_opacity=bg_opacity,
    )


def single_sphere_scene() -> Scene:
    """BASELINE config 1: one opaque matte sphere, one light, depth 0."""
    mat = make_material(0.0, (0.9, 0.4, 0.2), (0.0, 0.0, 0.0), opacity=1.0, ior=1.0)
    return build_scene(
        sphere_specs=[((0.0, 0.0, -8.0), 3.0, mat)],
        light_specs=[((10.0, 10.0, 10.0), (1.0, 1.0, 1.0))],
    )


def random_scene(num_spheres: int, num_lights: int = 4, seed: int = 0,
                 spread: float = 40.0) -> Scene:
    """Procedural scene for the large benchmark configs (BASELINE config 5:
    256 spheres, 1920x1080, depth 6)."""
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(num_spheres):
        pos = rng.uniform(-spread, spread, 3).astype(np.float32)
        pos[2] = -abs(pos[2]) - 6.0  # keep in front of the camera
        mat = make_material(
            gloss_factor=rng.uniform(0.0, 0.95),
            matte_col=rng.uniform(0.05, 1.0, 3),
            gloss_col=rng.uniform(0.05, 1.0, 3),
            opacity=rng.uniform(0.2, 1.0),
            ior=rng.uniform(1.1, 2.0),
        )
        specs.append((pos, rng.uniform(0.5, 3.0), mat))
    lights = [
        (rng.uniform(-60.0, 60.0, 3).astype(np.float32), rng.uniform(0.2, 0.6, 3))
        for _ in range(num_lights)
    ]
    return build_scene(specs, lights)
