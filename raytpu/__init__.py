"""raytpu — differentiable Whitted ray tracer in JAX.

A JAX / XLA / Pallas framework with the capabilities of the OpenCL/C++
reference renderer ``snowzurfer/raytracer-gamma`` (see SURVEY.md): camera ray
generation over a supersampled pixel grid, ray-sphere intersection, matte
shading with shadow rays and point lights, and Fresnel reflection/refraction
traced through a fixed-depth bounce loop — re-designed for accelerators
(batched math, masked lanes instead of branches, `shard_map` over a device
mesh instead of an NDRange launch) rather than ported.

Public surface:
    raytpu.scene        Scene / Spheres / Lights / Medium pytrees, builders
    raytpu.config       RenderConfig
    raytpu.trace        vectorized bounce-loop tracer + camera model (jnp)
    raytpu.oracle       strict reference-semantics oracle (numpy, for tests)
    raytpu.image        tone mapping + PPM I/O (golden-image contract)
    raytpu.render       jit/shard_map render drivers + timing
    raytpu.grad         loss/gradient helpers + finite-difference checker
    raytpu.kernels      the GPU forward kernel and the wavefront tracer
    raytpu.parallel     device mesh / sharding / distributed init
"""

from raytpu.config import RenderConfig
from raytpu.scene import Scene, Spheres, Lights, Medium, default_scene, make_material, random_scene
from raytpu.scene_io import load_scene, save_scene
from raytpu.trace import render_image, trace_rays, camera_rays
from raytpu.render import (DroppedRaysError, render_single, render_sharded,
                           render_timed)
from raytpu.grad import (fit_scene, image_loss, loss_and_grad,
                         loss_and_grad_sharded, loss_and_grad_wavefront)
from raytpu.image import tone_map, write_ppm, read_ppm, max_colour_value

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Scene", "Spheres", "Lights", "Medium",
    "default_scene", "make_material", "random_scene",
    "load_scene", "save_scene",
    "render_image", "trace_rays", "camera_rays",
    "render_single", "render_sharded", "render_timed", "DroppedRaysError",
    "fit_scene", "image_loss", "loss_and_grad", "loss_and_grad_sharded",
    "loss_and_grad_wavefront",
    "tone_map", "write_ppm", "read_ppm", "max_colour_value",
    "__version__",
]
