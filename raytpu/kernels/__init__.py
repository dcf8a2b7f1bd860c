"""Accelerated paths: the fused GPU forward kernel and the wavefront tracer."""

from raytpu.kernels.trace_pallas import render_image_pallas, render_pixels_pallas
from raytpu.kernels.wavefront import (
    render_image_wavefront,
    render_pixels_wavefront,
)

__all__ = [
    "render_image_pallas",
    "render_pixels_pallas",
    "render_image_wavefront",
    "render_pixels_wavefront",
]
