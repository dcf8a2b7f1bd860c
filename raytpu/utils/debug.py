"""Debug / sanitizer modes.

The reference has no sanitizers; its latent bugs (OOB dst write on rounded-up
launch sizes, NaN TIR) went undetected (SURVEY.md section 5.2).  JAX is
functional so data races cannot exist; the equivalents provided here:

  * checked_render — the jnp tracer under jax.experimental.checkify with
    float checks: returns (image, error); any NaN/Inf produced anywhere in
    the trace is reported with its source location instead of silently
    propagating into pixels.
  * interpret mode — the Pallas kernel accepts interpret=True and runs in
    the host interpreter (used throughout tests/test_pallas.py); that is the
    kernel-level sanitizer.
"""

from __future__ import annotations

import functools

import jax
from jax.experimental import checkify

from raytpu.config import RenderConfig
from raytpu.trace import render_image


@functools.partial(jax.jit, static_argnames=("cfg",))
def checked_render(scene, cfg: RenderConfig):
    """Render with float checkify instrumentation -> (error, image).

    Raise on failure with `error.throw()`; a clean render returns an empty
    error.  Roughly 2x slower than the plain path — debug use only.
    """
    fn = checkify.checkify(lambda s: render_image(s, cfg),
                           errors=checkify.float_checks)
    return fn(scene)
