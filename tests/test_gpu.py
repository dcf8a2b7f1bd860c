"""Checks that only the card can make: the forward kernel compiled through
Triton (no interpreter) against the jnp tracer on the same card.  Marked
`gpu`; they skip without one (see conftest)."""

import jax
import numpy as np
import pytest

from raytpu.config import RenderConfig
from raytpu.kernels.trace_pallas import render_image_pallas
from raytpu.scene import default_scene, random_scene
from raytpu.trace import render_image

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("n_spheres,depth", [(3, 5), (64, 2)])
def test_compiled_kernel_matches_jnp_on_card(gpu, n_spheres, depth):
    scene = default_scene() if n_spheres == 3 else random_scene(n_spheres)
    cfg = RenderConfig(width=160, height=120, max_depth=depth,
                       alias_factor=1)
    with jax.default_device(gpu):
        k = np.asarray(render_image_pallas(scene, cfg))
        j = np.asarray(render_image(scene, cfg))
    assert np.isfinite(k).all()
    # The 64-sphere frame takes test_pallas's large-N tolerance.
    frac, mean = (0.01, 1e-3) if n_spheres == 3 else (0.05, 3e-3)
    scale = max(float(np.abs(j).max()), 1e-12)
    d = np.abs(k - j)
    assert (d.max(axis=-1) > 1e-2 * scale).mean() <= frac
    assert d.mean() < mean * scale
