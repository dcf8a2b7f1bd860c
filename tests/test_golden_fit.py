"""BASELINE config 4 against the REAL golden: recover perturbed scene
geometry by gradient descent against the checked-in testPPM.ppm (the
8-bit, max-normalized output of main.cpp:501, tone map main.cpp:66-80).

The fit goes through raytpu.grad.exposure_image_loss, which profiles the
tone map's unknown global exposure out in closed form; the test pins the
round-5 done-criterion: >= 10x loss reduction and the position error
shrinking back toward the scene that actually produced the golden.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.config import RenderConfig
from raytpu.grad import exposure_image_loss
from raytpu.scene import default_scene

_EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "examples", "fit_golden_scene.py")
_spec = importlib.util.spec_from_file_location("fit_golden_scene", _EX)
fit_golden_scene = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fit_golden_scene)


def test_fit_recovers_positions_against_real_golden(reference_renders):
    cfg = RenderConfig(alias_factor=1)          # 800x600 depth-5
    target = fit_golden_scene.golden_target()
    gid = jnp.arange(0, cfg.num_pixels, 117, dtype=jnp.int32)

    truth = default_scene()
    key = jax.random.PRNGKey(2)
    pert = 0.3 * jax.random.normal(key, truth.spheres.pos.shape)
    scene = dataclasses.replace(
        truth, spheres=dataclasses.replace(truth.spheres,
                                           pos=truth.spheres.pos + pert))
    err0 = float(jnp.abs(scene.spheres.pos - truth.spheres.pos).max())

    # The truth scene's loss is the model-mismatch floor (clean tracer +
    # alias-1 vs the GPU render + AA + quantization): the perturbation
    # must sit far above it for the fit to have signal.
    floor = float(exposure_image_loss(truth, cfg, target, gid))
    start = float(exposure_image_loss(scene, cfg, target, gid))
    assert start > 30 * floor

    trainable = jax.tree_util.tree_map(lambda _: False, truth)
    trainable = dataclasses.replace(
        trainable, spheres=dataclasses.replace(trainable.spheres, pos=True))
    fitted, losses = fit_golden_scene.fit_golden(
        scene, cfg, target, gid, steps=90, lr=5e-2, trainable=trainable)

    err1 = float(jnp.abs(fitted.spheres.pos - truth.spheres.pos).max())
    assert losses[-1] <= losses[0] / 10, (
        f"only {losses[0] / losses[-1]:.1f}x loss reduction")
    assert err1 <= 0.6 * err0, f"position error {err0:.3f} -> {err1:.3f}"
