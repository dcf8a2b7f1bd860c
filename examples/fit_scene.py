"""Gradient-fit demo (BASELINE config 4): recover perturbed scene parameters
by gradient descent against a rendered target image.

Run (CPU): python examples/fit_scene.py --steps 60
Run (GPU): python examples/fit_scene.py --steps 200 --width 160 --height 120
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=80)
    ap.add_argument("--height", type=int, default=60)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--mode", choices=["colours", "geometry"],
                    default="colours",
                    help="colours: perturb/fit matte + light colours (smooth "
                         "gradients, converges to ~0); geometry: also "
                         "positions/radii (silhouette sub-gradients, partial)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the fit over the first N devices "
                         "(scene replicated, pixel grid sharded, scene "
                         "cotangents psum'd)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "jnp", "wavefront"],
                    help="gradient backend: the differentiable wavefront "
                         "(large scenes) or the jnp autodiff tracer")
    ap.add_argument("--checkpoint", default=None,
                    help="path to save/restore fit state every 10 steps")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from raytpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from raytpu.config import RenderConfig
    from raytpu.grad import fit_scene, image_loss
    from raytpu.scene import default_scene
    from raytpu.trace import render_pixels
    from raytpu.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, alias_factor=1)
    truth = default_scene()
    gid = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    target = render_pixels(truth, cfg, gid)

    # Perturb parameters, then fit them back.
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    sph = truth.spheres
    sph = dataclasses.replace(
        sph,
        matte=jnp.clip(sph.matte + 0.15 * jax.random.normal(k3, sph.matte.shape),
                       0.0, 1.0))
    lights = dataclasses.replace(
        truth.lights,
        col=jnp.clip(truth.lights.col
                     + 0.2 * jax.random.normal(k4, truth.lights.col.shape),
                     0.05, 2.0))
    if args.mode == "geometry":
        sph = dataclasses.replace(
            sph,
            pos=sph.pos + 0.3 * jax.random.normal(k1, sph.pos.shape),
            radius=sph.radius * (1 + 0.1 * jax.random.normal(k2, sph.radius.shape)))
    scene = dataclasses.replace(truth, spheres=sph, lights=lights)

    if args.checkpoint and os.path.exists(args.checkpoint):
        scene = load_checkpoint(args.checkpoint, scene)
        print(f"restored {args.checkpoint}")

    # Only fit what was perturbed.
    trainable = jax.tree_util.tree_map(lambda _: False, truth)
    trainable = dataclasses.replace(
        trainable,
        spheres=dataclasses.replace(trainable.spheres, matte=True,
                                    pos=args.mode == "geometry",
                                    radius=args.mode == "geometry"),
        lights=dataclasses.replace(trainable.lights, col=True))

    start = float(image_loss(scene, cfg, target))

    def cb(step, loss, s):
        if step % 10 == 0:
            print(f"step {step:4d}: loss {loss:.3e}")
            if args.checkpoint:
                save_checkpoint(args.checkpoint, s)

    # The linear image is ~1e-4 scale (inverse-square lights), so MSE
    # gradients are ~1e-12 — far below adam's default eps=1e-8.  A
    # scale-appropriate eps restores adam's scale invariance.
    import optax
    opt = optax.adam(args.lr, eps=1e-16)
    mesh = None
    if args.mesh:
        from raytpu.parallel.mesh import make_mesh
        devices = jax.devices()
        if len(devices) < args.mesh:
            raise SystemExit(
                f"--mesh {args.mesh} requested but only {len(devices)} "
                f"device(s) available")
        mesh = make_mesh(devices[:args.mesh])
    fitted, losses = fit_scene(scene, cfg, target, steps=args.steps,
                               learning_rate=args.lr, callback=cb,
                               trainable=trainable, optimizer=opt,
                               mesh=mesh, backend=args.backend)
    print(f"loss: {start:.3e} -> {losses[-1]:.3e} "
          f"({start / max(losses[-1], 1e-30):.1f}x reduction)")
    err = np.abs(np.asarray(fitted.spheres.pos) - np.asarray(truth.spheres.pos))
    print(f"sphere position error: max {err.max():.4f}")


if __name__ == "__main__":
    main()
