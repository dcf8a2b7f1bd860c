"""Multi-frame rendering demo: orbit a sphere and write one PPM per frame.

Shows the intended MULTI-FRAME pattern for the wavefront backend: frame 0
runs the knob-free auto-capacity ladder (tuned frontier first, escalate +
re-render on any drop) and returns the RESOLVED tuning in
`info['wf_opts']`; later frames pass that tuning back, so a scene whose
frontier sits above the first rung pays the ladder's dropped attempts
exactly once.  If the moving geometry ever outgrows the pinned capacity,
the drop counter fires (`on_drop="warn"` here) and the demo re-arms the
ladder — the counter is the contract, never silent loss.

Run (CPU): python examples/animate.py --frames 8 --cpu
Run (GPU): python examples/animate.py --frames 24 --width 1920 \
               --height 1080 --depth 6 --spheres 256
"""

import argparse
import dataclasses
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def orbit(scene, angle: float, radius: float = 6.0):
    """Move sphere 0 on a circle in the x/z plane around its start."""
    pos = np.asarray(scene.spheres.pos)
    new = pos.copy()
    new[0, 0] = pos[0, 0] + radius * (math.cos(angle) - 1.0)
    new[0, 2] = pos[0, 2] + radius * math.sin(angle)
    return dataclasses.replace(
        scene, spheres=dataclasses.replace(scene.spheres,
                                           pos=jnp.asarray(new)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--spheres", type=int, default=0,
                    help="random scene with N spheres (default: golden)")
    ap.add_argument("--backend", default="wavefront",
                    choices=["auto", "jnp", "pallas", "wavefront"])
    ap.add_argument("--outdir", default="frames")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from raytpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from raytpu.config import RenderConfig
    from raytpu.image import write_ppm
    from raytpu.render import render_single
    from raytpu.scene import default_scene, random_scene

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, alias_factor=1)
    base = (random_scene(args.spheres) if args.spheres else default_scene())
    os.makedirs(args.outdir, exist_ok=True)

    pinned = None                  # resolved wavefront tuning, frame 0's
    for f in range(args.frames):
        scene = orbit(base, 2 * math.pi * f / max(args.frames, 1))
        img, info = render_single(scene, cfg, backend=args.backend,
                                  wf_opts=pinned, return_info=True,
                                  on_drop="warn")
        if info.get("wf_opts") is not None:
            if pinned is not None and info["dropped"] > 0:
                # Geometry outgrew the pinned capacity: re-arm the ladder
                # (drop the pin) so the next frame re-resolves cleanly.
                pinned = None
            else:
                pinned = info["wf_opts"]
        path = os.path.join(args.outdir, f"frame_{f:04d}.ppm")
        write_ppm(np.asarray(img), path)
        print(f"{path}: dropped={info['dropped']}"
              + (f" wf_opts={info.get('wf_opts')}" if f == 0 else ""))


if __name__ == "__main__":
    main()
